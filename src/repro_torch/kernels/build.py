"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its
own by ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root, then loaded with
:mod:`ctypes`.  The first call builds every source at once (one ``nvcc``
process per file, all started together); a library whose name already
carries the hash of its source and flags is reused.  Nothing here runs at
import time, so the CPU-only test suite imports the package without a
CUDA toolkit.  A library's name also carries the hash of every shared
header (``csrc/*.cuh``), so an edit to a header rebuilds the sources.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "SOURCES", "build_all", "load", "nvcc_path"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("rms_norm.cu", "paged_attention.cu", "bfio_swap.cu",
           "decode_attention.cu", "ssm_scan.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
#: filled by :func:`build_all`: seconds spent building, and the compiler's
#: register/shared-memory report per source when ``verbose=True``
BUILD_INFO: dict = {"seconds": 0.0, "ptxas": {}}


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, ``PATH``, then
    the toolkit's default install prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from src/repro_torch/kernels/csrc at first "
        "use")


def _lib_path(src: str) -> Path:
    # -Xptxas=-v only reports; it does not change the library
    h = hashlib.sha1((CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(src).stem}-{h.hexdigest()[:12]}.so"


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Compile every source that has no up-to-date library, all in
    parallel, and return ``{source: library path}``.  Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out = {s: _lib_path(s) for s in SOURCES}
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [s for s in SOURCES if not out[s].exists()]
        if todo:
            nvcc = nvcc_path()
            procs = {}
            for s in todo:
                tmp = out[s].with_suffix(f".tmp{os.getpid()}")
                cmd = [nvcc, *NVCC_FLAGS,
                       *(("-Xptxas=-v",) if verbose else ()),
                       "-o", str(tmp), str(CSRC / s)]
                procs[s] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            errors = []
            for s, (tmp, p) in procs.items():
                log, _ = p.communicate()
                if p.returncode != 0:
                    errors.append(f"nvcc failed on {s}:\n{log}")
                    continue
                os.replace(tmp, out[s])
                if verbose:
                    BUILD_INFO["ptxas"][s] = log
            if errors:
                raise RuntimeError("\n".join(errors))
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source (built on first use)."""
    lib = _LIBS.get(source)
    if lib is None:
        paths = build_all()
        for s, p in paths.items():
            if s not in _LIBS:
                _LIBS[s] = ctypes.CDLL(str(p))
        lib = _LIBS[source]
    return lib
