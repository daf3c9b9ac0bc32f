"""The port stands alone: importing every ``repro_torch`` module, and the
chip smoke script, pulls in neither JAX nor the reference package."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
sys.path.insert(0, {root!r})
import chip_smoke  # noqa: F401  (module level only; main() not run)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names))
print(",".join(bad))
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c",
                        _PROBE.format(root=str(REPO))],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert int(lines[0]) >= 30, r.stdout          # every module was walked
    assert lines[1:] == [""], f"port imported: {lines[1:]}"
