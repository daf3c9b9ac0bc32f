"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (timed, with the compiler's register report).
3. Kernel phases, at the shapes of the granite-8b serving path: the
   RMS-norm kernel on (32, 4096) bf16 and the paged decode-attention
   kernel at B=32, Hq=32, Hkv=8, hd=128, block 16, 16 blocks per row
   (bf16 pool, permuted tables, ragged lengths including 1 and 256).
   Each is held against its plain PyTorch version (bf16, atol = rtol =
   2e-2) and timed with CUDA events beside its bound, its plain version
   and a one-call PyTorch yardstick the port never calls.
4. Cross-device check on a small input: granite-8b-smoke in float32
   served on the CPU (plain versions) and on the card (kernels) with the
   same weights must give equal engine stats and equal generations.
5. The main path: ``repro_torch.launch.serve`` on full granite-8b (36
   layers, bf16, seeded random weights), paged backend, bfio_h8, 4 workers
   x 8 slots, 32 requests of 16 new tokens.  Launch counters are zeroed
   just before and read just after; both kernels must have run on every
   decode step.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  TF32 is disabled for matmuls and
cuDNN so float32 comparisons are float32.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # float32 outside the tensor cores
TOL = dict(atol=2e-2, rtol=2e-2)
SLEEP_CYCLES = 5_000_000        # ~2.5 ms at H100 clocks: covers enqueue


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 50, warmup: int = 5, flush=None) -> float:
    """Median device time of one call, in ms.  Each call is queued behind
    a sleep kernel, so the host's launch cost (Python, ctypes) overlaps
    the sleep and the CUDA events around the call time the device work
    alone.  ``flush`` (a 256 MB buffer) is rewritten before the call so
    it finds the 50 MB L2 cold, as a decode step's attention does."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return float(np.median(out))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb = nbytes / H100_BYTES_PER_S * 1e3
    tf = flops / H100_FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def compare(name, got, want):
    torch.cuda.synchronize()
    check(torch.isfinite(got.float()).all().item(), f"{name}: non-finite")
    err = (got.float() - want.float()).abs()
    ok = (err <= TOL["atol"] + TOL["rtol"] * want.float().abs()).all().item()
    check(ok, f"{name}: kernel disagrees with its plain version (max abs "
              f"err {err.max().item():.3e})")
    return float(err.max().item())


def phase_rms_norm(dev, flush):
    from repro_torch.kernels import rms_norm as rk
    R, d = 32, 4096
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((R, d), generator=g, device=dev).to(torch.bfloat16)
    sc = torch.randn((d,), generator=g, device=dev)
    got = rk.rms_norm(x, sc, 1e-5)
    err = compare("rms_norm", got, rk.rms_norm_plain(x, sc, 1e-5))
    ms = time_ms(lambda: rk.rms_norm(x, sc, 1e-5))
    plain_ms = time_ms(lambda: rk.rms_norm_plain(x, sc, 1e-5))
    sc_lib = sc.to(x.dtype)
    lib_ms = time_ms(lambda: torch.nn.functional.rms_norm(
        x, (d,), weight=sc_lib, eps=1e-5))
    nbytes = 2 * R * d * x.element_size() + d * 4
    b_ms, b_by = bound(nbytes, 4.0 * R * d)
    return dict(name="rms_norm", route="cuda",
                source="src/repro_torch/kernels/csrc/rms_norm.cu",
                replaces="src/repro/kernels/rms_norm.py:28",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                shape=f"x ({R}, {d}) bf16, scale ({d},) f32")


def phase_paged_attention(dev, flush):
    from repro_torch.kernels import paged_attention as pa
    B, Hq, Hkv, hd, bs, mb = 32, 32, 8, 128, 16, 16
    n_pool = B * mb
    rng = np.random.default_rng(2)
    lens = rng.integers(1, mb * bs + 1, size=B).astype(np.int32)
    lens[0], lens[1] = 1, mb * bs
    perm = rng.permutation(n_pool)
    tables = np.full((B, mb), -1, np.int32)
    ptr = 0
    for b in range(B):
        n = -(-int(lens[b]) // bs)
        tables[b, :n] = perm[ptr:ptr + n]
        ptr += n
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((B, Hq, hd), generator=g, device=dev).to(torch.bfloat16)
    kp = torch.randn((n_pool, bs, Hkv, hd), generator=g,
                     device=dev).to(torch.bfloat16)
    vp = torch.randn((n_pool, bs, Hkv, hd), generator=g,
                     device=dev).to(torch.bfloat16)
    bt = torch.from_numpy(tables).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    got = pa.paged_decode_attention(q, kp, vp, bt, ln, block_size=bs)
    want = pa.paged_decode_attention_plain(q, kp, vp, bt, ln, bs)
    err = compare("paged_decode_attention", got, want)
    ms = time_ms(lambda: pa.paged_decode_attention(
        q, kp, vp, bt, ln, block_size=bs), flush=flush)
    plain_ms = time_ms(lambda: pa.paged_decode_attention_plain(
        q, kp, vp, bt, ln, bs), flush=flush)
    # yardstick: SDPA over the gathered contiguous view (gather untimed)
    L = mb * bs
    btc = bt.long().clamp(0, n_pool - 1)
    kc = kp[btc].reshape(B, L, Hkv, hd).permute(0, 2, 1, 3)
    vc = vp[btc].reshape(B, L, Hkv, hd).permute(0, 2, 1, 3)
    kc = kc.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    vc = vc.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    mask = (torch.arange(L, device=dev)[None, :] < ln.long()[:, None])
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = torch.nn.functional.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask)
    compare("sdpa yardstick", lib[:, :, 0], want)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask), flush=flush)
    tok = int(lens.sum())
    live_blocks = int(sum(-(-int(x) // bs) for x in lens))
    nbytes = (2 * tok * Hkv * hd * 2 + 2 * B * Hq * hd * 2
              + live_blocks * 4 + B * 4)
    b_ms, b_by = bound(nbytes, 4.0 * Hq * hd * tok)
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:71",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                shape=f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} block={bs} "
                      f"max_blocks={mb} bf16, sum(len)={tok}")


def phase_cross_device(dev):
    """Small input: the card's kernel path against the CPU plain path on
    the same float32 weights and request stream."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import make_policy
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.launch.serve import submit_requests
    cfg = dataclasses.replace(get_smoke_config("granite-8b"),
                              dtype="float32")
    p_cpu = init_params(cfg, 0, device="cpu")
    p_dev = _tree_to(p_cpu, dev)
    ec = EngineConfig(n_workers=2, slots_per_worker=4, max_seq_len=256,
                      cache_backend="paged", prefill_chunk=32)
    runs = []
    for params, d in ((p_cpu, "cpu"), (p_dev, dev)):
        eng = ServingEngine(cfg, params, ec, make_policy("bfio_h8"),
                            device=d)
        reqs = submit_requests(eng, 8, 8, seed=5)
        stats = eng.run()
        runs.append((stats, [r.generated for r in reqs]))
    check(runs[0][0] == runs[1][0],
          f"cross-device: engine stats differ {runs[0][0]} vs {runs[1][0]}")
    check(runs[0][1] == runs[1][1],
          "cross-device: generations on the card differ from the CPU "
          "plain path")
    return runs[1][0]["tokens"]


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rms_norm as rk
    t0 = time.perf_counter()
    build.build_all(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{len(build.SOURCES)} sources (nvcc, sm_90a)")
    for src, log in build.BUILD_INFO["ptxas"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}")

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    kernels = [phase_rms_norm(dev, flush), phase_paged_attention(dev, flush)]
    del flush
    for k in kernels:
        print(f"kernel {k['name']} [{k['shape']}]: {k['ms'] * 1e3:.2f} us "
              f"(bound {k['bound_ms'] * 1e3:.2f} us by {k['bound_by']}), "
              f"plain {k['plain_ms'] * 1e3:.2f} us, library "
              f"{k['library_ms'] * 1e3:.2f} us, max abs err "
              f"{k['max_abs_err']:.3e}")

    toks = phase_cross_device(dev)
    print(f"cross-device: granite-8b-smoke f32, {toks} tokens, stats and "
          f"generations equal on cpu and {torch.cuda.get_device_name(0)}")

    from repro_torch.launch.serve import build_parser, make_engine, serve
    args = build_parser().parse_args(
        ["--arch", "granite-8b", "--policy", "bfio_h8", "--cache-backend",
         "paged", "--workers", "4", "--slots", "8", "--requests", "32",
         "--max-new", "16", "--seed", "0"])
    t0 = time.perf_counter()
    eng = make_engine(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rk.rms_norm.launches = 0
    pa.paged_decode_attention.launches = 0
    out = serve(args, eng)
    launches = {"rms_norm": rk.rms_norm.launches,
                "paged_decode_attention": pa.paged_decode_attention.launches}
    stats, meas, reqs = out["stats"], out["measured"], out["requests"]
    check(all(r.done and not r.failed for r in reqs),
          "main path: not every request finished")
    check(all(len(r.generated) == args.max_new for r in reqs),
          "main path: a request generated the wrong number of tokens")
    check(all(0 <= t < eng.cfg.vocab_size for r in reqs
              for t in r.generated), "main path: token id out of range")
    n_dec = meas["decoded_steps"]
    L = eng.cfg.n_layers
    check(n_dec > 0, "main path: no decode step ran")
    check(launches["rms_norm"] >= (2 * L + 1) * n_dec,
          f"main path: rms_norm kernel launched {launches['rms_norm']} "
          f"times, need >= {(2 * L + 1) * n_dec}")
    check(launches["paged_decode_attention"] >= L * n_dec,
          f"main path: paged attention kernel launched "
          f"{launches['paged_decode_attention']} times, need >= "
          f"{L * n_dec}")
    print(f"main path: {eng.cfg.name} ({L} layers, d={eng.cfg.d_model}, "
          f"{eng.cfg.dtype}), init {init_s:.2f} s; {len(reqs)} requests, "
          f"{stats['tokens']} tokens, {meas['steps']} steps "
          f"({n_dec} with decode); launches {launches}")
    print(f"main path MEASURED on {meas['device']}: wall "
          f"{meas['wall_s']:.3f} s, decode step {meas['decode_step_ms']:.2f}"
          f" ms (mean of {meas['decode_phase_steps']} decode-only steps), "
          f"{meas['tokens_per_s']:.1f} tok/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"main path MODELLED (engine stats, A100 power model): "
          f"time {stats['time_s']:.4f} s, {stats['throughput_tok_s']:.1f} "
          f"tok/s, energy {stats['energy_j']:.2f} J, avg imbalance "
          f"{stats['avg_imbalance']:.2f}")

    rows = []
    for k in kernels:
        row = {key: k[key] for key in (
            "name", "route", "source", "replaces")}
        row["launches"] = launches[k["name"]]
        row.update({key: k[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
        row["matched"] = True
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
