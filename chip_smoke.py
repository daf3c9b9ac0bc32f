"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a, one process per source, all at once (timed,
   with the compiler's register report).
3. Kernel phases, at the shapes of the serving paths: the RMS-norm
   kernel (K2) on (32, 4096) bf16, at a prefill shape (2048, 4096) and at
   widths 6144 and 8192, each plain and with the residual add fused (its
   sum PyTorch's, its norm bit-identical to the kernel's norm of that
   sum), also timed back to back from a CUDA graph, beside ``F.rms_norm``
   (after ``x + r`` for the fused call); the paged decode-attention kernel
   (K1) at B=32, Hq=32, Hkv=8, hd=128, block 16, 16 blocks per row (bf16
   pool, permuted tables, ragged lengths including 1 and 256) and at
   granite-34b's head layout (Hq=48 over one KV head); the contiguous
   decode-attention kernel (K3) at granite-8b's slot shape (B=32, Hq=32,
   Hkv=8, hd=128, L=256), zamba2's (Hq=Hkv=32, hd=64) and granite-34b's
   head layout, with a rolling case (lengths past L) and a
   sliding-window case (bf16, ragged lengths including 1 and L); each
   held against its plain PyTorch version (bf16, atol = rtol = 2e-2).
   K1 and K3 are timed whole and as their split pass alone, and each
   case prints its share of the byte bound and its ratio to SDPA; the
   timing method's floor (a one-element add, timed the same way) is
   printed and kept in their rows.  The
   chunked-scan kernel (K5) on float32 inputs as the models pass them, at
   zamba2's prefill shape (B=32, S=64, H=32, dk=64, dv=128, chunk 64), at
   xlstm's (H=4, dk=512, dv=513), at a ragged S that
   ``ops.ssm_chunk_scan`` pads, at xlstm's widths over four chunks
   from a nonzero initial state and at both families' widths with the
   chunk of 128 that a prefill of 128 tokens or more gets, held against
   its plain version at 1e-3 (y and the final state); each case also
   times its scores pass alone and prints its share of the bound.  The
   BF-IO swap-search kernel (K4) at the fleet router's shape (C=1, G=4,
   N=64, W=1, integer loads), at pod scale (C=8, G=32, N=512, W=9,
   random floats, ragged ``valid``, ``assign`` with -1s) and at
   ``pod_bfio_p2``'s two pods of two workers with tied loads, held
   against its plain version and its dense oracle bit for bit
   (``best_val`` everywhere, ``best_j`` on finite rows, 0 on the
   others), with the profiler showing one device kernel a call.  Each is
   timed with CUDA events beside its bound, its
   plain version and, where one exists, a one-call PyTorch yardstick the
   port never calls.
4. Cross-device checks on a small input: float32 smoke configs served on
   the CPU (plain versions) and on the card (kernels) with the same
   weights.  granite-8b-smoke on the paged backend; then a fleet of 4
   replicas under ``bfio``, under ``pod_bfio_p2`` and as an
   ``AsyncFleetServer`` with the utilization autoscaler; then the slot
   backend with granite-8b-smoke (synchronous and chunked prefill),
   zamba2-1.2b-smoke and xlstm-350m-smoke.  Stats (and telemetry rows)
   and generations equal.  zamba2-1.2b-smoke and xlstm-350m-smoke again
   with prompts of 129..200 tokens (prefill pad 256), so that their scans
   run K5 at the models' chunk of 128: stats and generations equal.  The
   MoE family: ``moe_ffn`` at qwen3-moe-30b-a3b's widths (d=2048, 128
   experts top-8) on inputs free of router near ties, card against CPU
   within 1e-4; granite-moe-3b-a800m-smoke and qwen3-moe-30b-a3b-smoke
   on the slot backend and on the paged backend with chunked prefill:
   stats equal, differing generated tokens counted.
5. The single-engine path: ``repro_torch.launch.serve`` on full
   granite-8b (36 layers, bf16, seeded random weights), paged backend,
   bfio_h8, 4 workers x 8 slots, 32 requests of 16 new tokens.  Launch
   counters are zeroed just before and read just after; K1 and K2 must
   have run on every decode step.  The engine is freed afterwards.  Then
   the MoE path the same way: full qwen3-moe-30b-a3b (48 layers, d=2048,
   128 experts top-8, bf16, 30.5 B parameters), with its init seconds,
   peak device memory and mean decode-step ms; its weights are freed
   before the next phase.
6. The fleet path: ``repro_torch.launch.serve`` in fleet mode on full
   granite-8b (one shared copy of the weights), 4 replicas of 4 workers x
   8 slots, ``bfio_h0`` engines behind the ``bfio`` router, 64 requests of
   the ``flash_crowd`` scenario.  Counters zeroed just before and read
   just after: every request must finish, the swap kernel must run
   ``swap_iters`` times per routing step, and K1 and K2 on every replica
   decode step.
7. The slot paths: ``repro_torch.launch.serve --cache-backend slot`` at
   full width and depth with bfio_h8, 4 workers x 8 slots and 16 new
   tokens: granite-8b (32 requests; K3 on each of its 36 layers and K2
   on every norm of every decode step), zamba2-1.2b (32 requests; K3 on
   each of its 6 shared-attention applications per decode step, K5 on
   each of its 32 Mamba2 blocks per prefill call, K2 on every norm) and
   xlstm-350m (8 requests; K5 on each of its 21 mLSTM blocks per prefill
   call, K2 on every norm).  Counters zeroed just before and read just
   after each; each engine is freed before the next.

The second-to-last line is ``{"kernels": [...]}`` (each kernel's launches
by path under ``launches_by_path``: engine, moe, fleet and the three slot
paths); the last line is
``{"ok": true, "device": {...}}``.  TF32 is disabled for matmuls and
cuDNN so float32 comparisons are float32.
"""
from __future__ import annotations

import dataclasses
import gc
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
H100_BF16_FLOPS = 989e12        # bf16 on the tensor cores, dense
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


def bound(nbytes: float, flops: float,
          flops_per_s: float = H100_FP32_FLOPS) -> tuple[float, str]:
    """The least time (ms) for the bytes and the operations, and which of
    the two it is; ``flops_per_s`` is the peak for the operations' type."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    tf = flops / flops_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def compare(name, got, want, tol=TOL):
    torch.cuda.synchronize()
    check(torch.isfinite(got.float()).all().item(), f"{name}: non-finite")
    err = (got.float() - want.float()).abs()
    ok = (err <= tol["atol"] + tol["rtol"] * want.float().abs()).all().item()
    check(ok, f"{name}: kernel disagrees with its plain version (max abs "
              f"err {err.max().item():.3e})")
    return float(err.max().item())


def time_graph_ms(fn, n: int = 20, reps: int = 20) -> float:
    """Device time of one call when ``n`` calls run back to back from a
    CUDA graph (median of ``reps`` replays, divided by ``n``): no host
    launch cost and no sleep-kernel floor in it, as in a captured step."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / n)
    del graph
    return float(np.median(out))


def _norm_case(dev, R, d, *, fused, seed):
    """K2 on one bf16 case: the norm, or with ``fused`` the residual add +
    norm, against its plain version, timed beside its bound, the plain
    version and the library calls that compute the same function
    (``F.rms_norm``; for the fused call ``x + r`` and then ``F.rms_norm``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rms_norm as rk
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((R, d), generator=g, device=dev).to(torch.bfloat16)
    r = torch.randn((R, d), generator=g, device=dev).to(torch.bfloat16)
    sc = torch.randn((d,), generator=g, device=dev)
    sc_lib = sc.to(x.dtype)
    es = x.element_size()

    def fn():
        if fused:
            return rk.add_rms_norm(x, r, sc, 1e-5)
        return rk.rms_norm(x, sc, 1e-5)

    def plain():
        if fused:
            return rk.add_rms_norm_plain(x, r, sc, 1e-5)
        return rk.rms_norm_plain(x, sc, 1e-5)

    def lib():
        return F.rms_norm(x + r if fused else x, (d,), weight=sc_lib,
                          eps=1e-5)

    what = f"{'add_' if fused else ''}rms_norm ({R}, {d})"
    out, want = fn(), plain()
    if fused:
        (s, out), (s0, want) = out, want
        torch.cuda.synchronize()
        check(torch.equal(s, s0), f"{what}: x + r differs from PyTorch's add")
        check(torch.equal(out, rk.rms_norm(s0, sc, 1e-5)),
              f"{what}: not bit-identical to rms_norm(x + r) through the "
              f"kernel")
    err = compare(what, out, want)
    nbytes = (4 if fused else 2) * R * d * es + d * 4
    flops = (5.0 if fused else 4.0) * R * d
    b_ms, b_by = bound(nbytes, flops)
    return dict(max_abs_err=err, ms=time_ms(fn), graph_ms=time_graph_ms(fn),
                plain_ms=time_ms(plain), library_ms=time_ms(lib),
                library_graph_ms=time_graph_ms(lib), bound_ms=b_ms,
                bound_by=b_by,
                shape=f"{'x + r, ' if fused else ''}x ({R}, {d}) bf16, "
                      f"scale ({d},) f32")


_NORM_KEYS = ("shape", "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms", "library_graph_ms", "max_abs_err")


def phase_rms_norm(dev):
    """K2 at the decode shape (32, 4096) bf16 (the row's numbers), at a
    prefill shape (2048, 4096) and at granite-34b's and qwen2-72b's widths
    (6144, 8192) at 32 rows, each plain and with the residual add fused."""
    cases = []
    for R, d, seed in ((32, 4096, 1), (2048, 4096, 3), (32, 6144, 4),
                       (32, 8192, 5)):
        cases += [_norm_case(dev, R, d, fused=False, seed=seed),
                  _norm_case(dev, R, d, fused=True, seed=seed)]
    for c in cases:
        print(f"kernel rms_norm [{c['shape']}]: {c['ms'] * 1e3:.2f} us, "
              f"{c['graph_ms'] * 1e3:.2f} us a call back to back in a CUDA "
              f"graph (bound {c['bound_ms'] * 1e3:.3f} us by "
              f"{c['bound_by']}), plain {c['plain_ms'] * 1e3:.2f} us, "
              f"library {c['library_ms'] * 1e3:.2f} us ("
              f"{c['library_graph_ms'] * 1e3:.2f} in a graph; kernel / "
              f"library {c['ms'] / c['library_ms']:.2f}x, in a graph "
              f"{c['graph_ms'] / c['library_graph_ms']:.2f}x), max abs err "
              f"{c['max_abs_err']:.3e}")
    main = cases[0]
    return dict(name="rms_norm", route="cuda",
                source="src/repro_torch/kernels/csrc/rms_norm.cu",
                replaces="src/repro/kernels/rms_norm.py:28",
                **{k: main[k] for k in _NORM_KEYS},
                max_abs_err_all=max(c["max_abs_err"] for c in cases),
                cases=[{k: c[k] for k in _NORM_KEYS} for c in cases[1:]])


def _paged_case(dev, flush, B, Hq, Hkv, hd, bs, mb, *, seed):
    """K1 on one bf16 case (permuted tables, ragged lengths including 1
    and ``mb * bs``): against plain, timed whole and split pass alone
    beside its byte bound, the plain version and SDPA over the gathered
    contiguous view (the gather untimed)."""
    from repro_torch.kernels import paged_attention as pa
    n_pool = B * mb
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, mb * bs + 1, size=B).astype(np.int32)
    lens[0], lens[1] = 1, mb * bs
    perm = rng.permutation(n_pool)
    tables = np.full((B, mb), -1, np.int32)
    ptr = 0
    for b in range(B):
        n = -(-int(lens[b]) // bs)
        tables[b, :n] = perm[ptr:ptr + n]
        ptr += n
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    q = torch.randn((B, Hq, hd), generator=g, device=dev).to(torch.bfloat16)
    kp = torch.randn((n_pool, bs, Hkv, hd), generator=g,
                     device=dev).to(torch.bfloat16)
    vp = torch.randn((n_pool, bs, Hkv, hd), generator=g,
                     device=dev).to(torch.bfloat16)
    bt = torch.from_numpy(tables).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    got = pa.paged_decode_attention(q, kp, vp, bt, ln, block_size=bs)
    want = pa.paged_decode_attention_plain(q, kp, vp, bt, ln, bs)
    err = compare(f"paged_decode_attention Hq={Hq} Hkv={Hkv}", got, want)
    ms = time_ms(lambda: pa.paged_decode_attention(
        q, kp, vp, bt, ln, block_size=bs), flush=flush)
    kernel_ms = time_ms(lambda: pa._launch(q, kp, vp, bt, ln, merge=False),
                        flush=flush)
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
    del kc, vc
    tok = int(lens.sum())
    live_blocks = int(sum(-(-int(x) // bs) for x in lens))
    nbytes = (2 * tok * Hkv * hd * 2 + 2 * B * Hq * hd * 2
              + live_blocks * 4 + B * 4)
    b_ms, b_by = bound(nbytes, 4.0 * Hq * hd * tok, H100_BF16_FLOPS)
    return dict(max_abs_err=err, ms=ms, kernel_only_ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, live_tokens=tok,
                shape=f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} block={bs} "
                      f"max_blocks={mb} bf16, sum(len)={tok}")


def _print_attention_cases(name, cases):
    """One line per case: times, share of the byte bound, ratio to SDPA."""
    for c in cases:
        print(f"kernel {name} [{c['shape']}, {c['live_tokens']} live "
              f"tokens]: {c['ms'] * 1e3:.2f} us (split pass alone "
              f"{c['kernel_only_ms'] * 1e3:.2f} us; bound "
              f"{c['bound_ms'] * 1e3:.2f} us by {c['bound_by']}, "
              f"{100 * c['bound_ms'] / c['ms']:.1f}% of it), plain "
              f"{c['plain_ms'] * 1e3:.2f} us, SDPA "
              f"{c['library_ms'] * 1e3:.2f} us (kernel / SDPA "
              f"{c['ms'] / c['library_ms']:.2f}x), max abs err "
              f"{c['max_abs_err']:.3e}")


_CASE_KEYS = ("shape", "ms", "kernel_only_ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms", "max_abs_err")


def phase_paged_attention(dev, flush):
    """K1 at the paged engine's shape (B=32, Hq=32, Hkv=8, hd=128, block
    16, 16 blocks a row: the row's numbers) and at granite-34b's head
    layout (Hq=48 over one KV head)."""
    cases = [_paged_case(dev, flush, 32, 32, 8, 128, 16, 16, seed=2),
             _paged_case(dev, flush, 32, 48, 1, 128, 16, 16, seed=4)]
    _print_attention_cases("paged_decode_attention", cases)
    main = cases[0]
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:71",
                **{k: main[k] for k in _CASE_KEYS},
                max_abs_err_all=max(c["max_abs_err"] for c in cases),
                cases=[{k: c[k] for k in _CASE_KEYS} for c in cases[1:]])


def _swap_inputs(dev, C, G, N, W, *, seed, n_valid=None, ties=False):
    """Swap-search inputs.  With ``n_valid`` the router's shape: integer
    loads and prefill sizes, the first ``n_valid`` rows of the padded
    bucket valid and assigned; without, random floats with ragged
    ``valid`` and ``assign`` holding -1s (the reference's fixtures); with
    ``ties``, loads and sizes drawn from {0, 1, 2}, so that loads tie
    exactly within a window slot."""
    rng = np.random.default_rng(seed)
    if n_valid is not None:
        loads = rng.integers(0, 2048, (C, G, W)).astype(np.float32)
        cands = rng.integers(2, 256, (C, N, W)).astype(np.float32)
        valid = np.zeros((C, N), bool)
        valid[:, :n_valid] = True
        assign = np.where(valid, rng.integers(0, G, (C, N)), -1)
    else:
        loads = rng.uniform(0, 10, (C, G, W)).astype(np.float32)
        cands = rng.uniform(0, 5, (C, N, W)).astype(np.float32)
        assign = rng.integers(-1, G, (C, N))
        valid = rng.random((C, N)) > 0.1
    if ties:
        loads = rng.integers(0, 3, (C, G, W)).astype(np.float32)
        cands = rng.integers(0, 3, (C, N, W)).astype(np.float32)
    return (torch.from_numpy(loads).to(dev), torch.from_numpy(cands).to(dev),
            torch.from_numpy(assign.astype(np.int32)).to(dev),
            torch.from_numpy(valid).to(dev))


def _device_kernels(fn) -> list[str]:
    """The device kernels that one call of ``fn`` runs, by the profiler.
    A trace with no device activity at all is the profiler's miss (it has
    come back empty for a call of a few microseconds), not a count: such a
    trace is taken again, three times at most."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ran = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ran:
            break
    return ran


def _swap_case(dev, C, G, N, W, **kw):
    """K4 on one case: bit-identical to the plain version and the dense
    oracle, one device kernel a call, timed beside its bound and the plain
    version."""
    from repro_torch.kernels import bfio_swap as bs
    args = _swap_inputs(dev, C, G, N, W, **kw)
    what = f"bfio_swap C={C} G={G} N={N} W={W}"
    vk, ak = bs.swap_best(*args)
    vp, ap = bs.swap_best_plain(*args)
    vd, ad = bs.swap_best_dense(*args)
    torch.cuda.synchronize()
    fin = torch.isfinite(vp)
    for name, v, a in (("plain version", vp, ap), ("dense oracle", vd, ad)):
        check(torch.equal(vk, v), f"{what}: best_val differs from the "
              f"{name} (max abs err "
              f"{(vk - v).abs().nan_to_num().max().item():.3e})")
        check(torch.equal(ak[fin], a[fin]),
              f"{what}: best_j differs from the {name} on finite rows")
    check(bool((ak[~fin] == 0).all().item()),
          f"{what}: an infeasible row's best_j is not 0")
    check(bool(fin.any().item()), f"{what}: no feasible pair")
    ran = _device_kernels(lambda: bs.swap_best(*args))
    check(len(ran) == 1 and "swap_best" in ran[0],
          f"{what}: one call ran {ran}, not the one swap kernel")
    loads, cands, assign, valid = args
    ms = time_ms(lambda: bs.swap_best(*args))
    plain_ms = time_ms(lambda: bs.swap_best_plain(*args))
    # bound: each input read once, each output written once; operations
    # are 6 float32 ops (sub, add, sub, max, max, add) per window slot of
    # each feasible pair of this input
    adm = (assign >= 0) & valid
    ga = assign.clamp(min=0)
    pairs = int((adm[:, :, None] & adm[:, None, :]
                 & (ga[:, :, None] != ga[:, None, :])).sum().item())
    nbytes = 4 * C * G * W + 4 * C * N * W + 5 * C * N + 8 * C * N
    b_ms, b_by = bound(nbytes, 6.0 * pairs * W)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, feasible_pairs=pairs,
                shape=f"C={C} G={G} N={N} W={W}"
                      + (", loads in {0, 1, 2}" if kw.get("ties") else ""))


_SWAP_KEYS = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
              "feasible_pairs")


def phase_bfio_swap(dev):
    """K4 at the fleet router's shape (its power-of-two bucket of 64
    candidates, 24 real), at pod scale, and at two pods of two workers
    with tied loads; bit-identical to plain and dense, one kernel a
    call."""
    fleet = _swap_case(dev, 1, 4, 64, 1, seed=11, n_valid=24)
    pod = _swap_case(dev, 8, 32, 512, 9, seed=12)
    ties = _swap_case(dev, 2, 2, 64, 3, seed=13, ties=True)
    for k in (fleet, pod, ties):
        print(f"kernel bfio_swap [{k['shape']}]: {k['ms'] * 1e3:.2f} us, "
              f"one device kernel a call (bound {k['bound_ms'] * 1e3:.3f} us "
              f"by {k['bound_by']}, {k['feasible_pairs']} feasible pairs), "
              f"plain {k['plain_ms'] * 1e3:.2f} us, library none, "
              f"bit-identical to plain and dense")
    return dict(name="bfio_swap", route="cuda",
                source="src/repro_torch/kernels/csrc/bfio_swap.cu",
                replaces="src/repro/kernels/bfio_swap.py:126",
                **{k: fleet[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape")},
                at_pod_scale={k: pod[k] for k in _SWAP_KEYS},
                cases=[{k: ties[k] for k in _SWAP_KEYS}])


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


def phase_cross_device_fleet(dev):
    """A fleet of 4 replicas on the same float32 weights, on the CPU and
    on the card: ``bfio``, ``pod_bfio_p2`` and the async fleet with the
    utilization autoscaler (deciding every 20 ms of fleet clock, which
    drains replicas mid-stream) must give equal stats, telemetry rows and
    generations."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.fleet import (AsyncFleetServer, FleetServer,
                                   FleetTelemetry, make_autoscaler,
                                   make_scenario)
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig
    cfg = dataclasses.replace(get_smoke_config("granite-8b"),
                              dtype="float32")
    p_cpu = init_params(cfg, 0, device="cpu")
    p_dev = _tree_to(p_cpu, dev)
    ec = EngineConfig(n_workers=2, slots_per_worker=4, max_seq_len=256,
                      cache_backend="paged", prefill_chunk=32)
    sc = make_scenario("flash_crowd", n_requests=32, n_replicas=4,
                       n_workers=2, slots_per_worker=4, max_seq_len=256,
                       vocab_size=cfg.vocab_size, seed=3)
    cases = (("bfio", FleetServer, {}), ("pod_bfio_p2", FleetServer, {}),
             ("bfio", AsyncFleetServer, {"autoscaler": "util"}))
    out = []
    for router, cls, kw in cases:
        runs = []
        for params, d in ((p_cpu, "cpu"), (p_dev, dev)):
            tel = FleetTelemetry()
            extra = ({"autoscaler": make_autoscaler(
                kw["autoscaler"], r_min=1, r_max=4, interval_s=0.02,
                warmup_s=0.01)} if kw else {})
            fleet = cls(cfg, params, ec, n_replicas=4, router=router,
                        policy="bfio_h0", device=d, telemetry=tel,
                        **extra)
            fleet.submit_scenario(sc)
            stats = fleet.run()
            runs.append((stats, tel.steps, tel.requests,
                         [r.generated for r in fleet.requests]))
        what = f"{cls.__name__}/{router}"
        for i, name in enumerate(("stats", "telemetry steps",
                                  "telemetry requests", "generations")):
            check(runs[0][i] == runs[1][i],
                  f"cross-device fleet {what}: {name} differ between the "
                  f"CPU and the card")
        check(runs[1][0]["completed"] == sc.n_requests,
              f"cross-device fleet {what}: not every request completed")
        check(not kw or runs[1][0]["drain_handoffs"] > 0,
              f"cross-device fleet {what}: no drain handoff, so the card's "
              f"host-staged swap path went untested")
        out.append((what, runs[1][0]["tokens"], len(runs[1][1]),
                    runs[1][0].get("drain_handoffs", 0)))
    return out


def _count_decodes(fleet) -> list:
    """Count the replicas' paged decode calls (one per replica decode
    step) by wrapping each backend's ``decode``."""
    n = [0]
    for eng in fleet.engines:
        inner = eng.backend.decode

        def counted(*a, _inner=inner, **kw):
            n[0] += 1
            return _inner(*a, **kw)
        eng.backend.decode = counted
    return n


def phase_fleet_path() -> dict:
    """The fleet main path on full granite-8b through the launcher's
    fleet mode; returns the kernels' launch counts of this run."""
    from repro_torch.launch.serve import (build_parser, make_fleet,
                                          make_model, serve_fleet)
    args = build_parser().parse_args(
        ["--arch", "granite-8b", "--replicas", "4", "--workers", "4",
         "--slots", "8", "--cache-backend", "paged", "--policy", "bfio_h0",
         "--router", "bfio", "--scenario", "flash_crowd", "--requests",
         "64", "--seed", "0"])
    t0 = time.perf_counter()
    cfg, params, device = make_model(args)
    built = make_fleet(args, cfg, params, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    fleet = built["fleet"]
    decodes = _count_decodes(fleet)
    launches = _zero_and_read(None)
    out = serve_fleet(args, built=built)
    launches = _zero_and_read(launches)
    stats, meas = out["stats"], out["measured"]
    reqs = fleet.requests
    check(len(reqs) == 64 and all(r.done and not r.failed for r in reqs),
          "fleet path: not every request finished")
    check(stats["completed"] == 64 and stats["failed"] == 0,
          f"fleet path: {stats['completed']} completed, {stats['failed']} "
          f"failed")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "fleet path: token id out of range")
    L, n_dec = cfg.n_layers, decodes[0]
    n_route = meas["routing_steps"]
    swap_iters = fleet.router.swap_iters
    check(n_dec > 0 and n_route > 0, "fleet path: no decode or no routing")
    check(all(launches[k] > 0 for k in ("rms_norm", "paged_decode_attention",
                                         "bfio_swap")),
          f"fleet path: a kernel of the path never launched: {launches}")
    check(launches["bfio_swap"] >= swap_iters * n_route,
          f"fleet path: swap kernel launched {launches['bfio_swap']} "
          f"times over {n_route} routing steps, need >= {swap_iters} "
          f"each")
    check(launches["rms_norm"] >= (2 * L + 1) * n_dec,
          f"fleet path: rms_norm kernel launched "
          f"{launches['rms_norm']} times, need >= "
          f"{(2 * L + 1) * n_dec}")
    check(launches["paged_decode_attention"] >= L * n_dec,
          f"fleet path: paged attention kernel launched "
          f"{launches['paged_decode_attention']} times, need >= "
          f"{L * n_dec}")
    print(f"fleet path: {cfg.name} ({L} layers, d={cfg.d_model}, "
          f"{cfg.dtype}, one shared copy), R={fleet.R} x {args.workers} "
          f"workers x {args.slots} slots, router {stats['router']}, "
          f"scenario flash_crowd; init {init_s:.2f} s; 64 requests, "
          f"{stats['tokens']} tokens, {meas['fleet_steps']} fleet steps, "
          f"{n_dec} replica decode steps, {n_route} routing steps; "
          f"launches {launches}")
    print(f"fleet path MEASURED on {meas['device']}: wall "
          f"{meas['wall_s']:.3f} s, fleet step {meas['fleet_step_ms']:.2f} "
          f"ms (mean of {meas['fleet_steps']}), router solve "
          f"{meas['router_solve_ms']:.2f} ms per routing step, "
          f"{meas['tokens_per_s']:.1f} tok/s, peak memory "
          f"{meas['peak_memory_gb']:.2f} GB")
    print(f"fleet path MODELLED (fleet stats, A100 power model): time "
          f"{stats['time_s']:.4f} s, {stats['throughput_tok_s']:.1f} tok/s, "
          f"energy {stats['energy_j']:.2f} J ({stats['idle_j']:.2f} J "
          f"barrier idle), {stats['energy_per_token']:.3f} J/tok, "
          f"cross-replica imbalance {stats['avg_cross_imbalance']:.2f}")
    del out, built, fleet, params
    _free()
    return launches


def _decode_case(dev, flush, B, Hq, Hkv, hd, L, *, mode, window=0, seed):
    """K3 on one bf16 case: against plain, timed beside its byte bound,
    the plain version and SDPA on the same contiguous cache (the expanded
    (B, Hq, L, hd) layout SDPA wants is built untimed) with a boolean mask
    of each row's live span."""
    from repro_torch.kernels import decode_attention as da
    rng = np.random.default_rng(seed)
    if mode == "rolling":
        lens = rng.integers(L + 1, 3 * L, size=B)
    else:
        lens = rng.integers(1, L + 1, size=B)
        lens[0], lens[1] = 1, L
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Hq, hd), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, L, Hkv, hd), generator=g,
                    device=dev).to(torch.bfloat16)
    v = torch.randn((B, L, Hkv, hd), generator=g,
                    device=dev).to(torch.bfloat16)
    ln = torch.from_numpy(lens.astype(np.int32)).to(dev)
    kw = dict(sliding_window=window, rolling=mode == "rolling")
    got = da.decode_attention(q, k, v, ln, **kw)
    want = da.decode_attention_plain(q, k, v, ln, **kw)
    err = compare(f"decode_attention {mode}", got, want)
    ms = time_ms(lambda: da.decode_attention(q, k, v, ln, **kw), flush=flush)
    kernel_ms = time_ms(lambda: da._launch(q, k, v, ln, merge=False, **kw),
                        flush=flush)
    plain_ms = time_ms(lambda: da.decode_attention_plain(q, k, v, ln, **kw),
                       flush=flush)
    lo, hi = da.live_span(ln, L, **kw)
    pos = torch.arange(L, device=dev)[None, :]
    mask = ((pos >= lo[:, None]) & (pos < hi[:, None]))[:, None, None, :]
    G = Hq // Hkv
    kc = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    vc = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    q4 = q[:, :, None, :]
    lib = torch.nn.functional.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask)
    compare(f"sdpa yardstick {mode}", lib[:, :, 0], want)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask), flush=flush)
    del kc, vc
    tok = int((hi - lo).sum().item())
    nbytes = 2 * tok * Hkv * hd * 2 + 2 * B * Hq * hd * 2 + B * 4
    b_ms, b_by = bound(nbytes, 4.0 * Hq * hd * tok, H100_BF16_FLOPS)
    return dict(max_abs_err=err, ms=ms, kernel_only_ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, live_tokens=tok,
                shape=f"{mode}: B={B} Hq={Hq} Hkv={Hkv} hd={hd} L={L}"
                      + (f" window={window}" if window else "") + " bf16")


def phase_decode_attention(dev, flush):
    """K3 at granite-8b's slot shape (the row's numbers), zamba2's shape,
    a rolling cache with lengths past L, a sliding window and granite-34b's
    head layout (Hq=48 over one KV head)."""
    cases = [
        _decode_case(dev, flush, 32, 32, 8, 128, 256, mode="causal",
                     seed=21),
        _decode_case(dev, flush, 32, 32, 32, 64, 256, mode="causal",
                     seed=22),
        _decode_case(dev, flush, 32, 32, 8, 128, 256, mode="rolling",
                     seed=23),
        _decode_case(dev, flush, 32, 32, 8, 128, 256, mode="window",
                     window=96, seed=24),
        _decode_case(dev, flush, 32, 48, 1, 128, 256, mode="causal",
                     seed=25),
    ]
    _print_attention_cases("decode_attention", cases)
    main = cases[0]
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:75",
                **{k: main[k] for k in _CASE_KEYS},
                max_abs_err_all=max(c["max_abs_err"] for c in cases),
                cases=[{k: c[k] for k in _CASE_KEYS} for c in cases[1:]])


def _ssm_case(dev, flush, B, S, H, dk, dv, chunk, *, seed, init=False):
    """K5 on float32 inputs (the reference's fixture: a <= 0, g >= 0),
    through ``ops.ssm_chunk_scan`` (which pads a ragged S), against the
    plain version on the same padded inputs; with ``init``, from a
    nonzero initial state.  Also times the scores pass alone."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k = (torch.randn((B, S, H, dk), generator=g, device=dev)
            for _ in "qk")
    v = torch.randn((B, S, H, dv), generator=g, device=dev)
    a = -torch.randn((B, S, H), generator=g, device=dev).abs()
    gi = torch.randn((B, S, H), generator=g, device=dev).abs()
    s0 = (0.1 * torch.randn((B, H, dk, dv), generator=g, device=dev)
          if init else None)
    pad = (-S) % chunk
    Sp = S + pad

    def padseq(x):
        return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))

    y, st = ops.ssm_chunk_scan(q, k, v, a, gi, chunk=chunk,
                               initial_state=s0)
    padded = [padseq(x) for x in (q, k, v, a, gi)]
    y0, st0 = ss.ssm_chunk_scan_plain(*padded, chunk=chunk, initial_state=s0)
    tol = dict(atol=1e-3, rtol=1e-3)
    err = max(compare("ssm_chunk_scan y", y, y0[:, :S], tol),
              compare("ssm_chunk_scan state", st, st0, tol))
    ms = time_ms(lambda: ss.ssm_chunk_scan(*padded, chunk=chunk,
                                           initial_state=s0), flush=flush)
    qp, kp, _, ap, gp = padded
    scores_ms = time_ms(lambda: ss.scores_pass(qp, kp, ap, gp, chunk=chunk),
                        flush=flush)
    plain_ms = time_ms(lambda: ss.ssm_chunk_scan_plain(
        *padded, chunk=chunk, initial_state=s0), flush=flush)
    # bytes: q, k, v, a, g (and an initial state) read once, y and the
    # state written once; operations: the multiply-adds the call needs,
    # two flops each: the lower-triangle scores and W v of every chunk,
    # q . S_prev and the state update of every chunk but chunk 0's
    # q . S_prev when there is no initial state (its state is zero).  The
    # chunked form with that product counted, as earlier rows were bound,
    # is printed beside it.  The workspace's traffic is not in the bound.
    nc = Sp // chunk
    tri = chunk * (chunk + 1) // 2
    fma = B * H * (nc * tri * (dk + dv)
                   + (2 * nc - (0 if init else 1)) * chunk * dk * dv)
    fma_chunked = B * H * nc * (tri * (dk + dv) + 2 * chunk * dk * dv)
    nbytes = 4 * (B * Sp * H * (2 * dk + 2 * dv + 2)
                  + (2 if init else 1) * B * H * dk * dv)
    b_ms, b_by = bound(nbytes, 2.0 * fma)
    p = ss.plan(B, Sp, H, dk, dv, chunk)
    return dict(max_abs_err=err, ms=ms, scores_ms=scores_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_share=b_ms / ms,
                bound_ms_chunked_form=bound(nbytes, 2.0 * fma_chunked)[0],
                library_ms=None, workspace_mb=p.workspace_bytes / 1e6,
                tile_v=p.tile_v,
                shape=f"B={B} S={S}" + (f" (padded to {Sp})" if pad else "")
                      + f" H={H} dk={dk} dv={dv} chunk={chunk} f32"
                      + (", initial state" if init else ""))


_SSM_KEYS = ("shape", "ms", "scores_ms", "plain_ms", "bound_ms", "bound_by",
             "bound_share", "bound_ms_chunked_form", "workspace_mb",
             "tile_v", "max_abs_err")


def phase_ssm_scan(dev, flush):
    """K5 at zamba2's prefill shape (the row's numbers), xlstm's mLSTM
    shape, a ragged S, xlstm's widths over four chunks from a nonzero
    initial state, and both families at the chunk of 128 the models pass
    for a prefill of 128 tokens or more."""
    cases = [
        _ssm_case(dev, flush, 32, 64, 32, 64, 128, 64, seed=31),
        _ssm_case(dev, flush, 32, 64, 4, 512, 513, 64, seed=32),
        _ssm_case(dev, flush, 8, 100, 32, 64, 128, 64, seed=33),
        _ssm_case(dev, flush, 8, 256, 4, 512, 513, 64, seed=34, init=True),
        _ssm_case(dev, flush, 32, 256, 32, 64, 128, 128, seed=35),
        _ssm_case(dev, flush, 32, 256, 4, 512, 513, 128, seed=36),
    ]
    for c in cases:
        print(f"kernel ssm_chunk_scan [{c['shape']}]: {c['ms'] * 1e3:.2f} us"
              f" (scores pass alone {c['scores_ms'] * 1e3:.2f} us; bound "
              f"{c['bound_ms'] * 1e3:.2f} us by {c['bound_by']}, "
              f"{100 * c['bound_share']:.1f}% of it; chunked-form bound "
              f"{c['bound_ms_chunked_form'] * 1e3:.2f} us; workspace "
              f"{c['workspace_mb']:.2f} MB written and read, not in the "
              f"bound; dv tile {c['tile_v']}), plain "
              f"{c['plain_ms'] * 1e3:.2f} us (kernel / plain "
              f"{c['ms'] / c['plain_ms']:.2f}x), library none, max abs err "
              f"{c['max_abs_err']:.3e}")
    main = cases[0]
    return dict(name="ssm_chunk_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssm_scan.cu",
                replaces="src/repro/kernels/ssm_scan.py:73",
                **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms", "shape", "scores_ms",
                                        "bound_share",
                                        "bound_ms_chunked_form")},
                max_abs_err_all=max(c["max_abs_err"] for c in cases),
                cases=[{k: c[k] for k in _SSM_KEYS} for c in cases[1:]])


def phase_cross_device_slot(dev):
    """The slot backend on the CPU and on the card, same float32 weights
    and stream (12 requests over 8 slots: a full-batch wave, then a
    compact one): stats and generations equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import make_policy
    from repro_torch.launch.serve import submit_requests
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine
    out = []
    for arch, kw in (("granite-8b", {}), ("granite-8b", {"prefill_chunk": 32}),
                     ("zamba2-1.2b", {}), ("xlstm-350m", {})):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        p_cpu = init_params(cfg, 0, device="cpu")
        p_dev = _tree_to(p_cpu, dev)
        ec = EngineConfig(n_workers=2, slots_per_worker=4, max_seq_len=256,
                          cache_backend="slot", **kw)
        runs = []
        for params, d in ((p_cpu, "cpu"), (p_dev, dev)):
            eng = ServingEngine(cfg, params, ec, make_policy("bfio_h8"),
                                device=d)
            reqs = submit_requests(eng, 12, 8, seed=5)
            stats = eng.run()
            runs.append((stats, [r.generated for r in reqs]))
        what = f"{cfg.name}" + (" chunked" if kw else "")
        check(runs[0][0] == runs[1][0],
              f"cross-device slot {what}: engine stats differ "
              f"{runs[0][0]} vs {runs[1][0]}")
        check(runs[0][1] == runs[1][1],
              f"cross-device slot {what}: generations on the card differ "
              f"from the CPU plain path")
        out.append((what, runs[1][0]["tokens"]))
    return out


def _stack_counts(cfg) -> dict:
    """Per-token kernel sites of one forward pass: attention applications
    (K3 in decode), scan blocks (K5 in prefill) and RMS norms (K2)."""
    from repro_torch.models import layer_pattern
    n = {"attn": 0, "scan": 0, "norm": 1}          # final norm
    for _, kind, k in layer_pattern(cfg):
        n["norm"] += 2 * k
        if kind in ("attn", "shared_attn"):
            n["attn"] += k
        elif kind in ("mamba", "mlstm"):
            n["scan"] += k
    return n


def phase_slot_path(arch: str, n_requests: int) -> dict:
    """One full-width slot path through the launcher; returns the five
    kernels' launch counts of the run."""
    import repro_torch.serving.engine as engine_mod
    from repro_torch.launch.serve import build_parser, make_engine, serve
    args = build_parser().parse_args(
        ["--arch", arch, "--policy", "bfio_h8", "--cache-backend", "slot",
         "--workers", "4", "--slots", "8", "--requests", str(n_requests),
         "--max-new", "16", "--seed", "0"])
    _free()
    base = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = make_engine(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefills = [0]
    inner = engine_mod.prefill_fn

    def counted(*a, **kw):
        prefills[0] += 1
        return inner(*a, **kw)
    engine_mod.prefill_fn = counted
    launches = _zero_and_read(None)
    try:
        out = serve(args, eng)
    finally:
        engine_mod.prefill_fn = inner
    launches = _zero_and_read(launches)
    stats, meas, reqs = out["stats"], out["measured"], out["requests"]
    cfg = eng.cfg
    what = f"slot path {cfg.name}"
    check(all(r.done and not r.failed for r in reqs),
          f"{what}: not every request finished")
    check(all(len(r.generated) == args.max_new for r in reqs),
          f"{what}: a request generated the wrong number of tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"{what}: token id out of range")
    n_dec, n_pre = meas["decoded_steps"], prefills[0]
    sites = _stack_counts(cfg)
    check(n_dec > 0 and n_pre > 0, f"{what}: no decode or no prefill ran")
    need = {"rms_norm": sites["norm"] * n_dec,
            "decode_attention": sites["attn"] * n_dec,
            "ssm_chunk_scan": sites["scan"] * n_pre}
    for name, lo in need.items():
        check(launches[name] >= lo,
              f"{what}: {name} launched {launches[name]} times, need >= "
              f"{lo}")
        check(lo == 0 or launches[name] > 0,
              f"{what}: {name} never launched")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{what}: {cfg.name} ({cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.dtype}), init {init_s:.2f} s; {len(reqs)} requests, "
          f"{stats['tokens']} tokens, {meas['steps']} steps ({n_dec} with "
          f"decode), {n_pre} prefill calls; launches {launches}")
    print(f"{what} MEASURED on {meas['device']}: wall {meas['wall_s']:.3f} "
          f"s, decode step {meas['decode_step_ms']:.2f} ms (mean of "
          f"{meas['decode_phase_steps']} decode-only steps), "
          f"{meas['tokens_per_s']:.1f} tok/s, peak memory {peak:.2f} GB "
          f"({base:.2f} GB held when the path started)")
    print(f"{what} MODELLED (engine stats, A100 power model): time "
          f"{stats['time_s']:.4f} s, {stats['throughput_tok_s']:.1f} tok/s,"
          f" energy {stats['energy_j']:.2f} J, avg imbalance "
          f"{stats['avg_imbalance']:.2f}")
    del eng, out, reqs
    _free()
    return launches


def phase_paged_path(arch: str, what: str) -> dict:
    """One full-width paged engine path through the launcher: ``arch`` at
    full depth in bf16 with seeded random weights, ``bfio_h8``, 4 workers
    x 8 slots, 32 requests of 16 new tokens.  Counters zeroed just before
    and read just after; K1 and K2 must run on every decode step.  Prints
    init seconds, the peak device memory from the start of the path, the
    mean decode-step ms and the launches; frees the engine and its
    weights before it returns the launch counts."""
    from repro_torch.launch.serve import build_parser, make_engine, serve
    args = build_parser().parse_args(
        ["--arch", arch, "--policy", "bfio_h8", "--cache-backend",
         "paged", "--workers", "4", "--slots", "8", "--requests", "32",
         "--max-new", "16", "--seed", "0"])
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = make_engine(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    launches = _zero_and_read(None)
    out = serve(args, eng)
    launches = _zero_and_read(launches)
    stats, meas, reqs = out["stats"], out["measured"], out["requests"]
    cfg = eng.cfg
    check(all(r.done and not r.failed for r in reqs),
          f"{what}: not every request finished")
    check(all(len(r.generated) == args.max_new for r in reqs),
          f"{what}: a request generated the wrong number of tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs
              for t in r.generated), f"{what}: token id out of range")
    n_dec = meas["decoded_steps"]
    L = cfg.n_layers
    check(n_dec > 0, f"{what}: no decode step ran")
    check(launches["rms_norm"] >= (2 * L + 1) * n_dec,
          f"{what}: rms_norm kernel launched {launches['rms_norm']} "
          f"times, need >= {(2 * L + 1) * n_dec}")
    check(launches["paged_decode_attention"] >= L * n_dec,
          f"{what}: paged attention kernel launched "
          f"{launches['paged_decode_attention']} times, need >= "
          f"{L * n_dec}")
    check(launches["rms_norm"] > 0 and launches["paged_decode_attention"] > 0,
          f"{what}: a kernel of the path never launched")
    peak = torch.cuda.max_memory_allocated() / 1e9
    moe = (f", {cfg.n_experts} experts top-{cfg.experts_per_token} of "
           f"width {cfg.moe_d_ff}" if cfg.is_moe else "")
    print(f"{what}: {cfg.name} ({L} layers, d={cfg.d_model}{moe}, "
          f"{cfg.dtype}, {cfg.n_params() / 1e9:.2f} B parameters), init "
          f"{init_s:.2f} s, {weights_gb:.2f} GB on the card after init; "
          f"{len(reqs)} requests, {stats['tokens']} tokens, {meas['steps']} "
          f"steps ({n_dec} with decode); launches {launches}")
    print(f"{what} MEASURED on {meas['device']}: wall "
          f"{meas['wall_s']:.3f} s, decode step {meas['decode_step_ms']:.2f}"
          f" ms (mean of {meas['decode_phase_steps']} decode-only steps), "
          f"{meas['tokens_per_s']:.1f} tok/s, peak memory {peak:.2f} GB")
    print(f"{what} MODELLED (engine stats, A100 power model): "
          f"time {stats['time_s']:.4f} s, {stats['throughput_tok_s']:.1f} "
          f"tok/s, energy {stats['energy_j']:.2f} J, avg imbalance "
          f"{stats['avg_imbalance']:.2f}")
    del eng, out, reqs
    _free()
    return launches


def _moe_inputs(T, S, d, E, f, k, *, seed):
    """float32 MoE inputs at the given widths (init scales), each token's
    k-th and (k+1)-th router probabilities at least 1e-5 apart: a token
    nearer a tie is drawn again, so both devices pick the same experts."""
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(seed)
    p = {"router": torch.randn((d, E), generator=g) / d ** 0.5,
         "w1": torch.randn((E, d, f), generator=g) / d ** 0.5,
         "w3": torch.randn((E, d, f), generator=g) / d ** 0.5,
         "w2": torch.randn((E, f, d), generator=g) / f ** 0.5}
    x = torch.randn((T, S, d), generator=g)
    for _ in range(20):
        probs, _, _ = moe.router_topk(x, p["router"], k)
        top = torch.sort(probs, dim=-1, descending=True).values
        near = (top[..., k - 1] - top[..., k]) < 1e-5
        if not near.any():
            return x, p
        x[near] = torch.randn((int(near.sum()), d), generator=g)
    fail("moe_ffn check: could not draw inputs free of top-k near ties")


def phase_cross_device_moe(dev):
    """MoE on the CPU and on the card, float32: ``moe_ffn`` at
    qwen3-moe-30b-a3b's widths (d=2048, 128 experts top-8 of width 768)
    at a decode shape (32 rows) and a prefill shape (4 x 64) within 1e-4;
    then granite-moe-3b-a800m and qwen3-moe-30b-a3b in their smoke sizes
    served on the slot backend and on the paged backend with chunked
    prefill, with the same weights and stream.  Engine stats must be
    equal; generations are counted, not held (expert capacity couples a
    batch's rows, so a router near tie can move a token's experts)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import make_policy
    from repro_torch.launch.serve import submit_requests
    from repro_torch.models import init_params, moe
    from repro_torch.serving import EngineConfig, ServingEngine
    ffn = []
    for T, S, seed in ((32, 1, 41), (4, 64, 42)):
        x, p = _moe_inputs(T, S, 2048, 128, 768, 8, seed=seed)
        want, _ = moe.moe_ffn(x, p, n_experts=128, k=8)
        got, _ = moe.moe_ffn(x.to(dev), _tree_to(p, dev), n_experts=128,
                             k=8)
        err = compare(f"moe_ffn ({T}, {S}) card against CPU", got.cpu(),
                      want, dict(atol=1e-4, rtol=1e-4))
        ffn.append((f"({T}, {S}, 2048)", err))
        del x, p, want, got
    engines = []
    for arch in ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        p_cpu = init_params(cfg, 0, device="cpu")
        p_dev = _tree_to(p_cpu, dev)
        for backend, kw in (("slot", {}), ("paged", {"prefill_chunk": 32})):
            ec = EngineConfig(n_workers=2, slots_per_worker=4,
                              max_seq_len=256, cache_backend=backend, **kw)
            runs = []
            for params, d in ((p_cpu, "cpu"), (p_dev, dev)):
                eng = ServingEngine(cfg, params, ec, make_policy("bfio_h8"),
                                    device=d)
                reqs = submit_requests(eng, 12, 8, seed=5)
                stats = eng.run()
                runs.append((stats, [r.generated for r in reqs]))
            what = f"{cfg.name} {backend}" + (" chunked" if kw else "")
            check(runs[0][0] == runs[1][0],
                  f"cross-device moe {what}: engine stats differ "
                  f"{runs[0][0]} vs {runs[1][0]}")
            differ = sum(a != b for ga, gb in zip(runs[0][1], runs[1][1])
                         for a, b in zip(ga, gb))
            engines.append((what, runs[1][0]["tokens"], differ))
    return ffn, engines


def _long_prompts(vocab_size: int, n: int, max_new: int, seed: int) -> list:
    """Prompts of 129..200 tokens: a prefill pad of 256, where the models'
    scans run at their chunk of 128."""
    from repro_torch.serving import ServeRequest
    rng = np.random.default_rng(seed)
    return [ServeRequest(rid=i, tokens=rng.integers(
        1, vocab_size, size=int(rng.integers(129, 201))),
        max_new_tokens=max_new) for i in range(n)]


def phase_cross_device_long_prompts(dev):
    """zamba2-1.2b and xlstm-350m (smoke sizes, float32) on the slot
    backend with prompts over 128 tokens (``prefill_pad`` 256,
    ``max_seq_len`` 256), on the CPU and on the card: stats and
    generations equal, and the card's scans ran at chunk 128."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import make_policy
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine
    chunks = []
    inner = ops._ssm_chunk_scan

    def recorded(q, *a, chunk, **kw):
        if q.is_cuda:
            chunks.append(chunk)
        return inner(q, *a, chunk=chunk, **kw)
    out = []
    for arch in ("zamba2-1.2b", "xlstm-350m"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        p_cpu = init_params(cfg, 0, device="cpu")
        p_dev = _tree_to(p_cpu, dev)
        ec = EngineConfig(n_workers=2, slots_per_worker=4, max_seq_len=256,
                          prefill_pad=256, cache_backend="slot")
        runs = []
        for params, d in ((p_cpu, "cpu"), (p_dev, dev)):
            eng = ServingEngine(cfg, params, ec, make_policy("bfio_h8"),
                                device=d)
            reqs = _long_prompts(cfg.vocab_size, 12, 8, seed=6)
            for r in reqs:
                eng.submit(r)
            del chunks[:]
            ops._ssm_chunk_scan = recorded
            try:
                stats = eng.run()
            finally:
                ops._ssm_chunk_scan = inner
            runs.append((stats, [r.generated for r in reqs]))
        check(runs[0][0] == runs[1][0],
              f"cross-device long prompts {cfg.name}: engine stats differ "
              f"{runs[0][0]} vs {runs[1][0]}")
        check(runs[0][1] == runs[1][1],
              f"cross-device long prompts {cfg.name}: generations on the "
              f"card differ from the CPU plain path")
        check(128 in chunks, f"cross-device long prompts {cfg.name}: no "
              f"scan ran at chunk 128 on the card (chunks {sorted(set(chunks))})")
        out.append((cfg.name, runs[1][0]["tokens"], len(chunks)))
    return out


def _free() -> None:
    """Release a finished path's device memory: the wrapped ``decode``
    methods of the fleet's counting hook form reference cycles, so
    collect them before emptying the allocator's cache."""
    gc.collect()
    torch.cuda.empty_cache()


def _wrappers() -> dict:
    """The five kernel wrappers, each with its ``launches`` counter."""
    from repro_torch.kernels import bfio_swap as bs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rms_norm as rk
    from repro_torch.kernels import ssm_scan as ss
    return {"rms_norm": rk.rms_norm,
            "paged_decode_attention": pa.paged_decode_attention,
            "bfio_swap": bs.swap_best,
            "decode_attention": da.decode_attention,
            "ssm_chunk_scan": ss.ssm_chunk_scan}


def _zero_and_read(before):
    """``before is None``: zero every launch counter (just before a path).
    Otherwise return the counts since (just after it)."""
    ws = _wrappers()
    if before is None:
        for w in ws.values():
            w.launches = 0
        return {}
    return {name: w.launches for name, w in ws.items()}


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
    t0 = time.perf_counter()
    build.build_all(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{len(build.SOURCES)} sources (nvcc, sm_90a)")
    for src, log in build.BUILD_INFO["ptxas"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}")

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    kernels = [phase_rms_norm(dev)]
    # the timing method's floor: a one-element add timed as the kernels are
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: one.add_(1), flush=flush)
    print(f"timing floor: a one-element add measures {floor_ms * 1e3:.2f} "
          f"us by time_ms (sleep kernel, L2 flush, CUDA events)")
    for phase in (phase_paged_attention, phase_decode_attention):
        kernels.append(dict(phase(dev, flush), timing_floor_ms=floor_ms))
    kernels.append(dict(phase_ssm_scan(dev, flush),
                        timing_floor_ms=floor_ms))
    del flush

    kernels.append(dict(phase_bfio_swap(dev), timing_floor_ms=floor_ms))

    toks = phase_cross_device(dev)
    print(f"cross-device: granite-8b-smoke f32, {toks} tokens, stats and "
          f"generations equal on cpu and {torch.cuda.get_device_name(0)}")
    for what, toks, rows, handoffs in phase_cross_device_fleet(dev):
        print(f"cross-device fleet {what}: granite-8b-smoke f32, R=4, "
              f"{toks} tokens, {rows} telemetry steps, {handoffs} drain "
              f"handoffs; stats, telemetry and generations equal on cpu "
              f"and the card")
    for what, toks in phase_cross_device_slot(dev):
        print(f"cross-device slot: {what} f32, {toks} tokens, stats and "
              f"generations equal on cpu and the card")
    for name, toks, n_scan in phase_cross_device_long_prompts(dev):
        print(f"cross-device long prompts: {name} f32 on the slot backend, "
              f"prompts of 129..200 tokens at prefill pad 256, {toks} "
              f"tokens, {n_scan} scans on the card at chunk 128; stats and "
              f"generations equal on cpu and the card")
    ffn, engines = phase_cross_device_moe(dev)
    for shape, err in ffn:
        print(f"cross-device moe: moe_ffn {shape} f32 at qwen3-moe-30b-a3b's "
              f"widths, card against cpu max abs err {err:.3e} (<= 1e-4)")
    for what, toks, differ in engines:
        print(f"cross-device moe: {what} f32, {toks} tokens, stats equal on "
              f"cpu and the card; {differ} generated tokens differ")

    paths = {"engine": phase_paged_path("granite-8b", "main path")}
    paths["moe"] = phase_paged_path("qwen3-moe-30b-a3b", "moe path")
    paths.update({"fleet": phase_fleet_path(),
                  "slot_granite": phase_slot_path("granite-8b", 32),
                  "slot_zamba2": phase_slot_path("zamba2-1.2b", 32),
                  "slot_xlstm": phase_slot_path("xlstm-350m", 8)})

    rows = []
    for k in kernels:
        row = {key: k[key] for key in (
            "name", "route", "source", "replaces")}
        by_path = {p: counts[k["name"]] for p, counts in paths.items()}
        row["launches"] = sum(by_path.values())
        row.update({key: k[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
        row["launches_by_path"] = by_path
        row["matched"] = True
        row.update({key: k[key] for key in (
            "kernel_only_ms", "scores_ms", "bound_share",
            "bound_ms_chunked_form", "at_pod_scale",
            "shape", "max_abs_err_all", "cases", "timing_floor_ms")
            if key in k})
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
