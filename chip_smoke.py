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
   widths 6144, 8192 and 384, each plain and with the residual add fused (its
   sum PyTorch's, its norm bit-identical to the kernel's norm of that
   sum), also timed back to back from a CUDA graph, beside ``F.rms_norm``
   (after ``x + r`` for the fused call); K2's backward (``rms_norm_bwd``)
   at the train path's (8192, 4096) in bf16, plain and fused (the
   gradient of the sum added), and in float32, and at (32, 4096), against
   its plain version (dx at 2e-2, dscale within 1e-3 of its largest entry,
   the same bits on a second call), timed beside its byte bound and
   autograd's backward of ``F.rms_norm``; the paged decode-attention kernel
   (K1) at B=32, Hq=32, Hkv=8, hd=128, block 16, 16 blocks per row (bf16
   pool, permuted tables, ragged lengths including 1 and 256), at
   granite-34b's head layout (Hq=48 over one KV head) and at the vlm
   path's rows (B=8, lengths 2,944..3,008 over 188 blocks); the contiguous
   decode-attention kernel (K3) at granite-8b's slot shape (B=32, Hq=32,
   Hkv=8, hd=128, L=256), zamba2's (Hq=Hkv=32, hd=64), granite-34b's head
   layout and whisper-tiny's (Hq=Hkv=6, hd=64), with a rolling case
   (lengths past L) and a
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
   times its scores pass alone and prints its share of the bound.  K5's
   backward (``ssm_chunk_scan_bwd``) at zamba2's train shape (B=2,
   S=4096, H=32, dk=64, dv=128, chunk 128), at xlstm's widths (H=4,
   dk=512, dv=513) at chunk 128, from an initial state with a gradient
   of the final state, and at a ragged S padded to the chunk, float32:
   against its plain version and both against autograd of the plain
   forward, every gradient within 1e-3 of its largest entry (each
   gradient's error printed), the same bits on a second call, timed
   beside its bound (library: none).  The
   BF-IO swap-search kernel (K4) at the fleet router's shape (C=1, G=4,
   N=64, W=1, integer loads), at pod scale (C=8, G=32, N=512, W=9,
   random floats, ragged ``valid``, ``assign`` with -1s) and at
   ``pod_bfio_p2``'s two pods of two workers with tied loads, and at the
   device-loop path's shape (C=1, G=32, N=1024, W=1) on the inputs its
   first step gives the kernel (recorded from a run of that step), held
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
   stats equal, differing generated tokens counted.  The vlm and audio
   families: llava-next-mistral-7b-smoke on the paged and the slot
   backend, whisper-tiny-smoke on the slot backend in vec and in ref
   mode (the engine's zero patch and frame stubs): stats and generations
   equal, and the card's audio vec engine equal to its ref engine in
   stats, generations and workers.  The device loop
   (``serving/device_loop.py``) at the reference demo's configuration
   (G=8, B=8, wait_cap 256, 128 integer-sized requests, 64 steps) as is,
   with ``prefill_budget=16.0`` and with ``kv_pool=150.0``: every
   ``LoopState`` field equal on the CPU (plain swap search) and the card
   (K4).  The per-slot reference engine (``engine_mode="ref"``):
   granite-8b-smoke and zamba2-1.2b-smoke on the slot backend, stats and
   generations equal on the CPU and the card, and the card's ref engine
   equal to its vec engine in stats, generations and workers.  Training
   (granite-8b-smoke, float32 weights and compute): one step's gradients
   on the CPU and the card within 1e-4, five steps of ``train`` with the
   same batches (loss histories within 1e-5 relative, parameters within
   1e-4), the CPU's checkpoint after four steps resumed on the card to the
   CPU's fifth loss, and ``python -m repro_torch.launch.train --arch
   granite-8b --smoke --steps 4`` on the card.  Training's gradient for
   zamba2-1.2b-smoke and xlstm-350m-smoke (float32, 4 x 160 tokens, K5
   at chunk 128): the card's (K5 and its backward) within 1e-4 of each
   leaf's largest entry of the card's with K5's plain version, and of the
   CPU's beyond that control's own distance from it; K5's backward
   launched.
5. The single-engine path: ``repro_torch.launch.serve`` on full
   granite-8b (36 layers, bf16, seeded random weights), paged backend,
   bfio_h8, 4 workers x 8 slots, 32 requests of 16 new tokens.  Launch
   counters are zeroed just before and read just after; K1 and K2 must
   have run on every decode step.  The engine is freed afterwards.  Then
   the MoE path the same way: full qwen3-moe-30b-a3b (48 layers, d=2048,
   128 experts top-8, bf16, 30.5 B parameters), with its init seconds,
   peak device memory and mean decode-step ms; its weights are freed
   before the next phase.  Then the vlm path: full llava-next-mistral-7b
   (32 layers, d=4096, 32/8 heads of 128, bf16, with the projector), the
   launcher's ``EngineConfig`` with ``max_seq_len=3072`` (its 256 cannot
   hold the image), G=4 x B=2 slots, 16 requests of 16 new tokens, each
   prompt the image's 2,880 patch positions (the zero stub) and 4..63
   text tokens: K1 on each of its 32 layers and K2 on each of its 65
   norms a decode step, at rows of about 2,900-2,960 tokens.
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
   call, K2 on every norm), whisper-tiny (32 requests; K3 on each of its
   4 decoder layers and K2 on its 13 norms, cross norms included, a
   decode step, and the encoder's 9 norms a prefill call; the encoder
   and the cross attention are plain PyTorch), then granite-8b again
   through the per-slot
   reference engine (the launcher's ``EngineConfig`` with
   ``engine_mode="ref"``: every decode step over all 32 slots; K3 and K2
   as above).  Counters zeroed just before and read just
   after each; each engine is freed before the next.
   The mesh path (``phase_mesh_path``): a one-rank process group (NCCL
   for the card, gloo for the CPU) and a (1, 1) ("data", "model") mesh.
   ``decode_attention_lsharded`` against K3 on the same inputs; full
   granite-8b (seeded bf16), ``prefill_fn`` on the launcher's 32 prompts
   at ``max_len`` 256 and 8 ``decode_fn`` steps, ``mesh=None`` and under
   the mesh with ``kv_shard="none"`` (bit for bit) and ``"length"``
   (within 2e-2 of the largest logit), counters zeroed just before the
   two mesh runs and read just after (K2 and K3 on every layer); one
   full qwen3-moe-30b-a3b ``moe_ffn`` under the mesh bit-identical to
   ``mesh=None``; granite-8b-smoke and qwen3-moe-30b-a3b-smoke on a gloo
   CPU mesh against the NCCL card mesh; two dry-run pairs
   (``launch/dryrun.py``, granite-8b x decode_32k with ``--decode-opt``
   and qwen3-moe-30b-a3b x decode_32k) and the roofline over their
   records, as subprocesses, their numbers modelled.
8. The device-loop path: ``make_device_serving_loop`` at G=32 x B=16,
   wait_cap 1024, 1,024 requests (the demo's bimodal mix scaled by 8),
   in chunks of 16 steps until it drains (at most 400).  Every request
   completes with no preemption, K4 launches ``swap_iters`` (4) times a
   step, and PyTorch's sync debug mode sees no host read inside a step
   (it is shown to see a known one first).  Prints the mean ms a step,
   the device kernels of one profiled step and the average imbalance.
9. The train path: ``repro_torch.training.train`` on full-width
   granite-8b cut to 8 of its 36 layers (float32 masters, bf16 compute,
   AdamW, remat a layer), batch 2 x 4096, 4 steps of ``token_batches``.
   One gradient first: every parameter leaf finite and nonzero.  Counters
   zeroed just before the training and read just after: K2 and its
   backward at least 17 launches a step each.  Prints each step's loss,
   the mean step ms, the peak memory and the model FLOPs' share of 989
   TFLOP/s.
10. The hybrid train path: ``train`` on full zamba2-1.2b (not cut: 32
   Mamba2 blocks, 6 shared-attention applications, 1.01 B parameters),
   batch 2 x 4096, 4 steps, remat, the launcher's AdamW.  One gradient
   first: every leaf finite, and nonzero wherever the smoke config's CPU
   gradient is nonzero for a leaf of its kind.  Counters zeroed just
   before and read just after: K5 at least 64 and its backward at least
   32 launches a step, K2 and its backward on every norm.  Prints the
   mean step ms, the peak memory and the model FLOPs' share.
11. The mesh train path: full-width granite-8b cut to 2 layers under the
   (1, 1) NCCL mesh, placed by ``param_shardings(mode="train")``; one
   step of ``make_train_step(mesh=..., grad_shardings=...,
   act_spec=...)`` against ``mesh=None`` on the same weights and batch
   (2 x 4096): loss, parameters, m and v bit for bit, K2 and its backward
   on the shards, each step's ms printed; then ``python -m
   repro_torch.launch.train --arch granite-8b --smoke --steps 2`` on the
   card under its (1, 1) mesh, as a subprocess.

``python3 chip_smoke.py --phase NAME ...`` runs one or more of ``mesh``,
``ssm``, ``ssm_bwd``, ``cross_train_ssm``, ``train_zamba2`` and
``mesh_train`` alone after the build (no result line).

The second-to-last line is ``{"kernels": [...]}`` (each kernel's launches
by path under ``launches_by_path``: engine, moe, vlm, fleet, the four
slot paths, ``slot_granite_ref``, ``mesh``, ``device_loop``, ``train``,
``train_zamba2`` and ``mesh_train``; the serving paths must launch no
``rms_norm_bwd`` and no ``ssm_chunk_scan_bwd``); the last line is
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
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12        # bf16 on the tensor cores, dense
TOL = dict(atol=2e-2, rtol=2e-2)
# the device-loop path: workers, slots a worker, wait-buffer entries
LOOP_G, LOOP_B, LOOP_W = 32, 16, 1024
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
    prefill shape (2048, 4096), at granite-34b's and qwen2-72b's widths
    (6144, 8192) and at whisper-tiny's (384) at 32 rows, each plain and
    with the residual add fused."""
    cases = []
    for R, d, seed in ((32, 4096, 1), (2048, 4096, 3), (32, 6144, 4),
                       (32, 8192, 5), (32, 384, 6)):
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


def _norm_bwd_case(dev, R, d, dtype, *, fused, seed):
    """K2's backward on one case against its plain version: dx within the
    K2 tolerance, dscale within 1e-3 of its largest entry (float32 sums
    in another order), and the same bits on a second call.  Timed beside
    its byte bound, its plain version and autograd's backward of
    ``F.rms_norm`` (the graph built once; for the fused call of ``x + r``
    then ``F.rms_norm``, the gradient of s added)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rms_norm as rk
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    x, gy, gs = rnd(R, d), rnd(R, d), rnd(R, d) if fused else None
    sc = torch.randn((d,), generator=g, device=dev)

    def fn():
        return rk.rms_norm_bwd(x, gy, sc, 1e-5, gs)

    def plain():
        return rk.rms_norm_bwd_plain(x, gy, sc, 1e-5, gs)

    what = (f"rms_norm_bwd ({R}, {d}) {str(dtype)[6:]}"
            f"{' fused' if fused else ''}")
    (dx, dsc), (dx2, dsc2), (wdx, wdsc) = fn(), fn(), plain()
    err = compare(what + " dx", dx, wdx)
    torch.cuda.synchronize()
    sc_err = float((dsc - wdsc).abs().max()) / float(wdsc.abs().max())
    check(sc_err <= 1e-3, f"{what}: dscale off by {sc_err:.3e} of its "
                          f"largest entry")
    check(torch.equal(dx, dx2) and torch.equal(dsc, dsc2),
          f"{what}: two calls on the same inputs differ")
    xl = x.detach().clone().requires_grad_(True)
    wl = sc.to(dtype).requires_grad_(True)
    s = xl
    if fused:
        rl = torch.zeros_like(x, requires_grad=True)
        s = xl + rl
    out = F.rms_norm(s, (d,), weight=wl, eps=1e-5)
    outs, grads = ((out, s), (gy, gs)) if fused else ((out,), (gy,))

    def lib():
        return torch.autograd.grad(outs, (xl, wl), grads, retain_graph=True)
    es = x.element_size()
    nbytes = (4 if fused else 3) * R * d * es + 2 * d * 4
    flops = (12.0 if fused else 11.0) * R * d
    b_ms, b_by = bound(nbytes, flops)
    return dict(max_abs_err=err, dscale_rel_err=sc_err, ms=time_ms(fn),
                plain_ms=time_ms(plain), library_ms=time_ms(lib),
                bound_ms=b_ms, bound_by=b_by,
                shape=f"x, g{', gs' if fused else ''} ({R}, {d}) "
                      f"{str(dtype)[6:]}, scale ({d},) f32")


_NORM_BWD_KEYS = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms", "max_abs_err", "dscale_rel_err")


def phase_rms_norm_bwd(dev):
    """K2's backward at the train path's shape (8192, 4096) bf16 (the
    row's numbers), plain and fused, and in float32; at a decode-sized
    (32, 4096), plain and fused."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [_norm_bwd_case(dev, R, 4096, dt, fused=fu, seed=40 + i)
             for i, (R, dt, fu) in enumerate(
                 ((8192, bf, False), (8192, bf, True), (8192, f32, False),
                  (32, bf, False), (32, bf, True), (32, f32, False)))]
    for c in cases:
        print(f"kernel rms_norm_bwd [{c['shape']}]: {c['ms'] * 1e3:.2f} us "
              f"(bound {c['bound_ms'] * 1e3:.3f} us by {c['bound_by']}, "
              f"{c['bound_ms'] / c['ms']:.1%} of it), plain "
              f"{c['plain_ms'] * 1e3:.2f} us, autograd of F.rms_norm "
              f"{c['library_ms'] * 1e3:.2f} us (kernel / library "
              f"{c['ms'] / c['library_ms']:.2f}x); dx max abs err "
              f"{c['max_abs_err']:.3e}, dscale {c['dscale_rel_err']:.3e} of "
              f"its largest entry")
    main = cases[0]
    return dict(name="rms_norm_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/rms_norm.cu",
                replaces="src/repro/kernels/rms_norm.py:28",
                backward_of="rms_norm",
                **{k: main[k] for k in _NORM_BWD_KEYS},
                max_abs_err_all=max(c["max_abs_err"] for c in cases),
                cases=[{k: c[k] for k in _NORM_BWD_KEYS} for c in cases[1:]])


def _paged_case(dev, flush, B, Hq, Hkv, hd, bs, mb, *, seed, lo=1):
    """K1 on one bf16 case (permuted tables, ragged lengths from ``lo`` to
    ``mb * bs``, both ends included): against plain, timed whole and split
    pass alone beside its byte bound, the plain version and SDPA over the
    gathered contiguous view (the gather untimed)."""
    from repro_torch.kernels import paged_attention as pa
    n_pool = B * mb
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, mb * bs + 1, size=B).astype(np.int32)
    lens[0], lens[1] = lo, mb * bs
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
    16, 16 blocks a row: the row's numbers), at granite-34b's head layout
    (Hq=48 over one KV head) and at the vlm path's rows (B=8, lengths
    2,944..3,008: 188 blocks, 47 of the kernel's 64-token splits)."""
    cases = [_paged_case(dev, flush, 32, 32, 8, 128, 16, 16, seed=2),
             _paged_case(dev, flush, 32, 48, 1, 128, 16, 16, seed=4),
             _paged_case(dev, flush, 8, 32, 8, 128, 16, 188, seed=6,
                         lo=2944)]
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


def _loop_swap_inputs() -> tuple:
    """K4's inputs at the device-loop path's shape, as that path's first
    step gives them: the first swap search of step 1 (C=1, G=32, N=1024,
    W=1; every wait entry valid, 512 of them placed by the greedy
    phase), recorded from a run of that step."""
    import repro_torch.core.balancer_jax as bj
    from repro_torch.serving import init_loop_state, make_device_serving_loop
    sizes, rem = _loop_stream(192, 832, 0, integer=False)
    run = make_device_serving_loop(LOOP_G, LOOP_B, LOOP_W, swap_iters=1)
    seen, inner = [], bj.swap_best

    def record(*args):
        seen.append(tuple(a.clone() for a in args))
        return inner(*args)
    bj.swap_best = record
    try:
        run(init_loop_state(LOOP_G, LOOP_B, sizes, rem, LOOP_W), 1)
    finally:
        bj.swap_best = inner
    check(len(seen) == 1, f"device loop's first step ran {len(seen)} swap "
          f"searches at swap_iters 1")
    return seen[0]


# the runtime calls that put an operation on the device
_ISSUE_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def _issued_ops(fn) -> dict:
    """One profiled call of ``fn``, counted two ways: ``issued``, the
    device operations (kernels, copies, sets) by the profiler's records of
    the host's runtime calls that issue them (``by_api`` splits them by
    call), and ``recorded``, the operations the device's own records
    show (``k4_recorded`` of them the swap kernel's).  Over a call of
    ~39,000 launches the device's records have come back short, by a
    different number on each trace of the same step, while the host's
    records were the same on every trace: so ``issued`` is the count,
    and ``recorded`` only says what the trace kept."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    on_dev = [e.name() for e in events if e.device_type() == cuda]
    by_api = {}
    for e in events:
        if e.device_type() != cuda and e.name() in _ISSUE_APIS:
            by_api[e.name()] = by_api.get(e.name(), 0) + 1
    return dict(issued=sum(by_api.values()), by_api=by_api,
                recorded=len(on_dev),
                k4_recorded=sum("swap_best_kernel" in n for n in on_dev))


def _swap_case(dev, C, G, N, W, *, args=None, label="", **kw):
    """K4 on one case (``args``: given inputs, else drawn by
    ``_swap_inputs``): bit-identical to the plain version and the dense
    oracle, one device kernel a call, timed beside its bound and the plain
    version."""
    from repro_torch.kernels import bfio_swap as bs
    if args is None:
        args = _swap_inputs(dev, C, G, N, W, **kw)
    check(tuple(args[1].shape) == (C, N, W) and args[0].shape[1] == G,
          f"bfio_swap: inputs of shape {tuple(args[1].shape)}, G "
          f"{args[0].shape[1]}, not C={C} G={G} N={N} W={W}")
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
                      + (", loads in {0, 1, 2}" if kw.get("ties") else "")
                      + label)


_SWAP_KEYS = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
              "feasible_pairs")


def phase_bfio_swap(dev):
    """K4 at the fleet router's shape (its power-of-two bucket of 64
    candidates, 24 real), at pod scale, at two pods of two workers with
    tied loads, and at the device-loop path's shape on its first step's
    inputs; bit-identical to plain and dense, one kernel a call."""
    fleet = _swap_case(dev, 1, 4, 64, 1, seed=11, n_valid=24)
    pod = _swap_case(dev, 8, 32, 512, 9, seed=12)
    ties = _swap_case(dev, 2, 2, 64, 3, seed=13, ties=True)
    loop = _swap_case(dev, 1, LOOP_G, LOOP_W, 1, args=_loop_swap_inputs(),
                      label=", the device loop's first step")
    for k in (fleet, pod, ties, loop):
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
                cases=[{k: c[k] for k in _SWAP_KEYS} for c in (ties, loop)])


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
    a rolling cache with lengths past L, a sliding window, granite-34b's
    head layout (Hq=48 over one KV head) and whisper-tiny's (Hq=Hkv=6,
    hd=64)."""
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
        _decode_case(dev, flush, 32, 6, 6, 64, 256, mode="causal",
                     seed=26),
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


def _ssm_bwd_case(dev, flush, B, S, H, dk, dv, chunk, *, seed,
                  init=False, dstate=False, pad_to=None, reps=20):
    """K5's backward on float32 inputs (the reference's fixture) against
    its plain version, and both against autograd of the plain forward, on
    the same inputs: every gradient within 1e-3 of its largest entry, the
    same bits on a second call.  ``pad_to``: S is ragged and padded with
    zero steps (no decay, no input) to ``pad_to``, as ``ops`` pads it, y's
    gradient zero there.  Timed beside its bound and its plain version."""
    import torch.nn.functional as F
    from repro_torch.kernels import ssm_scan as ss
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)
    Sp = pad_to or S
    pad = Sp - S

    def padseq(x):
        return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
    q, k = padseq(rnd(B, S, H, dk)), padseq(rnd(B, S, H, dk))
    v = padseq(rnd(B, S, H, dv))
    a = padseq(-rnd(B, S, H).abs())
    gi = padseq(rnd(B, S, H).abs())
    s0 = rnd(B, H, dk, dv, scale=0.1) if init else None
    dy = padseq(rnd(B, S, H, dv))
    ds = rnd(B, H, dk, dv) if dstate else None
    args = (q, k, v, a, gi, dy, ds)

    def fn():
        return ss.ssm_chunk_scan_bwd(*args, chunk=chunk, initial_state=s0)

    def plain():
        return ss.ssm_chunk_scan_bwd_plain(*args, chunk=chunk,
                                           initial_state=s0)
    got, again, want = fn(), fn(), plain()
    ins = [t.clone().requires_grad_(True) for t in (q, k, v, a, gi)]
    si = None if s0 is None else s0.clone().requires_grad_(True)
    y, st = ss.ssm_chunk_scan_plain(*ins, chunk=chunk, initial_state=si)
    loss = (y * dy).sum() + ((st * ds).sum() if dstate else 0.0)
    auto = torch.autograd.grad(loss, ins + ([si] if si is not None else []))
    del y, st, loss, ins
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "d(log_decay)", "d(gate)", "d(initial)")
    errs, abs_errs, auto_errs = {}, {}, {}
    for name, x, x2, w, au in zip(names, got, again, want,
                                  list(auto) + [None]):
        if w is None:
            continue
        check(torch.isfinite(x).all().item(), f"ssm_chunk_scan_bwd {name}: "
                                              f"non-finite")
        check(torch.equal(x, x2), f"ssm_chunk_scan_bwd {name}: two calls "
                                  f"on the same inputs differ")
        scale = max(float(w.abs().max()), 1e-30)
        abs_errs[name] = float((x - w).abs().max())
        errs[name] = abs_errs[name] / scale
        auto_errs[name] = max(float((x - au).abs().max()),
                              float((w - au).abs().max())) / scale
        check(errs[name] <= 1e-3 and auto_errs[name] <= 1e-3,
              f"ssm_chunk_scan_bwd {name}: kernel {errs[name]:.3e}, "
              f"against autograd {auto_errs[name]:.3e} of its largest "
              f"entry")
    ms = time_ms(fn, reps=reps, flush=flush)
    # the plain version's float32 GEMMs vary from call to call: at least
    # 10 repetitions
    plain_ms = time_ms(plain, reps=max(reps // 2, 10), flush=flush)
    # each pass alone, on the workspace of one full call
    passes = {name: time_ms(launch, reps=reps, flush=flush)
              for name, launch in ss.bwd_passes(*args, chunk=chunk,
                                                initial_state=s0)}
    # the device kernels of one call, as the profiler sees them (and the
    # add before it)
    bp = ss.plan(B, Sp, H, dk, dv, chunk, backward=True)
    names = device_kernels(fn)
    kernels = [n for n in names if "ssm_bwd" in n]
    check(len(kernels) == bp.launches and len(names) - len(kernels) <= 1,
          f"ssm_chunk_scan_bwd: a call ran {len(kernels)} of its device "
          f"kernels ({', '.join(names)}), its plan says {bp.launches}")
    # bytes: q, k, v, a, g, dy (and the initial state and the final
    # state's gradient) read once, every gradient written once.
    # operations (two flops a multiply-add), per (b, h) and chunk of C
    # steps (lower triangle t = C (C + 1) / 2): the scores and W v's
    # counterparts, q k^T and dy v^T, and dq, dk, dv's intra-chunk
    # products, t (3 dk + 2 dv); the state products, C dk dv each, only
    # where their state is nonzero: the carry recomputed (n - 1 chunks),
    # q . S_prev's gradient and dS's update (n - 1, + 1 with an initial
    # state), dk's and dv's carry terms (n - 1, + 1 with a final-state
    # gradient).
    n = Sp // chunk
    tri = chunk * (chunk + 1) // 2
    fma = B * H * (n * tri * (3 * dk + 2 * dv) + chunk * dk * dv * (
        (n - 1) + 2 * (n - 1 + int(init)) + 2 * (n - 1 + int(dstate))))
    nbytes = 4 * (B * Sp * H * (4 * dk + 4 * dv + 4)
                  + (2 if init else 0) * B * H * dk * dv
                  + (B * H * dk * dv if dstate else 0))
    b_ms, b_by = bound(nbytes, 2.0 * fma)
    return dict(max_abs_err=max(abs_errs.values()), rel_err=errs,
                autograd_rel_err=max(auto_errs.values()), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_share=b_ms / ms, library_ms=None, passes_ms=passes,
                launches_a_call=len(kernels),
                tiles=f"{bp.dk_tiles} dk x {bp.dv_tiles} dv",
                workspace_mb=(bp.record_bytes + bp.states_bytes
                              + bp.parts_bytes) / 1e6,
                shape=f"B={B} S={S}" + (f" (padded to {Sp})" if pad else "")
                      + f" H={H} dk={dk} dv={dv} chunk={chunk} f32"
                      + (", initial state" if init else "")
                      + (", final-state gradient" if dstate else ""))


def device_kernels(fn) -> list:
    """The names of the device kernels one call of ``fn`` runs, from the
    profiler (a trace that saw no device activity is taken again).  A
    trace can miss its first device kernel, so a one-element add runs
    first: the caller picks its own kernels out by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    one = torch.zeros(1, device="cuda")
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            one.add_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


_SSM_BWD_KEYS = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                 "bound_share", "library_ms", "max_abs_err", "rel_err",
                 "autograd_rel_err", "passes_ms", "launches_a_call", "tiles",
                 "workspace_mb")


def phase_ssm_scan_bwd(dev, flush):
    """K5's backward at zamba2-1.2b's train shape (B=2, S=4096, H=32,
    dk=64, dv=128, chunk 128; the row's numbers), at xlstm-350m's widths
    (H=4, dk=512, dv=513) at chunk 128, from an initial state with a
    final-state gradient, and at a ragged S padded to the chunk."""
    cases = [
        _ssm_bwd_case(dev, flush, 2, 4096, 32, 64, 128, 128, seed=51),
        _ssm_bwd_case(dev, flush, 2, 1024, 4, 512, 513, 128, seed=52,
                      reps=10),
        _ssm_bwd_case(dev, flush, 2, 512, 32, 64, 128, 128, seed=53,
                      init=True, dstate=True),
        _ssm_bwd_case(dev, flush, 2, 1000, 32, 64, 128, 128, seed=54,
                      pad_to=1024),
    ]
    for c in cases:
        errs = ", ".join(f"{k} {v:.2e}" for k, v in c["rel_err"].items())
        split = ", ".join(f"{k} {v * 1e3:.2f}"
                          for k, v in c["passes_ms"].items())
        print(f"kernel ssm_chunk_scan_bwd [{c['shape']}]: "
              f"{c['ms'] * 1e3:.2f} us (bound {c['bound_ms'] * 1e3:.2f} us "
              f"by {c['bound_by']}, {100 * c['bound_share']:.1f}% of it; "
              f"{c['launches_a_call']} launches a call; passes alone, us: "
              f"{split}; tiles {c['tiles']}, workspace "
              f"{c['workspace_mb']:.1f} MB), plain "
              f"{c['plain_ms'] * 1e3:.2f} us (kernel / plain "
              f"{c['ms'] / c['plain_ms']:.2f}x), library none; each "
              f"gradient against the plain version, of its largest entry: "
              f"{errs}; kernel and plain against autograd of the plain "
              f"forward within {c['autograd_rel_err']:.2e}")
    main = cases[0]
    return dict(name="ssm_chunk_scan_bwd", route="cuda",
                max_rel_err_all=max(max(c["rel_err"].values())
                                    for c in cases),
                source="src/repro_torch/kernels/csrc/ssm_scan.cu",
                replaces="src/repro/kernels/ssm_scan.py:73",
                backward_of="ssm_chunk_scan",
                **{k: main[k] for k in _SSM_BWD_KEYS},
                max_abs_err_all=max(c["max_abs_err"] for c in cases),
                cases=[{k: c[k] for k in _SSM_BWD_KEYS} for c in cases[1:]])


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


def phase_cross_device_frontends(dev):
    """The vlm and audio families on the CPU and on the card, same float32
    weights and stream (12 requests over 8 slots; the engine's zero patch
    and frame stubs): llava-next-mistral-7b-smoke on the paged and the
    slot backend, whisper-tiny-smoke on the slot backend in vec and in
    ref mode.  Stats and generations equal across devices, and the card's
    audio vec engine equal to its ref engine in stats, generations and
    workers."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import make_policy
    from repro_torch.launch.serve import submit_requests
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine
    out = []
    card = {}
    for arch, backend, mode in (
            ("llava-next-mistral-7b", "paged", "vec"),
            ("llava-next-mistral-7b", "slot", "vec"),
            ("whisper-tiny", "slot", "vec"),
            ("whisper-tiny", "slot", "ref")):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        p_cpu = init_params(cfg, 0, device="cpu")
        p_dev = _tree_to(p_cpu, dev)
        ec = EngineConfig(n_workers=2, slots_per_worker=4, max_seq_len=256,
                          cache_backend=backend, engine_mode=mode)
        runs = []
        for params, d in ((p_cpu, "cpu"), (p_dev, dev)):
            eng = ServingEngine(cfg, params, ec, make_policy("bfio_h8"),
                                device=d)
            reqs = submit_requests(eng, 12, 8, seed=5)
            stats = eng.run()
            runs.append((stats, [r.generated for r in reqs],
                         [r.worker for r in reqs]))
        what = f"{cfg.name} {backend} engine_mode={mode}"
        check(runs[0][0] == runs[1][0],
              f"cross-device {what}: engine stats differ {runs[0][0]} vs "
              f"{runs[1][0]}")
        check(runs[0][1] == runs[1][1],
              f"cross-device {what}: generations on the card differ from "
              f"the CPU plain path")
        card[(arch, backend, mode)] = runs[1]
        out.append((what, runs[1][0]["tokens"]))
    check(card[("whisper-tiny", "slot", "vec")]
          == card[("whisper-tiny", "slot", "ref")],
          "whisper-tiny-smoke on the card: the vec engine's stats, "
          "generations or workers differ from the ref engine's")
    return out


def _stack_counts(cfg) -> dict:
    """Per-token kernel sites of one forward pass: attention applications
    (K3 in decode), scan blocks (K5 in prefill) and RMS norms (K2), with
    audio's cross norm a decoder layer; ``enc_norm``: the audio encoder's
    norms, which run once a prefill call."""
    from repro_torch.models import layer_pattern
    n = {"attn": 0, "scan": 0, "norm": 1, "enc_norm": 0}   # final norm
    for _, kind, k in layer_pattern(cfg):
        n["norm"] += 2 * k
        if kind in ("attn", "shared_attn"):
            n["attn"] += k
        elif kind in ("mamba", "mlstm"):
            n["scan"] += k
    if cfg.family == "audio":
        n["norm"] += cfg.n_layers
        n["enc_norm"] = 2 * cfg.encoder_layers + 1
    return n


def phase_slot_path(arch: str, n_requests: int,
                    engine_mode: str = "vec") -> dict:
    """One full-width slot path through the launcher's entry points
    (``engine_mode="ref"``: the launcher's engine config with the
    per-slot seed oracle, every decode step over all 32 slots); returns
    the five kernels' launch counts of the run."""
    import repro_torch.serving.engine as engine_mod
    from repro_torch.core import make_policy
    from repro_torch.launch.serve import (_engine_cfg, build_parser,
                                          make_model, serve)
    from repro_torch.serving import ServingEngine
    args = build_parser().parse_args(
        ["--arch", arch, "--policy", "bfio_h8", "--cache-backend", "slot",
         "--workers", "4", "--slots", "8", "--requests", str(n_requests),
         "--max-new", "16", "--seed", "0"])
    _free()
    base = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, device = make_model(args)
    eng = ServingEngine(
        cfg, params, dataclasses.replace(_engine_cfg(args),
                                         engine_mode=engine_mode),
        make_policy(args.policy), device=device)
    del params
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
    what = f"slot path {cfg.name}" + (
        " engine_mode=ref" if engine_mode == "ref" else "")
    check(all(r.done and not r.failed for r in reqs),
          f"{what}: not every request finished")
    check(all(len(r.generated) == args.max_new for r in reqs),
          f"{what}: a request generated the wrong number of tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"{what}: token id out of range")
    n_dec, n_pre = meas["decoded_steps"], prefills[0]
    sites = _stack_counts(cfg)
    check(n_dec > 0 and n_pre > 0, f"{what}: no decode or no prefill ran")
    need = {"rms_norm": sites["norm"] * n_dec + sites["enc_norm"] * n_pre,
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


def _vlm_prompts(cfg, n: int, max_new: int, seed: int) -> list:
    """The launcher's stream behind an image: each prompt is the image's
    ``patch_tokens`` positions (placeholder id 0; the engine's zero patch
    stub fills them) and then 4..63 random text tokens."""
    from repro_torch.serving import ServeRequest
    rng = np.random.default_rng(seed)
    return [ServeRequest(rid=i, tokens=np.concatenate([
        np.zeros(cfg.patch_tokens, np.int64),
        rng.integers(1, cfg.vocab_size, size=int(rng.integers(4, 64)))]),
        max_new_tokens=max_new) for i in range(n)]


def phase_paged_path(arch: str, what: str, *, slots: int = 8,
                     requests: int = 32, max_seq_len: int = 0) -> dict:
    """One full-width paged engine path through the launcher: ``arch`` at
    full depth in bf16 with seeded random weights, ``bfio_h8``, 4 workers
    x ``slots`` slots, ``requests`` requests of 16 new tokens.  With
    ``max_seq_len`` the launcher's ``EngineConfig`` takes that cache
    length in place of its 256, and the stream puts an image in front of
    each prompt (vlm: the launcher's 256 cannot hold the image).  Counters
    zeroed just before and read just after; K1 and K2 must run on every
    decode step.  Prints init seconds, the peak device memory from the
    start of the path, the mean decode-step ms and the launches; frees
    the engine and its weights before it returns the launch counts."""
    from repro_torch.core import make_policy
    from repro_torch.launch.serve import (_engine_cfg, build_parser,
                                          make_model, serve)
    from repro_torch.serving import ServingEngine
    args = build_parser().parse_args(
        ["--arch", arch, "--policy", "bfio_h8", "--cache-backend",
         "paged", "--workers", "4", "--slots", str(slots), "--requests",
         str(requests), "--max-new", "16", "--seed", "0"])
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, device = make_model(args)
    ec = _engine_cfg(args)
    if max_seq_len:
        ec = dataclasses.replace(ec, max_seq_len=max_seq_len)
    eng = ServingEngine(cfg, params, ec, make_policy(args.policy),
                        device=device)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    prompts = (_vlm_prompts(cfg, args.requests, args.max_new, args.seed)
               if max_seq_len else None)
    launches = _zero_and_read(None)
    out = serve(args, eng, requests=prompts)
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
    rows = (f", prompts of {min(len(r.tokens) for r in reqs)}.."
            f"{max(len(r.tokens) for r in reqs)} tokens at max_seq_len "
            f"{eng.ec.max_seq_len}" if max_seq_len else "")
    print(f"{what}: {cfg.name} ({L} layers, d={cfg.d_model}{moe}, "
          f"{cfg.dtype}, {_numel(eng.params) / 1e9:.2f} B parameters), init "
          f"{init_s:.2f} s, {weights_gb:.2f} GB on the card after init; "
          f"{len(reqs)} requests over {eng.G} x {eng.B} slots{rows}, "
          f"{stats['tokens']} tokens, {meas['steps']} steps ({n_dec} with "
          f"decode); launches {launches}")
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


def phase_cross_device_ref(dev):
    """The per-slot reference engine (``engine_mode="ref"``) on the CPU and
    on the card: granite-8b-smoke and zamba2-1.2b-smoke in float32 on the
    slot backend, same weights and stream.  Stats and generations equal
    across devices, and the card's ref engine equal to the card's vec
    engine in stats, generations and workers."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import make_policy
    from repro_torch.launch.serve import submit_requests
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine
    out = []
    for arch in ("granite-8b", "zamba2-1.2b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        p_cpu = init_params(cfg, 0, device="cpu")
        p_dev = _tree_to(p_cpu, dev)
        runs = []
        for params, d, mode in ((p_cpu, "cpu", "ref"), (p_dev, dev, "ref"),
                                (p_dev, dev, "vec")):
            ec = EngineConfig(n_workers=2, slots_per_worker=4,
                              max_seq_len=256, cache_backend="slot",
                              engine_mode=mode)
            eng = ServingEngine(cfg, params, ec, make_policy("bfio_h8"),
                                device=d)
            reqs = submit_requests(eng, 12, 8, seed=5)
            stats = eng.run()
            runs.append((stats, [r.generated for r in reqs],
                         [r.worker for r in reqs]))
        (cs, cg, _), (rs, rg, rw), (vs, vg, vw) = runs
        check(cs == rs, f"cross-device ref {cfg.name}: engine stats differ "
              f"{cs} vs {rs}")
        check(cg == rg, f"cross-device ref {cfg.name}: generations on the "
              f"card differ from the CPU plain path")
        check(rs == vs and rg == vg and rw == vw,
              f"ref vs vec {cfg.name} on the card: stats, generations or "
              f"workers differ")
        out.append((cfg.name, rs["tokens"]))
    return out


def _loop_stream(n_heavy: int, n_light: int, seed: int, *, integer: bool):
    """The device-loop demo's bimodal stream (examples/device_loop_demo.py):
    ``n_heavy`` prompts of 200..300 and ``n_light`` of 5..30, each with
    4..23 decode steps; ``integer`` draws whole sizes, so that every
    float32 sum of the loop is exact in any order."""
    rng = np.random.default_rng(seed)
    if integer:
        sizes = np.concatenate([rng.integers(200, 301, n_heavy),
                                rng.integers(5, 31, n_light)])
    else:
        sizes = np.concatenate([rng.uniform(200, 300, n_heavy),
                                rng.uniform(5, 30, n_light)])
    return sizes.astype(np.float64), rng.integers(4, 24, len(sizes))


def phase_cross_device_loop(dev):
    """The device loop on the CPU (plain swap search) and on the card
    (K4) at the demo's configuration (G=8, B=8, wait_cap 256, 128
    integer-sized requests), as is, with a prefill budget of 16 and with
    a KV pool of 150: after 64 steps every ``LoopState`` field equal."""
    from repro_torch.serving import init_loop_state, make_device_serving_loop
    G, B, W, steps = 8, 8, 256, 64
    sizes, rem = _loop_stream(24, 104, 0, integer=True)
    out = []
    for kw in ({}, {"prefill_budget": 16.0}, {"kv_pool": 150.0}):
        states = []
        for d in ("cpu", dev):
            run = make_device_serving_loop(G, B, W, device=d, **kw)
            states.append(run(init_loop_state(G, B, sizes, rem, W,
                                              device=d), steps))
        what = ", ".join(f"{k}={v}" for k, v in kw.items()) or "plain"
        for field in states[0]._fields:
            a, b = getattr(states[0], field), getattr(states[1], field)
            check(a.dtype == b.dtype and torch.equal(a, b.cpu()),
                  f"cross-device loop ({what}): {field} differs between "
                  f"the CPU and the card")
        st = states[1]
        if not kw:
            check(int(st.slot_active.sum()) == 0
                  and int((st.wait_prefill > 0).sum()) == 0,
                  "cross-device loop: the demo's requests were not all "
                  "served in 64 steps")
        out.append((what, int(st.tot_steps), float(st.tot_imbalance),
                    int(st.tot_preempts)))
    return out


def _host_reads(fn):
    """(fn(), the synchronizing operations PyTorch's sync debug mode saw
    inside the call)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]


def phase_device_loop_path() -> dict:
    """The device-loop path at full width: G=32, B=16 (512 slots),
    wait_cap 1024, the demo's mix scaled by 8 (1,024 requests), run in
    chunks of 16 steps until the loop is empty (400 steps at most), with
    PyTorch's sync debug mode on inside each chunk: a step must make no
    host read.  K4 must launch ``swap_iters`` times a step, by its
    counter over the whole run and over each of two profiled first
    steps, whose issued device operations must be equal.  Prints the
    mean ms a step, the issued and recorded operations of the profiled
    step and the average imbalance a step; returns the kernels' launch
    counts."""
    from repro_torch.serving import init_loop_state, make_device_serving_loop
    G, B, W, swap_iters, chunk = LOOP_G, LOOP_B, LOOP_W, 4, 16
    dev = torch.device("cuda")
    one = torch.ones(1, device=dev)
    check(_host_reads(lambda: one.item())[1], "device-loop path: the sync "
          "debug mode did not see a known host read")
    sizes, rem = _loop_stream(192, 832, 0, integer=False)
    run = make_device_serving_loop(G, B, W, swap_iters=swap_iters)
    state = init_loop_state(G, B, sizes, rem, W)
    # the first step, profiled twice from the same state: the issued
    # count must repeat, and the launch counter sees K4 swap_iters times
    traces = []
    for _ in range(2):
        before = _zero_and_read(None)
        traces.append(_issued_ops(lambda: run(state, 1)))
        traces[-1]["k4_counted"] = _zero_and_read(before)["bfio_swap"]
    launches = _zero_and_read(None)
    chunk_s, syncs = [], []
    while int(state.tot_steps) < 400:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, reads = _host_reads(lambda: run(state, chunk))
        torch.cuda.synchronize(dev)
        chunk_s.append(time.perf_counter() - t0)
        syncs += reads
        if not bool(state.slot_active.any() | (state.wait_prefill > 0).any()):
            break
    launches = _zero_and_read(launches)
    steps = int(state.tot_steps)
    what = "device-loop path"
    check(not syncs, f"{what}: a step read the device from the host: "
          f"{syncs[:3]}")
    check(int(state.slot_active.sum()) == 0
          and int((state.wait_prefill > 0).sum()) == 0,
          f"{what}: requests left after {steps} steps")
    check(int(state.tot_preempts) == 0, f"{what}: preemptions without a "
          f"pool")
    check(launches["bfio_swap"] == swap_iters * steps,
          f"{what}: swap kernel launched {launches['bfio_swap']} times in "
          f"{steps} steps, need {swap_iters} a step")
    for t in traces:
        check(t["k4_counted"] == swap_iters, f"{what}: the profiled step "
              f"launched the swap kernel {t['k4_counted']} times, need "
              f"{swap_iters}")
        check(0 < t["recorded"] <= t["issued"], f"{what}: the device "
              f"recorded {t['recorded']} operations of {t['issued']} "
              f"issued")
    check(traces[0]["by_api"] == traces[1]["by_api"], f"{what}: two "
          f"traces of the same step issued {traces[0]['by_api']} and "
          f"{traces[1]['by_api']}")
    ms = 1e3 * sum(chunk_s) / steps
    print(f"{what}: G={G} x B={B} ({G * B} slots), wait_cap {W}, "
          f"{len(sizes)} requests (192 of 200..300 tokens, 832 of 5..30), "
          f"swap_iters {swap_iters}; {steps} steps in {len(chunk_s)} chunks "
          f"of {chunk}, all served, 0 host reads inside a step; launches "
          f"{launches}")
    print(f"{what} MEASURED on {torch.cuda.get_device_name(0)}: "
          f"{ms:.2f} ms a step (mean over {steps} steps, device "
          f"synchronised at each chunk's ends); the first step issued "
          f"{traces[0]['issued']} device operations "
          f"({traces[0]['by_api']}) in each of two traces, of which the "
          f"device recorded {traces[0]['recorded']} and "
          f"{traces[1]['recorded']} (K4 {traces[0]['k4_recorded']} and "
          f"{traces[1]['k4_recorded']}); {swap_iters} K4 launches a step "
          f"by the counter; average imbalance "
          f"{float(state.tot_imbalance) / steps:.2f} a step")
    return launches


def _value_and_grads(cfg, params, batch, compute=torch.bfloat16):
    """The train step's loss and gradients (``compute`` from the float32
    masters, as ``make_train_step`` casts them), without the optimizer."""
    from repro_torch.models import loss_fn
    from repro_torch.models.layers import tree_leaves, tree_map
    ps = tree_map(lambda t: t.detach().requires_grad_(True), params)
    flat = tree_leaves(ps)

    def cast(p):
        return p.to(compute) if p.dim() > 1 else p
    loss = loss_fn(cfg, tree_map(cast, ps), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), grads


def phase_cross_device_train(dev):
    """Training on granite-8b-smoke, float32 weights and compute: the same
    reference-layout weights (the port's seeded init, through numpy and
    ``params_from_numpy``) and batches on the CPU (plain norms) and the
    card (K2 and its backward kernel).  One step's gradients within 1e-4
    of each leaf's largest entry; five steps of ``train`` (default AdamW,
    whose warm-up keeps a parameter within 2 x the sum of the learning
    rates, 9e-5, of its other run even where a tiny gradient's sign
    differs): loss histories within 1e-5 relative, every parameter within
    1e-4; a checkpoint written by the CPU run after 4 steps, resumed on the
    card, gives the CPU's fifth loss and its final parameters.  Then the
    launcher, ``python -m repro_torch.launch.train --arch granite-8b
    --smoke --steps 4``, on the card as a subprocess."""
    import tempfile
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import token_batches
    from repro_torch.models import init_params, params_from_numpy
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.training import (AdamWConfig, load_checkpoint,
                                      make_train_step, train)
    from repro_torch.training.optimizer import OptState
    cfg = dataclasses.replace(get_smoke_config("granite-8b"),
                              dtype="float32")
    weights = tree_map(lambda t: t.numpy(), init_params(cfg, 0,
                                                        device="cpu"))
    batches = list(token_batches(vocab_size=cfg.vocab_size, batch=4,
                                 seq_len=64, n_batches=5, seed=7))
    tb = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    grads = []
    for d in ("cpu", dev):
        p = params_from_numpy(weights, device=d)
        f0, b0 = _launch_counts()
        loss, g = _value_and_grads(cfg, p, {k: v.to(d) for k, v in
                                            tb.items()}, torch.float32)
        f1, b1 = _launch_counts()
        grads.append(g)
        if d != "cpu":
            torch.cuda.synchronize()
            check(f1 > f0 and b1 > b0, "cross-device train: the card's "
                  "gradient did not run K2 and its backward")
    worst = 0.0
    for a, b in zip(*grads):
        err = float((a.cpu() - b.cpu()).abs().max()) / max(
            float(a.abs().max()), 1e-30)
        worst = max(worst, err)
    check(worst <= 1e-4, f"cross-device train: gradients differ by "
                         f"{worst:.3e} of a leaf's largest entry")
    runs = []
    with tempfile.TemporaryDirectory() as ckpt:
        for d in ("cpu", dev):
            p = params_from_numpy(weights, device=d)
            p, losses = train(cfg, params=p, batches=batches, log_every=0,
                              ckpt_dir=ckpt if d == "cpu" else None,
                              ckpt_every=4, compute_dtype="float32")
            runs.append((p, losses))
        (pc, lc), (pd, ld) = runs
        rel = max(abs(a - b) / abs(a) for a, b in zip(lc, ld))
        check(rel <= 1e-5, f"cross-device train: loss histories {lc} and "
                           f"{ld} differ by {rel:.3e} relative")
        perr = max(float((a - b.cpu()).abs().max())
                   for a, b in zip(tree_leaves(pc), tree_leaves(pd)))
        check(perr <= 1e-4, f"cross-device train: parameters after 5 steps "
                            f"differ by {perr:.3e}")
        like = params_from_numpy(weights, device=dev)
        tree, step = load_checkpoint(ckpt, {"params": like, "opt_m": like,
                                            "opt_v": like})
        check(step == 4, f"cross-device train: checkpoint step {step}")
        opt = OptState(step=torch.tensor(step, dtype=torch.int32,
                                         device=dev),
                       m=tree["opt_m"], v=tree["opt_v"])
        step_fn = make_train_step(cfg, AdamWConfig(),
                                  compute_dtype="float32")
        loss5, pr, _ = step_fn(tree["params"], opt, {
            k: torch.from_numpy(v).to(dev) for k, v in batches[4].items()})
        loss5 = float(loss5)
        check(abs(loss5 - lc[4]) <= 1e-5 * abs(lc[4]),
              f"cross-device train: the card resumed from the CPU's "
              f"checkpoint to loss {loss5}, the CPU's fifth step had "
              f"{lc[4]}")
        rerr = max(float((a - b.cpu()).abs().max())
                   for a, b in zip(tree_leaves(pc), tree_leaves(pr)))
        check(rerr <= 1e-4, f"cross-device train: resumed parameters "
                            f"differ by {rerr:.3e}")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "granite-8b", "--smoke", "--steps", "4"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    check(r.returncode == 0 and "[train] done: loss" in r.stdout,
          f"launch.train on the card failed ({r.returncode}): "
          f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
    return dict(grad_err=worst, losses=ld, rel=rel, param_err=perr,
                resume_loss=loss5, resume_param_err=rerr,
                launcher=r.stdout.strip().splitlines()[-1],
                launcher_s=time.perf_counter() - t0)


def phase_cross_device_train_ssm(dev):
    """Training's gradient for the recurrent families, zamba2-1.2b-smoke
    and xlstm-350m-smoke in float32 weights and compute: the same weights
    (the port's seeded init through numpy) and batch (4 x 160 tokens, so
    every scan runs at the models' chunk of 128 over a padded S) on the
    CPU (plain versions), on the card (K5 and its backward, K2 and its
    backward), and on the card with K5's plain version in the kernel's
    place (a control).  Each leaf of the card's gradient within 1e-4 of
    its largest entry of the control's (K5 and its backward against their
    plain versions inside the model), and of the CPU's beyond the
    control's own distance from the CPU: float32 sums in the card's other
    kernels and GEMMs already move xlstm's mLSTM gradients (normalised by
    a running sum) by ~6e-4 of a leaf's largest entry at this input, with
    or without K5's kernel.  K5's backward launched on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import token_batches
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.models import init_params, params_from_numpy
    from repro_torch.models.layers import tree_map

    def rel(ga, gb):
        return max(float((a.cpu() - b.cpu()).abs().max())
                   / max(float(a.abs().max()), 1e-30)
                   for a, b in zip(ga, gb))
    out = []
    for arch in ("zamba2-1.2b", "xlstm-350m"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        weights = tree_map(lambda t: t.numpy(), init_params(cfg, 0,
                                                            device="cpu"))
        batch = {k: torch.from_numpy(v) for k, v in next(token_batches(
            vocab_size=cfg.vocab_size, batch=4, seq_len=160, n_batches=1,
            seed=8)).items()}

        def grads(d):
            return _value_and_grads(
                cfg, params_from_numpy(weights, device=d),
                {k: v.to(d) for k, v in batch.items()}, torch.float32)
        loss_cpu, g_cpu = grads("cpu")
        b0 = ss.ssm_chunk_scan_bwd.launches
        loss, g_card = grads(dev)
        torch.cuda.synchronize()
        n_bwd = ss.ssm_chunk_scan_bwd.launches - b0
        check(n_bwd > 0, f"cross-device train {cfg.name}: the card's "
                         f"gradient did not run K5's backward")
        inner = ops._ssm_chunk_scan
        ops._ssm_chunk_scan = ss.ssm_chunk_scan_plain
        try:
            _, g_ctl = grads(dev)
        finally:
            ops._ssm_chunk_scan = inner
        vs_ctl, vs_cpu, ctl_cpu = (rel(g_ctl, g_card), rel(g_cpu, g_card),
                                   rel(g_cpu, g_ctl))
        check(vs_ctl <= 1e-4 and vs_cpu <= ctl_cpu + 1e-4,
              f"cross-device train {cfg.name}: the card's gradient within "
              f"{vs_ctl:.3e} of the control's and {vs_cpu:.3e} of the "
              f"CPU's (the control within {ctl_cpu:.3e} of the CPU's)")
        out.append((cfg.name, vs_ctl, vs_cpu, ctl_cpu,
                    [float(loss_cpu), float(loss)], n_bwd))
    return out


def _launch_counts() -> tuple[int, int]:
    from repro_torch.kernels import rms_norm as rk
    return rk.rms_norm.launches, rk.rms_norm_bwd.launches


TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2, 4096, 4


def phase_train_path(card: str) -> dict:
    """The train path: ``repro_torch.training.train`` on full-width
    granite-8b (d=4096, 32/8 heads of 128, d_ff=14336, vocab 49,152),
    depth cut to TRAIN_LAYERS of 36 (float32 masters with AdamW m and v,
    float32 gradients and the bfloat16 compute copy take ~18 bytes a
    parameter), seeded random weights, batch TRAIN_BATCH x TRAIN_SEQ
    (train_4k's sequence), TRAIN_STEPS steps of ``token_batches``, remat
    a layer, the launcher's AdamW.  First one gradient alone: every
    parameter leaf's finite and nonzero (K2's backward passes the
    gradient through every layer).  Counters zeroed just before the
    training and read just after: K2 at least (2 L + 1) and its backward
    at least (2 L + 1) launches a step.  Prints each step's loss, the
    mean step ms (steps after the first), the peak device memory, the
    model FLOPs a step (the port's ``analytic_flops``) and their share of
    989 TFLOP/s."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.data import token_batches
    from repro_torch.launch.roofline import H100, analytic_flops
    from repro_torch.models import init_params
    from repro_torch.models.layers import tree_leaves
    from repro_torch.training import AdamWConfig, train
    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("granite-8b"),
                              n_layers=TRAIN_LAYERS)
    L = cfg.n_layers
    t0 = time.perf_counter()
    params = init_params(dataclasses.replace(cfg, dtype="float32"), 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par = _numel(params)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in token_batches(vocab_size=cfg.vocab_size,
                                      batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                      n_batches=TRAIN_STEPS, seed=0)]
    f0, b0 = _launch_counts()
    loss, grads = _value_and_grads(cfg, params, batches[0])
    torch.cuda.synchronize()
    f1, b1 = _launch_counts()
    check(all(g is not None for g in grads),
          "train path: a parameter leaf got no gradient")
    bad = [i for i, g in enumerate(grads)
           if not (torch.isfinite(g).all().item() and g.abs().max().item()
                   > 0)]
    check(not bad and bool(torch.isfinite(loss)),
          f"train path: {len(bad)} parameter leaves have a zero or "
          f"non-finite gradient (loss {float(loss)})")
    check(f1 - f0 >= 2 * L + 1 and b1 - b0 >= 2 * L + 1,
          f"train path: one gradient launched K2 {f1 - f0} and its "
          f"backward {b1 - b0} times, need >= {2 * L + 1} each")
    print(f"train path: {cfg.name} cut to {L} layers, "
          f"{n_par / 1e9:.3f} B parameters (float32 masters), init "
          f"{init_s:.2f} s; one gradient: loss {float(loss):.4f}, all "
          f"{len(grads)} leaves finite and nonzero, K2 {f1 - f0} and its "
          f"backward {b1 - b0} launches [{card}]")
    del loss, grads
    _free()
    stamps, log = [], []

    def log_fn(msg):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        log.append(msg)
    opt = AdamWConfig(lr=3e-4, warmup_steps=min(20, TRAIN_STEPS // 5),
                      total_steps=TRAIN_STEPS)
    launches = _zero_and_read(None)
    t0 = time.perf_counter()
    params, losses = train(cfg, params=params, batches=batches, opt_cfg=opt,
                           log_every=1, log_fn=log_fn)
    launches = _zero_and_read(launches)
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"train path: losses {losses}")
    n = TRAIN_STEPS
    check(launches["rms_norm"] >= (2 * L + 1) * n
          and launches["rms_norm_bwd"] >= (2 * L + 1) * n,
          f"train path: K2 launched {launches['rms_norm']} and its "
          f"backward {launches['rms_norm_bwd']} times over {n} steps, need "
          f">= {(2 * L + 1) * n} each")
    steps_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
    mean_ms = float(np.mean(steps_ms[1:]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_BATCH)
    flops = analytic_flops(cfg, shape)
    share = flops["model_flops"] / (mean_ms / 1e3 * H100.peak_flops)
    for i, (lo, ms) in enumerate(zip(losses, steps_ms)):
        print(f"train path step {i}: loss {lo:.4f}, {ms:.1f} ms [{card}]")
    print(f"train path MEASURED on {torch.cuda.get_device_name(0)}: mean "
          f"step {mean_ms:.1f} ms (steps 1..{n - 1}), peak memory "
          f"{peak:.2f} GB; model FLOPs a step {flops['model_flops']:.4e} "
          f"(6 N D, N = {cfg.active_params() / 1e9:.3f} B, D = "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}), {share:.1%} of 989 TFLOP/s bf16; "
          f"with the remat pass and attention {flops['with_remat']:.4e}; "
          f"launches {launches} [{card}]")
    del params, batches
    _free()
    return launches


ZTRAIN_BATCH, ZTRAIN_SEQ, ZTRAIN_STEPS = 2, 4096, 4


def _leaf_kinds(tree, prefix=()) -> list:
    """Each leaf's kind in ``tree_leaves`` order: its path with a layer
    group's name (``m0`` .. ``m5``, ``m_tail``) replaced by ``mamba``, so
    that a smoke config's tree and the full one's compare."""
    import re
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_kinds(
            tree[k], prefix + ("mamba" if not prefix and re.fullmatch(
                r"m\d+|m_tail", k) else k,))]
    return ["/".join(prefix)]


def phase_train_path_ssm(card: str) -> dict:
    """The hybrid family's train path: ``repro_torch.training.train`` on
    full zamba2-1.2b, not cut (38 layers: 32 Mamba2 blocks and 6
    applications of the shared attention block, d=2048, 1.01 B
    parameters, ~18 bytes a parameter), seeded random weights, batch
    ZTRAIN_BATCH x ZTRAIN_SEQ, ZTRAIN_STEPS steps, remat a layer, the
    launcher's AdamW.  First one gradient: every parameter leaf finite,
    and nonzero wherever zamba2-1.2b-smoke's gradient on the CPU is
    nonzero for a leaf of the same kind.  Counters zeroed just before the
    training and read just after: K5 at least 2 x 32 launches a step (the
    forward and the remat pass) and its backward at least 32, K2 and its
    backward on every norm.  Prints the mean step ms, the peak memory and
    the model FLOPs' share of 989 TFLOP/s."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.data import token_batches
    from repro_torch.launch.roofline import H100, analytic_flops
    from repro_torch.models import init_params
    from repro_torch.training import AdamWConfig, train
    scfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"),
                               dtype="float32")
    sp = init_params(scfg, 0, device="cpu")
    sb = {k: torch.from_numpy(v) for k, v in next(token_batches(
        vocab_size=scfg.vocab_size, batch=2, seq_len=160, n_batches=1,
        seed=9)).items()}
    _, sg = _value_and_grads(scfg, sp, sb, torch.float32)
    live = {kind for kind, g in zip(_leaf_kinds(sp), sg)
            if float(g.abs().max()) > 0}
    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("zamba2-1.2b")
    sites = _stack_counts(cfg)
    t0 = time.perf_counter()
    params = init_params(dataclasses.replace(cfg, dtype="float32"), 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par = _numel(params)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in token_batches(vocab_size=cfg.vocab_size,
                                      batch=ZTRAIN_BATCH, seq_len=ZTRAIN_SEQ,
                                      n_batches=ZTRAIN_STEPS, seed=0)]
    before = _zero_and_read(None)
    loss, grads = _value_and_grads(cfg, params, batches[0])
    torch.cuda.synchronize()
    one = _zero_and_read(before)
    kinds = _leaf_kinds(params)
    check(len(kinds) == len(grads), "zamba2 train path: leaf count")
    bad = [k for k, g in zip(kinds, grads)
           if g is None or not torch.isfinite(g).all().item()
           or (k in live and not g.abs().max().item() > 0)]
    check(not bad and bool(torch.isfinite(loss)),
          f"zamba2 train path: leaves with a non-finite gradient, or zero "
          f"where the smoke config's is not: {bad[:8]} (loss {float(loss)})")
    n_scan = sites["scan"]
    check(one["ssm_chunk_scan"] >= 2 * n_scan
          and one["ssm_chunk_scan_bwd"] >= n_scan,
          f"zamba2 train path: one gradient launched K5 "
          f"{one['ssm_chunk_scan']} and its backward "
          f"{one['ssm_chunk_scan_bwd']} times, need >= {2 * n_scan} and "
          f">= {n_scan}")
    print(f"zamba2 train path: {cfg.name}, not cut ({cfg.n_layers} layers,"
          f" {n_scan} Mamba2 blocks), {n_par / 1e9:.3f} B parameters "
          f"(float32 masters), init {init_s:.2f} s; one gradient: loss "
          f"{float(loss):.4f}, all {len(grads)} leaves finite, nonzero "
          f"where the smoke config's are ({len(live)} kinds); launches "
          f"{one} [{card}]")
    del loss, grads
    _free()
    stamps = []

    def log_fn(msg):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    opt = AdamWConfig(lr=3e-4, warmup_steps=min(20, ZTRAIN_STEPS // 5),
                      total_steps=ZTRAIN_STEPS)
    launches = _zero_and_read(None)
    t0 = time.perf_counter()
    params, losses = train(cfg, params=params, batches=batches, opt_cfg=opt,
                           log_every=1, log_fn=log_fn)
    launches = _zero_and_read(launches)
    n = ZTRAIN_STEPS
    check(len(losses) == n and all(np.isfinite(losses)),
          f"zamba2 train path: losses {losses}")
    check(launches["ssm_chunk_scan"] >= 2 * n_scan * n
          and launches["ssm_chunk_scan_bwd"] >= n_scan * n
          and launches["rms_norm"] >= sites["norm"] * n
          and launches["rms_norm_bwd"] >= sites["norm"] * n,
          f"zamba2 train path: launches {launches} over {n} steps, need K5 "
          f">= {2 * n_scan * n}, its backward >= {n_scan * n}, K2 and its "
          f"backward >= {sites['norm'] * n}")
    steps_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
    mean_ms = float(np.mean(steps_ms[1:]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    shape = dataclasses.replace(SHAPES["train_4k"],
                                global_batch=ZTRAIN_BATCH)
    flops = analytic_flops(cfg, shape)
    share = flops["model_flops"] / (mean_ms / 1e3 * H100.peak_flops)
    for i, (lo, ms) in enumerate(zip(losses, steps_ms)):
        print(f"zamba2 train path step {i}: loss {lo:.4f}, {ms:.1f} ms "
              f"[{card}]")
    print(f"zamba2 train path MEASURED on {torch.cuda.get_device_name(0)}: "
          f"mean step {mean_ms:.1f} ms (steps 1..{n - 1}), peak memory "
          f"{peak:.2f} GB; model FLOPs a step {flops['model_flops']:.4e} "
          f"(6 N D, N = {cfg.active_params() / 1e9:.3f} B, D = "
          f"{ZTRAIN_BATCH} x {ZTRAIN_SEQ}), {share:.1%} of 989 TFLOP/s "
          f"bf16; launches {launches} [{card}]")
    del params, batches
    _free()
    return launches


MESH_TRAIN_LAYERS = 2


def phase_mesh_train_path(dev, card: str) -> dict:
    """Training under a mesh on the card: full-width granite-8b cut to
    MESH_TRAIN_LAYERS layers, float32 masters (bf16 compute), batch
    TRAIN_BATCH x TRAIN_SEQ, under the (1, 1) NCCL mesh of
    :func:`_mesh_group`, params placed by ``param_shardings(mode="train")``
    (FSDP's rules; at (1, 1) every placement is replicated), the batch by
    ``batch_shardings``, the residual by ``activation_spec``.  One step of
    ``make_train_step(mesh=..., grad_shardings=..., act_spec=...)``
    against ``mesh=None`` from the same weights and batch (each timed on
    its second call): the loss, the new parameters and AdamW's m and v
    (m is 0.1 x the clipped gradient after one step) bit for bit: the
    mesh runs the same kernels on the same local tensors.  Counters zeroed
    just before the timed mesh step and read just after: K2 and its
    backward on the shards.  And ``python -m repro_torch.launch.train
    --arch granite-8b --smoke --steps 2`` on the card, under its (1, 1)
    mesh, as a subprocess started first (most of its ~25 s is imports and
    the group's start) and joined at the end."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import token_batches
    from repro_torch.launch import mesh as pm
    from repro_torch.models import init_params, param_axes
    from repro_torch.models.layers import tree_leaves
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t_launch = time.perf_counter()
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-8b", "--smoke", "--steps", "2"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    _free()
    cfg = dataclasses.replace(get_config("granite-8b"),
                              n_layers=MESH_TRAIN_LAYERS)
    L = cfg.n_layers
    params = init_params(dataclasses.replace(cfg, dtype="float32"), 0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(token_batches(
        vocab_size=cfg.vocab_size, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        n_batches=1, seed=0)).items()}
    opt_cfg = AdamWConfig()
    timed = {}

    def run(step, p, b):
        step(p, init_opt_state(p), b)          # the first call warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(p, init_opt_state(p), b)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3
    (l0, p0, o0), timed["none"] = run(make_train_step(cfg, opt_cfg),
                                      params, batch)
    _mesh_group()
    try:
        mesh = pm._make_mesh((1, 1), ("data", "model"), "cuda")
        sh = pm.param_shardings(param_axes(cfg), cfg, mesh, mode="train")
        dp = pm.distribute_tree(params, sh)
        db = pm.distribute_tree(batch, pm.batch_shardings(
            batch, mesh, TRAIN_BATCH))
        step = make_train_step(cfg, opt_cfg, mesh=mesh, grad_shardings=sh,
                               act_spec=pm.activation_spec(cfg, mesh,
                                                           TRAIN_BATCH))
        step(dp, init_opt_state(dp), db)
        torch.cuda.synchronize()
        launches = _zero_and_read(None)
        t0 = time.perf_counter()
        l1, p1, o1 = step(dp, init_opt_state(dp), db)
        torch.cuda.synchronize()
        timed["mesh"] = (time.perf_counter() - t0) * 1e3
        launches = _zero_and_read(launches)
        check(torch.equal(l0, l1.full_tensor()),
              f"mesh train path: loss {float(l0)} without the mesh, "
              f"{float(l1.full_tensor())} under it")
        worst = 0.0
        for a, b in zip(tree_leaves((p0, o0.m, o0.v)),
                        tree_leaves((p1, o1.m, o1.v))):
            b = b.full_tensor()
            worst = max(worst, float((a - b).abs().max()))
        check(worst == 0.0, f"mesh train path: parameters, m or v differ "
                            f"by up to {worst:.3e} from mesh=None's")
        check(launches["rms_norm"] >= 2 * (2 * L + 1)
              and launches["rms_norm_bwd"] >= 2 * L + 1,
              f"mesh train path: launches {launches}, need K2 >= "
              f"{2 * (2 * L + 1)} and its backward >= {2 * L + 1}")
        n_par = _numel(params)
        del dp, db, p1, o1, l1
    finally:
        dist.destroy_process_group()
    del params, p0, o0, batch
    _free()
    print(f"mesh train path MEASURED on {card}: granite-8b at full width "
          f"cut to {L} layers ({n_par / 1e9:.3f} B parameters, float32 "
          f"masters, bf16 compute), batch {TRAIN_BATCH} x {TRAIN_SEQ}, one "
          f"step of make_train_step: mesh=None {timed['none']:.1f} ms, under"
          f" the (1, 1) NCCL mesh (FSDP rules, grad_shardings, act_spec) "
          f"{timed['mesh']:.1f} ms; loss {float(l0):.4f}, loss, parameters,"
          f" m and v bit for bit; launches {launches}")
    try:
        so, se = launcher.communicate(timeout=300)
    finally:
        if launcher.poll() is None:
            launcher.kill()
    check(launcher.returncode == 0 and "[train] done: loss" in so
          and "mesh {'data': 1, 'model': 1}" in so,
          f"launch.train under the (1, 1) mesh on the card failed "
          f"({launcher.returncode}): {so[-2000:]}{se[-2000:]}")
    print(f"mesh train path: launch.train --arch granite-8b --smoke --steps "
          f"2 on the card, (1, 1) NCCL mesh, "
          f"{time.perf_counter() - t_launch:.1f} s from its start: "
          f"{so.strip().splitlines()[-1]}")
    return launches


def _mesh_group() -> None:
    """One rank, NCCL for CUDA tensors and gloo for CPU ones, on a free
    localhost port."""
    import socket

    import torch.distributed as dist
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)


def _full(t):
    """A DTensor's global value (the tensor itself when plain)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _mesh_generate(cfg, params, batch, mesh, steps, *, kv="none",
                   feed=None, max_len=256):
    """Prefill and ``steps`` greedy decode steps of ``decode_fn`` (under
    ``mesh`` when given, its params and batch placed by the rules).
    ``feed``: the tokens to decode from (teacher forcing), else each step's
    own argmax.  Returns (logits of every call, tokens fed, decode ms a
    step on the host clock)."""
    from repro_torch.launch.mesh import (batch_shardings, distribute_tree,
                                         param_shardings)
    from repro_torch.models import decode_fn, param_axes, prefill_fn
    if mesh is not None:
        params = distribute_tree(
            params, param_shardings(param_axes(cfg), cfg, mesh))
        batch = distribute_tree(
            batch, batch_shardings(batch, mesh, batch["tokens"].shape[0]))
    logits_all, toks, ms = [], [], []
    with torch.no_grad():
        logits, cache = prefill_fn(cfg, params, batch, max_len=max_len,
                                   mesh=mesh)
        logits_all.append(_full(logits).float().cpu())
        for i in range(steps):
            tok = feed[i] if feed is not None else \
                logits_all[-1].argmax(-1).to(torch.int32)
            toks.append(tok)
            tok_d = tok.to(batch["tokens"].device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kw = {} if mesh is None else dict(mesh=mesh, kv_shard=kv)
            logits, cache = decode_fn(cfg, params, cache, tok_d, **kw)
            logits_all.append(_full(logits).float().cpu())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    del cache, params
    return logits_all, toks, ms


def _prompt_batch(vocab_size: int, n: int, seed: int, dev):
    """The launcher's stream (prompts of 4..63 tokens), right-padded."""
    from repro_torch.launch.serve import _synthetic
    reqs = _synthetic(vocab_size, n, 8, seed)
    S = max(len(r.tokens) for r in reqs)
    toks = np.zeros((n, S), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :len(r.tokens)] = r.tokens
    lens = np.array([len(r.tokens) for r in reqs], np.int32)
    return {"tokens": torch.from_numpy(toks).to(dev),
            "lengths": torch.from_numpy(lens).to(dev)}


def _agree(name, got, want, *, tol=None, rel=None, gap=0.0):
    """Each call's logits against ``want``'s: within ``tol`` (atol, rtol)
    elementwise, or with ``rel`` within ``rel`` times the call's largest
    |logit|, or (neither) equal bit for bit; the argmax equal wherever
    ``want``'s top-2 gap exceeds ``gap`` (with ``rel``: ``rel`` times the
    largest |logit|).  Returns (max abs err, positions checked, near ties
    skipped)."""
    err, seen, ties = 0.0, 0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        check(torch.isfinite(g).all().item(), f"{name}: call {i} "
                                              f"non-finite")
        e = (g - w).abs()
        if tol is not None:
            ok = (e <= tol["atol"] + tol["rtol"] * w.abs()).all().item()
        elif rel is not None:
            gap = rel * float(w.abs().max())
            ok = float(e.max()) <= gap
        else:
            ok = torch.equal(g, w)
        check(ok, f"{name}: call {i} logits max abs err "
                  f"{e.max().item():.3e} (largest |logit| "
                  f"{w.abs().max().item():.3e})")
        err = max(err, float(e.max()))
        top2 = torch.topk(w, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > gap
        check(torch.equal(g.argmax(-1)[clear], w.argmax(-1)[clear]),
              f"{name}: call {i} greedy token differs at a clear top-2 gap")
        seen += int(clear.sum())
        ties += int((~clear).sum())
    return err, seen, ties


def phase_mesh_path(dev, card: str) -> dict:
    """Serving under a (1, 1) ("data", "model") mesh on the card: a
    one-rank group, NCCL for the card and gloo for the CPU.  (1) Full-width
    granite-8b, prefill of the launcher's 32 prompts at ``max_len`` 256
    and 8 decode steps, ``mesh=None`` and then under the mesh with
    ``kv_shard="none"`` (K3 on the shards) and ``"length"`` (the plain
    length-sharded flash-decode and its all-reduces), both fed
    ``mesh=None``'s greedy tokens.  ``"none"`` must give ``mesh=None``'s
    logits bit for bit.  ``"length"`` computes the attention as the
    reference's flash-decode does, rounding the unnormalised
    probabilities to bf16 where K3 rounds the normalised ones: first the
    two are held to 2e-2 on the same inputs at the path's shape (B=32,
    Hq=32, Hkv=8, hd=128, L=256), then end to end each call's logits
    within 2e-2 of its largest |logit| (1-2 bf16 ulps of a logit: 36 bf16
    layers carry the attention's one-ulp differences there) and greedy
    tokens equal wherever the top-2 gap exceeds that.  Launch counters
    zeroed just before the two mesh runs and read just after.  (2) One
    full-width qwen3-moe-30b-a3b ``moe_ffn`` (128 experts top-8, d 2048, f
    768, bf16) under the mesh, bit-identical to ``mesh=None``.  (3) granite-8b-smoke
    and qwen3-moe-30b-a3b-smoke in float32, a gloo (1, 1) mesh on the CPU
    against the NCCL one on the card, 8 decode steps.  (4) Two dry-run
    pairs in subprocesses on this host's torch, started first, and the
    roofline over their records.  Returns the launch counts of (1)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import _make_mesh
    from repro_torch.models import init_params, moe
    out_dir = os.path.join(ROOT, "build", "dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    pairs = {"granite-8b --decode-opt": ["--arch", "granite-8b",
                                         "--decode-opt"],
             "qwen3-moe-30b-a3b": ["--arch", "qwen3-moe-30b-a3b"]}
    t_dry = time.perf_counter()
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *a, "--shape",
         "decode_32k", "--mesh", "single", "--out", out_dir], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, a in pairs.items()}
    _free()
    _mesh_group()
    try:
        mesh = _make_mesh((1, 1), ("data", "model"), "cuda")
        cpu_mesh = _make_mesh((1, 1), ("data", "model"), "cpu")
        g = torch.Generator().manual_seed(45)
        B, Hq, Hkv, hd, L = 32, 32, 8, 128, 256
        q = torch.randn(B, Hq, hd, generator=g).to(dev, torch.bfloat16)
        k, v = (torch.randn(B, L, Hkv, hd, generator=g).to(
            dev, torch.bfloat16) for _ in range(2))
        lens = torch.randint(1, L + 1, (B,), generator=g)
        lens[:2] = torch.tensor([1, L])
        lens = lens.to(dev, torch.int32)
        from repro_torch.kernels import ops
        from repro_torch.models.attention import decode_attention_lsharded
        with torch.no_grad():
            k3 = ops.decode_attention(q, k, v, lens)
            lsh = decode_attention_lsharded(q, k, v, lens,
                                            mesh=mesh).full_tensor()
        err = (lsh.float() - k3.float()).abs()
        check((err <= TOL["atol"] + TOL["rtol"] * k3.float().abs()).all()
              .item(), f"mesh decode_attention_lsharded against K3: max "
                       f"abs err {err.max().item():.3e}")
        print(f"mesh attention: decode_attention_lsharded under the (1, 1) "
              f"NCCL mesh against K3 on the same inputs (B=32, Hq=32, "
              f"Hkv=8, hd=128, L=256, bf16, lengths 1..256): max abs err "
              f"{err.max().item():.3e}")
        del q, k, v, k3, lsh
        cfg = get_config("granite-8b")
        t0 = time.perf_counter()
        params = init_params(cfg, 0, device=dev)
        batch = _prompt_batch(cfg.vocab_size, 32, 0, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        want, feed, ms0 = _mesh_generate(cfg, params, batch, None, 8)
        launches = _zero_and_read(None)
        runs = {kv: _mesh_generate(cfg, params, batch, mesh, 8, kv=kv,
                                   feed=feed) for kv in ("none", "length")}
        torch.cuda.synchronize()
        launches = _zero_and_read(launches)
        del params
        _free()
        for kv, (got, _, ms) in runs.items():
            err, seen, ties = _agree(
                f"mesh granite-8b kv_shard={kv}", got, want,
                rel=2e-2 if kv == "length" else None, gap=2e-2)
            print(f"mesh path MEASURED on {card}: granite-8b (36 layers, "
                  f"d=4096, bf16) B=32, max_len 256, (1, 1) NCCL mesh, "
                  f"kv_shard={kv}: decode step {np.mean(ms[1:]):.2f} ms "
                  f"(mean of steps 2-8; mesh=None {np.mean(ms0[1:]):.2f} "
                  f"ms); logits max abs err {err:.3e} against mesh=None "
                  f"over 9 calls, {seen} greedy tokens equal, {ties} near "
                  f"ties skipped")
        n_norm = 2 * cfg.n_layers + 1
        need = {"rms_norm": 2 * (n_norm * 9),
                "decode_attention": cfg.n_layers * 8}
        for name, lo in need.items():
            check(launches[name] >= lo,
                  f"mesh path: {name} launched {launches[name]} times, "
                  f"need >= {lo}")
        print(f"mesh path: granite-8b init {init_s:.2f} s; launches "
              f"{launches}")

        for T, S, seed in ((32, 1, 43), (4, 64, 44)):
            x, p = _moe_inputs(T, S, 2048, 128, 768, 8, seed=seed)
            x = x.to(dev, torch.bfloat16)
            p = {n: v.to(dev, torch.float32 if n == "router"
                          else torch.bfloat16) for n, v in p.items()}
            with torch.no_grad():
                plain, _ = moe.moe_ffn(x, p, n_experts=128, k=8,
                                       aux_loss=False)
                sharded, _ = moe.moe_ffn(x, p, n_experts=128, k=8,
                                         mesh=mesh, aux_loss=False)
            check(torch.equal(plain, sharded),
                  f"mesh moe_ffn ({T}, {S}): differs from mesh=None")
            print(f"mesh moe: moe_ffn ({T}, {S}, 2048) bf16, 128 experts "
                  f"top-8 of 768, under the (1, 1) NCCL mesh: bit-identical "
                  f"to mesh=None")
            del x, p, plain, sharded

        for arch in ("granite-8b", "qwen3-moe-30b-a3b"):
            scfg = dataclasses.replace(get_smoke_config(arch),
                                       dtype="float32")
            p_cpu = init_params(scfg, 0, device="cpu")
            b_cpu = _prompt_batch(scfg.vocab_size, 8, 3, "cpu")
            want, feed, _ = _mesh_generate(scfg, p_cpu, b_cpu, cpu_mesh, 8)
            got, _, _ = _mesh_generate(
                scfg, _tree_to(p_cpu, dev), _tree_to(b_cpu, dev), mesh, 8,
                feed=feed)
            err, seen, ties = _agree(f"mesh cross-device {scfg.name}", got,
                                     want, tol=dict(atol=1e-4, rtol=1e-4),
                                     gap=1e-4)
            print(f"mesh cross-device: {scfg.name} f32, gloo (1, 1) mesh on "
                  f"the CPU against the NCCL (1, 1) mesh on the card, prefill"
                  f" + 8 decode steps: logits within {err:.3e}, {seen} greedy "
                  f"tokens equal, {ties} near ties skipped")
    finally:
        dist.destroy_process_group()

    for what, proc in procs.items():
        try:
            so, se = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
        check(proc.returncode == 0, f"dry run {what}: exit "
                                    f"{proc.returncode}\n{so[-2000:]}"
                                    f"{se[-3000:]}")
    print(f"dry run: 2 pairs in {time.perf_counter() - t_dry:.1f} s "
          f"(subprocesses, torch {torch.__version__})")
    for what, name in (("granite-8b --decode-opt", "granite-8b"),
                       ("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b")):
        with open(os.path.join(out_dir,
                               f"{name}__decode_32k__single.json")) as f:
            rec = json.load(f)
        check(rec["ok"], f"dry run {what}: {rec.get('error')}")
        c = rec["collectives"]
        print(f"dry run MODELLED (fake tensors on a fake group of "
              f"{rec['chips']}, not measured): {what} x decode_32k x "
              f"single: {rec['cost']['flops']:.4e} FLOPs a card, argument "
              f"{rec['memory']['argument_size_in_bytes']} B, output "
              f"{rec['memory']['output_size_in_bytes']} B, collectives "
              f"{c['counts_by_op']} ({c['total_bytes']:.4e} B; all-reduce "
              f"by reduction {c['all_reduce_by_op']})")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline",
                        "--dir", out_dir], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    check(r.returncode == 0, f"roofline: {r.stderr[-2000:]}")
    print("roofline MODELLED (dry-run records and H100 data-sheet "
          "constants, not measured):")
    for line in r.stdout.splitlines():
        print(f"  {line}")
    return launches


def _free() -> None:
    """Release a finished path's device memory: the wrapped ``decode``
    methods of the fleet's counting hook form reference cycles, so
    collect them before emptying the allocator's cache."""
    gc.collect()
    torch.cuda.empty_cache()


def _wrappers() -> dict:
    """The kernel wrappers (the five kernels and the backwards of K2 and
    K5), each with its ``launches`` counter."""
    from repro_torch.kernels import bfio_swap as bs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rms_norm as rk
    from repro_torch.kernels import ssm_scan as ss
    return {"rms_norm": rk.rms_norm,
            "rms_norm_bwd": rk.rms_norm_bwd,
            "paged_decode_attention": pa.paged_decode_attention,
            "bfio_swap": bs.swap_best,
            "decode_attention": da.decode_attention,
            "ssm_chunk_scan": ss.ssm_chunk_scan,
            "ssm_chunk_scan_bwd": ss.ssm_chunk_scan_bwd}


def _zero_and_read(before):
    """``before is None``: zero every launch counter (just before a path).
    Otherwise return the counts since (just after it)."""
    ws = _wrappers()
    if before is None:
        for w in ws.values():
            w.launches = 0
        return {}
    return {name: w.launches for name, w in ws.items()}


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    return tree.numel()


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
            if "registers" in line or "spill" in line or "entry" in line:
                print(f"ptxas {src}: {line.strip()}")

    if sys.argv[1:2] == ["--phase"]:
        # one phase alone, for a quick check (not the smoke run: no result
        # line)
        quick = {"mesh": lambda: phase_mesh_path(dev, card),
                 "ssm": lambda: phase_ssm_scan(dev, torch.empty(
                     64 * 1024 * 1024, dtype=torch.int32, device=dev)),
                 "ssm_bwd": lambda: phase_ssm_scan_bwd(dev, torch.empty(
                     64 * 1024 * 1024, dtype=torch.int32, device=dev)),
                 "cross_train_ssm": lambda: phase_cross_device_train_ssm(
                     dev),
                 "train_zamba2": lambda: phase_train_path_ssm(card),
                 "mesh_train": lambda: phase_mesh_train_path(dev, card)}
        for name in sys.argv[2:]:
            check(name in quick, f"unknown phase {name}")
            print(json.dumps({name: quick[name]()}, default=str))
        return

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    kernels = [phase_rms_norm(dev), phase_rms_norm_bwd(dev)]
    # the timing method's floor: a one-element add timed as the kernels are
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: one.add_(1), flush=flush)
    print(f"timing floor: a one-element add measures {floor_ms * 1e3:.2f} "
          f"us by time_ms (sleep kernel, L2 flush, CUDA events)")
    for phase in (phase_paged_attention, phase_decode_attention):
        kernels.append(dict(phase(dev, flush), timing_floor_ms=floor_ms))
    kernels.append(dict(phase_ssm_scan(dev, flush),
                        timing_floor_ms=floor_ms))
    kernels.append(dict(phase_ssm_scan_bwd(dev, flush),
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
    for what, steps, imb, pre in phase_cross_device_loop(dev):
        print(f"cross-device loop: G=8 x B=8, wait_cap 256, 128 integer "
              f"sizes, {what}: {steps} steps, imbalance {imb:.1f}, {pre} "
              f"preemptions; every LoopState field equal on cpu and the "
              f"card")
    for what, toks in phase_cross_device_frontends(dev):
        print(f"cross-device frontends: {what} f32, {toks} tokens; stats "
              f"and generations equal on cpu and the card")
    print("cross-device frontends: whisper-tiny-smoke vec == ref on the "
          "card (stats, generations, workers)")
    for name, toks in phase_cross_device_ref(dev):
        print(f"cross-device ref: {name} f32 on the slot backend, "
              f"engine_mode=ref, {toks} tokens; stats and generations equal "
              f"on cpu and the card, and equal to the card's vec engine "
              f"(workers too)")
    ffn, engines = phase_cross_device_moe(dev)
    for shape, err in ffn:
        print(f"cross-device moe: moe_ffn {shape} f32 at qwen3-moe-30b-a3b's "
              f"widths, card against cpu max abs err {err:.3e} (<= 1e-4)")
    for what, toks, differ in engines:
        print(f"cross-device moe: {what} f32, {toks} tokens, stats equal on "
              f"cpu and the card; {differ} generated tokens differ")
    tr = phase_cross_device_train(dev)
    print(f"cross-device train: granite-8b-smoke f32, one gradient within "
          f"{tr['grad_err']:.3e} of each leaf's largest entry; 5 steps of "
          f"train, losses {['%.6f' % x for x in tr['losses']]} within "
          f"{tr['rel']:.3e} relative, parameters within "
          f"{tr['param_err']:.3e}; the CPU's step-4 checkpoint resumed on "
          f"the card: loss {tr['resume_loss']:.6f}, parameters within "
          f"{tr['resume_param_err']:.3e}; launch.train --smoke --steps 4 "
          f"on the card ({tr['launcher_s']:.1f} s): {tr['launcher']} "
          f"[{card}]")
    for name, vs_ctl, vs_cpu, ctl_cpu, losses, n_bwd in \
            phase_cross_device_train_ssm(dev):
        print(f"cross-device train: {name} f32, 4 x 160 tokens (K5 at chunk "
              f"128 over S padded to 256), loss {losses[0]:.6f} on the cpu "
              f"and {losses[1]:.6f} on the card; one gradient on the card "
              f"within {vs_ctl:.3e} of each leaf's largest entry of the "
              f"card's with K5's plain version and within {vs_cpu:.3e} of "
              f"the CPU's (that control {ctl_cpu:.3e} from the CPU's); K5's"
              f" backward {n_bwd} launches on the card [{card}]")

    paths = {"engine": phase_paged_path("granite-8b", "main path")}
    paths["moe"] = phase_paged_path("qwen3-moe-30b-a3b", "moe path")
    paths["vlm"] = phase_paged_path("llava-next-mistral-7b", "vlm path",
                                    slots=2, requests=16, max_seq_len=3072)
    paths.update({"fleet": phase_fleet_path(),
                  "slot_granite": phase_slot_path("granite-8b", 32),
                  "slot_zamba2": phase_slot_path("zamba2-1.2b", 32),
                  "slot_xlstm": phase_slot_path("xlstm-350m", 8),
                  "slot_whisper": phase_slot_path("whisper-tiny", 32),
                  "slot_granite_ref": phase_slot_path("granite-8b", 32,
                                                      engine_mode="ref"),
                  "mesh": phase_mesh_path(dev, card),
                  "device_loop": phase_device_loop_path(),
                  "train": phase_train_path(card),
                  "train_zamba2": phase_train_path_ssm(card),
                  "mesh_train": phase_mesh_train_path(dev, card)})

    train_paths = ("train", "train_zamba2", "mesh_train")
    for p, counts in paths.items():
        check(p in train_paths or counts["rms_norm_bwd"]
              == counts["ssm_chunk_scan_bwd"] == 0,
              f"{p} path: the serving path ran a kernel's backward")
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
            "kernel_only_ms", "scores_ms", "bound_share", "backward_of",
            "dscale_rel_err", "rel_err", "max_rel_err_all",
            "autograd_rel_err",
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
