"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a, one process per source, all at once (timed,
   with the compiler's register report).
3. Kernel phases, at the shapes of the serving paths: the RMS-norm
   kernel (K2) on (32, 4096) bf16 and the paged decode-attention kernel
   (K1) at B=32, Hq=32, Hkv=8, hd=128, block 16, 16 blocks per row (bf16
   pool, permuted tables, ragged lengths including 1 and 256); the
   contiguous decode-attention kernel (K3) at granite-8b's slot shape
   (B=32, Hq=32, Hkv=8, hd=128, L=256) and zamba2's (Hq=Hkv=32, hd=64),
   with a rolling case (lengths past L) and a sliding-window case (bf16,
   ragged lengths including 1 and L); each held against its plain
   PyTorch version (bf16, atol = rtol = 2e-2).  The chunked-scan kernel
   (K5) on float32 inputs as the models pass them, at zamba2's prefill
   shape (B=32, S=64, H=32, dk=64, dv=128, chunk 64), at xlstm's (H=4,
   dk=512, dv=513) and at a ragged S that ``ops.ssm_chunk_scan`` pads,
   held against its plain version at 1e-3 (y and the final state).  The
   BF-IO swap-search kernel (K4) at the fleet router's shape (C=1, G=4,
   N=64, W=1, integer loads) and at pod scale (C=8, G=32, N=512, W=9,
   random floats, ragged ``valid``, ``assign`` with -1s), held against its
   plain version bit for bit (``best_val`` everywhere, ``best_j`` on
   finite rows).  Each is timed with CUDA events beside its bound, its
   plain version and, where one exists, a one-call PyTorch yardstick the
   port never calls.
4. Cross-device checks on a small input: float32 smoke configs served on
   the CPU (plain versions) and on the card (kernels) with the same
   weights.  granite-8b-smoke on the paged backend; then a fleet of 4
   replicas under ``bfio``, under ``pod_bfio_p2`` and as an
   ``AsyncFleetServer`` with the utilization autoscaler; then the slot
   backend with granite-8b-smoke (synchronous and chunked prefill),
   zamba2-1.2b-smoke and xlstm-350m-smoke.  Stats (and telemetry rows)
   and generations equal.
5. The single-engine path: ``repro_torch.launch.serve`` on full
   granite-8b (36 layers, bf16, seeded random weights), paged backend,
   bfio_h8, 4 workers x 8 slots, 32 requests of 16 new tokens.  Launch
   counters are zeroed just before and read just after; K1 and K2 must
   have run on every decode step.  The engine is freed afterwards.
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

The second-to-last line is ``{"kernels": [...]}``; the last line is
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


def compare(name, got, want, tol=TOL):
    torch.cuda.synchronize()
    check(torch.isfinite(got.float()).all().item(), f"{name}: non-finite")
    err = (got.float() - want.float()).abs()
    ok = (err <= tol["atol"] + tol["rtol"] * want.float().abs()).all().item()
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


def _swap_inputs(dev, C, G, N, W, *, seed, n_valid=None):
    """Swap-search inputs.  With ``n_valid`` the router's shape: integer
    loads and prefill sizes, the first ``n_valid`` rows of the padded
    bucket valid and assigned; without, random floats with ragged
    ``valid`` and ``assign`` holding -1s (the reference's fixtures)."""
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
    return (torch.from_numpy(loads).to(dev), torch.from_numpy(cands).to(dev),
            torch.from_numpy(assign.astype(np.int32)).to(dev),
            torch.from_numpy(valid).to(dev))


def _swap_case(dev, C, G, N, W, **kw):
    from repro_torch.kernels import bfio_swap as bs
    args = _swap_inputs(dev, C, G, N, W, **kw)
    vk, ak = bs.swap_best(*args)
    vp, ap = bs.swap_best_plain(*args)
    torch.cuda.synchronize()
    fin = torch.isfinite(vp)
    check(torch.equal(vk, vp), f"bfio_swap C={C} N={N} W={W}: best_val "
          f"differs from the plain version (max abs err "
          f"{(vk - vp).abs().nan_to_num().max().item():.3e})")
    check(torch.equal(ak[fin], ap[fin]),
          f"bfio_swap C={C} N={N} W={W}: best_j differs on finite rows")
    check(bool(fin.any().item()), f"bfio_swap C={C}: no feasible pair")
    prepped = bs.swap_prep(*args)
    loads, cands, assign, valid = args
    ms = time_ms(lambda: bs.swap_best(*args))
    kernel_ms = time_ms(lambda: bs._launch(*prepped, cands, G))
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
    return dict(max_abs_err=0.0, ms=ms, kernel_only_ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, feasible_pairs=pairs,
                shape=f"C={C} G={G} N={N} W={W}")


def phase_bfio_swap(dev):
    """K4 at the fleet router's shape (its power-of-two bucket of 64
    candidates, 24 real) and at pod scale; bit-identical to plain."""
    fleet = _swap_case(dev, 1, 4, 64, 1, seed=11, n_valid=24)
    pod = _swap_case(dev, 8, 32, 512, 9, seed=12)
    for k in (fleet, pod):
        print(f"kernel bfio_swap [{k['shape']}]: {k['ms'] * 1e3:.2f} us "
              f"(kernel alone {k['kernel_only_ms'] * 1e3:.2f} us; bound "
              f"{k['bound_ms'] * 1e3:.3f} us by {k['bound_by']}, "
              f"{k['feasible_pairs']} feasible pairs), plain "
              f"{k['plain_ms'] * 1e3:.2f} us, library none, bit-identical")
    return dict(name="bfio_swap", route="cuda",
                source="src/repro_torch/kernels/csrc/bfio_swap.cu",
                replaces="src/repro/kernels/bfio_swap.py:126",
                **{k: fleet[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape", "kernel_only_ms")},
                at_pod_scale={k: pod[k] for k in (
                    "shape", "ms", "kernel_only_ms", "plain_ms",
                    "bound_ms", "bound_by")})


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
    tok = int((hi - lo).sum().item())
    nbytes = 2 * tok * Hkv * hd * 2 + 2 * B * Hq * hd * 2 + B * 4
    b_ms, b_by = bound(nbytes, 4.0 * Hq * hd * tok)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, live_tokens=tok,
                shape=f"{mode}: B={B} Hq={Hq} Hkv={Hkv} hd={hd} L={L}"
                      + (f" window={window}" if window else "") + " bf16")


def phase_decode_attention(dev, flush):
    """K3 at granite-8b's slot shape (the row's numbers), zamba2's shape,
    a rolling cache with lengths past L and a sliding window."""
    cases = [
        _decode_case(dev, flush, 32, 32, 8, 128, 256, mode="causal",
                     seed=21),
        _decode_case(dev, flush, 32, 32, 32, 64, 256, mode="causal",
                     seed=22),
        _decode_case(dev, flush, 32, 32, 8, 128, 256, mode="rolling",
                     seed=23),
        _decode_case(dev, flush, 32, 32, 8, 128, 256, mode="window",
                     window=96, seed=24),
    ]
    for c in cases:
        print(f"kernel decode_attention [{c['shape']}, {c['live_tokens']} "
              f"live tokens]: {c['ms'] * 1e3:.2f} us (bound "
              f"{c['bound_ms'] * 1e3:.2f} us by {c['bound_by']}), plain "
              f"{c['plain_ms'] * 1e3:.2f} us, SDPA "
              f"{c['library_ms'] * 1e3:.2f} us, max abs err "
              f"{c['max_abs_err']:.3e}")
    main = cases[0]
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:75",
                **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms", "shape")},
                max_abs_err_all=max(c["max_abs_err"] for c in cases),
                cases=[{k: c[k] for k in ("shape", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "max_abs_err")}
                       for c in cases[1:]])


def _ssm_case(dev, flush, B, S, H, dk, dv, chunk, *, seed):
    """K5 on float32 inputs (the reference's fixture: a <= 0, g >= 0),
    through ``ops.ssm_chunk_scan`` (which pads a ragged S), against the
    plain version on the same padded inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k = (torch.randn((B, S, H, dk), generator=g, device=dev)
            for _ in "qk")
    v = torch.randn((B, S, H, dv), generator=g, device=dev)
    a = -torch.randn((B, S, H), generator=g, device=dev).abs()
    gi = torch.randn((B, S, H), generator=g, device=dev).abs()
    pad = (-S) % chunk
    Sp = S + pad

    def padseq(x):
        return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))

    y, st = ops.ssm_chunk_scan(q, k, v, a, gi, chunk=chunk)
    padded = [padseq(x) for x in (q, k, v, a, gi)]
    y0, st0 = ss.ssm_chunk_scan_plain(*padded, chunk=chunk)
    tol = dict(atol=1e-3, rtol=1e-3)
    err = max(compare("ssm_chunk_scan y", y, y0[:, :S], tol),
              compare("ssm_chunk_scan state", st, st0, tol))
    ms = time_ms(lambda: ss.ssm_chunk_scan(*padded, chunk=chunk),
                 flush=flush)
    plain_ms = time_ms(lambda: ss.ssm_chunk_scan_plain(*padded, chunk=chunk),
                       flush=flush)
    # bytes: q, k, v, a, g read once, y and the state written once;
    # operations: the chunked form's multiply-adds (lower-triangle scores
    # and W v, q . S_prev and the state update), two flops each
    nc = Sp // chunk
    tri = chunk * (chunk + 1) // 2
    fma = B * H * nc * (tri * (dk + dv) + 2 * chunk * dk * dv)
    nbytes = 4 * (B * Sp * H * (2 * dk + 2 * dv + 2) + B * H * dk * dv)
    b_ms, b_by = bound(nbytes, 2.0 * fma)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"B={B} S={S}" + (f" (padded to {Sp})" if pad else "")
                      + f" H={H} dk={dk} dv={dv} chunk={chunk} f32")


def phase_ssm_scan(dev, flush):
    """K5 at zamba2's prefill shape (the row's numbers), xlstm's mLSTM
    shape and a ragged S."""
    cases = [
        _ssm_case(dev, flush, 32, 64, 32, 64, 128, 64, seed=31),
        _ssm_case(dev, flush, 32, 64, 4, 512, 513, 64, seed=32),
        _ssm_case(dev, flush, 8, 100, 32, 64, 128, 64, seed=33),
    ]
    for c in cases:
        print(f"kernel ssm_chunk_scan [{c['shape']}]: {c['ms'] * 1e3:.2f} us"
              f" (bound {c['bound_ms'] * 1e3:.2f} us by {c['bound_by']}), "
              f"plain {c['plain_ms'] * 1e3:.2f} us, library none, max abs "
              f"err {c['max_abs_err']:.3e}")
    main = cases[0]
    return dict(name="ssm_chunk_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssm_scan.cu",
                replaces="src/repro/kernels/ssm_scan.py:73",
                **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms", "shape")},
                max_abs_err_all=max(c["max_abs_err"] for c in cases),
                cases=[{k: c[k] for k in ("shape", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "max_abs_err")}
                       for c in cases[1:]])


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
    kernels = [phase_rms_norm(dev, flush), phase_paged_attention(dev, flush)]
    for k in kernels:
        print(f"kernel {k['name']} [{k['shape']}]: {k['ms'] * 1e3:.2f} us "
              f"(bound {k['bound_ms'] * 1e3:.2f} us by {k['bound_by']}), "
              f"plain {k['plain_ms'] * 1e3:.2f} us, library "
              f"{k['library_ms'] * 1e3:.2f} us, max abs err "
              f"{k['max_abs_err']:.3e}")
    kernels.append(phase_decode_attention(dev, flush))
    kernels.append(phase_ssm_scan(dev, flush))
    del flush

    kernels.append(phase_bfio_swap(dev))

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

    from repro_torch.launch.serve import build_parser, make_engine, serve
    args = build_parser().parse_args(
        ["--arch", "granite-8b", "--policy", "bfio_h8", "--cache-backend",
         "paged", "--workers", "4", "--slots", "8", "--requests", "32",
         "--max-new", "16", "--seed", "0"])
    t0 = time.perf_counter()
    eng = make_engine(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    launches = _zero_and_read(None)
    out = serve(args, eng)
    launches = _zero_and_read(launches)
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
    check(launches["rms_norm"] > 0 and launches["paged_decode_attention"] > 0,
          "main path: a kernel of the path never launched")
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

    del eng, out, reqs
    torch.cuda.empty_cache()
    paths = {"engine": launches, "fleet": phase_fleet_path(),
             "slot_granite": phase_slot_path("granite-8b", 32),
             "slot_zamba2": phase_slot_path("zamba2-1.2b", 32),
             "slot_xlstm": phase_slot_path("xlstm-350m", 8)}

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
            "kernel_only_ms", "at_pod_scale", "shape", "max_abs_err_all",
            "cases") if key in k})
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
