"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
--policy bfio_h8 --cache-backend paged`` — drives the BF-IO-routed
multi-worker engine end to end on one card.

Without ``--smoke`` the full configuration runs in its own dtype (bf16)
on ``cuda``; ``--smoke`` takes the reduced same-family variant, and
``--device cpu`` runs the plain PyTorch path on the CPU.  The engine's
stats are the reference's MODELLED time and energy (``step_overhead +
t_token * max load`` under the A100 power model); the launcher also
prints the MEASURED wall-clock time of the run on the device, apart from
them.

Memory-pressure knobs (``--cache-backend paged``): ``--pool-blocks``,
``--preemption-mode swap|recompute``, ``--preemption-policy
lifo|fifo|largest`` and ``--prefix-cache``, as in the reference.  The
fleet tier (``--replicas`` > 1, ``--scenario``, ``--async``,
``--autoscale``, telemetry and trace export) is not ported yet and raises
``NotImplementedError`` (ROADMAP Queue A item 7).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core import make_policy
from ..models import init_params, resolve_device
from ..serving import EngineConfig, ServeRequest, ServingEngine

__all__ = ["build_parser", "make_engine", "submit_requests", "serve",
           "main"]

_FLEET_TODO = ("the fleet tier is not ported yet — ROADMAP Queue A item 7 "
               "(fleet tier)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--policy", default="bfio_h8")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-backend", default="slot",
                    choices=["slot", "paged"],
                    help="KV layout (only 'paged' is ported)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: max prompt tokens per request "
                         "per step (0 = synchronous)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="total prompt tokens per step across requests "
                         "(0 = same as --prefill-chunk)")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="paged KV pool size in blocks (0 = capacity for "
                         "every slot at max_seq_len)")
    ap.add_argument("--preemption-mode", default="swap",
                    choices=["swap", "recompute"])
    ap.add_argument("--preemption-policy", default="lifo",
                    choices=["lifo", "fifo", "largest"])
    ap.add_argument("--prefix-cache", action="store_true")
    # fleet-tier flags of the reference launcher: accepted, not ported
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--router", default="bfio")
    ap.add_argument("--fleet-mode", default="vec", choices=["vec", "ref"])
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--replica-classes", default=None)
    ap.add_argument("--predictor", default=None, choices=["oracle"])
    ap.add_argument("--async", dest="async_fleet", action="store_true")
    ap.add_argument("--autoscale", default=None, choices=["util", "slo"])
    ap.add_argument("--r-min", type=int, default=1)
    ap.add_argument("--r-max", type=int, default=0)
    ap.add_argument("--slo-ttft", type=float, default=1.0)
    ap.add_argument("--slo-tpot", type=float, default=0.1)
    ap.add_argument("--scenario", default=None)
    ap.add_argument("--telemetry-out", default=None)
    ap.add_argument("--trace-out", default=None)
    return ap


def _check_single_engine(args) -> None:
    if (args.replicas > 1 or args.scenario or args.telemetry_out
            or args.replica_classes or args.pods > 1 or args.async_fleet
            or args.autoscale or args.trace_out or args.predictor):
        raise NotImplementedError(_FLEET_TODO)


def make_engine(args) -> ServingEngine:
    """The launcher's engine: config (smoke or full), the port's own
    seeded init on the device, and the single-engine ``EngineConfig`` of
    the reference launcher."""
    _check_single_engine(args)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    params = init_params(cfg, args.seed, device=device)
    engine_cfg = EngineConfig(
        n_workers=args.workers, slots_per_worker=args.slots,
        max_seq_len=256, cache_backend=args.cache_backend,
        prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget,
        paged_pool_blocks=args.pool_blocks,
        preemption_mode=args.preemption_mode,
        preemption_policy=args.preemption_policy,
        prefix_cache=args.prefix_cache)
    return ServingEngine(cfg, params, engine_cfg, make_policy(args.policy),
                         device=device)


def submit_requests(eng: ServingEngine, n: int, max_new: int,
                    seed: int) -> list:
    """The reference launcher's synthetic stream: prompts of 4..63 random
    tokens, all arriving at t=0."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        r = ServeRequest(
            rid=i,
            tokens=rng.integers(1, eng.cfg.vocab_size,
                                size=int(rng.integers(4, 64))),
            max_new_tokens=max_new)
        eng.submit(r)
        reqs.append(r)
    return reqs


def serve(args, eng: ServingEngine = None, max_steps: int = 10_000) -> dict:
    """Build (unless given) and run one engine over the synthetic stream.
    Returns the engine, its requests, the modelled ``stats`` and the
    measured wall-clock numbers (host clock around each step, which ends
    in a device sync); ``decode_step_ms`` averages the steps whose only
    work was decode."""
    eng = eng or make_engine(args)
    reqs = submit_requests(eng, args.requests, args.max_new, args.seed)
    cuda = eng.device.type == "cuda"
    step_s, decode_s = [], []
    decoded_steps = 0      # steps that ran one paged decode call
    t0 = time.perf_counter()
    while eng.wait or eng.table.active.any():
        if eng.steps >= max_steps:
            raise RuntimeError("engine exceeded max_steps")
        ts = time.perf_counter()
        info = eng.step()
        if cuda:
            torch.cuda.synchronize(eng.device)
        dt = time.perf_counter() - ts
        step_s.append(dt)
        decoded_steps += info["decoded"] > 0
        if info["phase"] == "decode":
            decode_s.append(dt)
    wall = time.perf_counter() - t0
    stats = eng.stats()
    return {
        "engine": eng, "requests": reqs, "stats": stats,
        "measured": {
            "device": (torch.cuda.get_device_name(eng.device) if cuda
                       else "cpu"),
            "wall_s": wall,
            "steps": len(step_s),
            "decoded_steps": decoded_steps,
            "decode_phase_steps": len(decode_s),
            "decode_step_ms": (1e3 * float(np.mean(decode_s))
                               if decode_s else float("nan")),
            "tokens_per_s": stats["tokens"] / wall if wall > 0 else 0.0,
        },
    }


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    out = serve(args)
    eng, stats, meas = out["engine"], out["stats"], out["measured"]
    print(f"[serve] {eng.cfg.name} policy={stats['policy']} (modelled, "
          f"A100 power model): {stats['tokens']} tokens in "
          f"{stats['steps']} steps, {stats['throughput_tok_s']:.1f} tok/s, "
          f"E={stats['energy_j']:.1f} J, "
          f"avg imbalance {stats['avg_imbalance']:.1f}")
    print(f"[serve] measured on {meas['device']}: {meas['wall_s']:.3f} s "
          f"wall, {meas['decode_step_ms']:.2f} ms per decode step, "
          f"{meas['tokens_per_s']:.1f} tok/s")
    if args.cache_backend == "paged":
        per_block = eng.backend.pool_bytes() // eng.backend.n_blocks
        dense = per_block * eng.backend.N * eng.backend.max_blocks
        print(f"[serve] paged KV: peak resident "
              f"{eng.kv_peak_bytes / 1e6:.2f} MB "
              f"({eng.kv_peak_bytes / max(dense, 1):.1%} of the "
              f"{dense / 1e6:.2f} MB the slot layout pins)")
        if stats["preemptions"]:
            print(f"[serve] memory pressure: {stats['preemptions']} "
                  f"preemptions ({args.preemption_mode}), "
                  f"{stats['tokens_swapped']} KV tokens swapped, "
                  f"{stats['tokens_recomputed']} recomputed")
        if args.prefix_cache:
            print(f"[serve] prefix cache: {stats['prefix_hits']}/"
                  f"{stats['prefix_queries']} block hits "
                  f"({stats['prefix_hit_rate']:.1%})")


if __name__ == "__main__":
    main()
