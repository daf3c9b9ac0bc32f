"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
--policy bfio_h8 [--cache-backend slot|paged]`` — drives the BF-IO-routed
multi-worker engine end to end on one card.  The slot backend (the
default) serves the dense, moe (qwen3-moe-30b-a3b, granite-moe-3b-a800m),
ssm (xlstm-350m) and hybrid (zamba2-1.2b) families; the paged backend
serves the dense and moe families.

Without ``--smoke`` the full configuration runs in its own dtype (bf16)
on ``cuda``; ``--smoke`` takes the reduced same-family variant, and
``--device cpu`` runs the plain PyTorch path on the CPU.  The engine's
stats are the reference's MODELLED time and energy (``step_overhead +
t_token * max load`` under the A100 power model); the launcher also
prints the MEASURED wall-clock numbers of the run on the device, apart
from them.

Memory-pressure knobs (``--cache-backend paged``): ``--pool-blocks``,
``--preemption-mode swap|recompute``, ``--preemption-policy
lifo|fifo|largest`` and ``--prefix-cache``, as in the reference.

Fleet mode (``--replicas R`` with R > 1, or ``--scenario``, or any other
fleet flag): R engine replicas over ONE shared copy of the weights,
behind a fleet router (``--router round_robin | least_loaded | pod2 |
bfio[_hH][_affinity] | pod_bfio_pP[_hH][_affinity]``) whose BF-IO solve
runs on the same device (on a card, the swap search is the Hopper
kernel), on a named scenario trace (``--scenario``) or the synthetic
stream at t=0.  The other fleet knobs are the reference's:
``--fleet-mode vec|ref``, ``--pods P`` (shortcut for ``pod_bfio_pP``),
``--replica-classes 2xg1b2,2xg2b4``, ``--predictor oracle``, ``--async``,
``--autoscale util|slo`` with ``--r-min`` / ``--r-max``, ``--slo-ttft`` /
``--slo-tpot``, ``--telemetry-out run.jsonl`` and ``--trace-out
run.trace``.  Measured beside the modelled fleet stats: fleet wall
seconds, mean fleet-step ms, router-solve ms per routing step (host
clock around the solve, the device synchronised on both sides),
generated tokens per second and peak device memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import re
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core import make_policy
from ..fleet import (
    AsyncFleetServer,
    FleetRouter,
    FleetServer,
    FleetTelemetry,
    SLOSpec,
    make_autoscaler,
    make_router,
    make_scenario,
)
from ..fleet.workloads import SCENARIOS as FLEET_SCENARIOS
from ..models import init_params, resolve_device
from ..obs import SpanRecorder, read_trace, write_trace
from ..serving import EngineConfig, ServeRequest, ServingEngine

__all__ = ["build_parser", "make_model", "make_engine", "submit_requests",
           "serve", "is_fleet", "parse_replica_classes", "TimedRouter",
           "make_fleet", "serve_fleet", "main"]


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
                    help="KV layout: 'slot' (contiguous per-slot rows, "
                         "every ported family) or 'paged' (vLLM blocks, "
                         "attention-family models)")
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="fleet mode: engine replicas behind the router "
                         "(1 = bare engine)")
    ap.add_argument("--router", default="bfio",
                    help="fleet router: round_robin | least_loaded | "
                         "pod2 | bfio[_hH][_affinity] | "
                         "pod_bfio[_pP][_hH][_affinity]")
    ap.add_argument("--fleet-mode", default="vec", choices=["vec", "ref"],
                    help="vectorized fleet hot path or the O(R) per-step "
                         "re-gather loop (identical stats)")
    ap.add_argument("--pods", type=int, default=1,
                    help="with P > 1, route with pod_bfio_pP (overrides "
                         "--router)")
    ap.add_argument("--replica-classes", default=None,
                    help="heterogeneous fleet, e.g. '2xg1b2,2xg2b4' "
                         "(overrides --replicas/--workers/--slots)")
    ap.add_argument("--predictor", default=None, choices=["oracle"],
                    help="feed each request's decode budget to the router "
                         "as its predicted output length")
    ap.add_argument("--async", dest="async_fleet", action="store_true",
                    help="event-driven fleet instead of the barrier one")
    ap.add_argument("--autoscale", default=None, choices=["util", "slo"],
                    help="autoscaling policy (implies --async)")
    ap.add_argument("--r-min", type=int, default=1)
    ap.add_argument("--r-max", type=int, default=0,
                    help="autoscaler ceiling (0 = --replicas)")
    ap.add_argument("--slo-ttft", type=float, default=1.0)
    ap.add_argument("--slo-tpot", type=float, default=0.1)
    ap.add_argument("--scenario", default=None,
                    choices=sorted(FLEET_SCENARIOS),
                    help="named scenario trace for fleet mode (timed "
                         "arrivals); omitted = synthetic stream at t=0")
    ap.add_argument("--telemetry-out", default=None,
                    help="write fleet telemetry to this JSONL path")
    ap.add_argument("--trace-out", default=None,
                    help="write per-request spans as Chrome trace-event "
                         "JSON and print the straggler ledger")
    return ap


def is_fleet(args) -> bool:
    """The reference launcher's rule: any fleet flag selects the fleet."""
    return bool(args.replicas > 1 or args.scenario or args.telemetry_out
                or args.replica_classes or args.pods > 1
                or args.async_fleet or args.autoscale or args.trace_out)


def make_model(args):
    """(cfg, params, device): the smoke or full config with the port's
    own seeded init, one copy on the device."""
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    return cfg, init_params(cfg, args.seed, device=device), device


def _engine_cfg(args) -> EngineConfig:
    return EngineConfig(
        n_workers=args.workers, slots_per_worker=args.slots,
        max_seq_len=256, cache_backend=args.cache_backend,
        prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget,
        paged_pool_blocks=args.pool_blocks,
        preemption_mode=args.preemption_mode,
        preemption_policy=args.preemption_policy,
        prefix_cache=args.prefix_cache)


def make_engine(args) -> ServingEngine:
    """The launcher's single engine: config (smoke or full), the port's
    own seeded init on the device, and the reference launcher's
    ``EngineConfig``."""
    cfg, params, device = make_model(args)
    return ServingEngine(cfg, params, _engine_cfg(args),
                         make_policy(args.policy), device=device)


def _synthetic(vocab_size: int, n: int, max_new: int, seed: int) -> list:
    """The reference launcher's synthetic stream: prompts of 4..63 random
    tokens, all arriving at t=0."""
    rng = np.random.default_rng(seed)
    return [ServeRequest(
        rid=i, tokens=rng.integers(1, vocab_size,
                                   size=int(rng.integers(4, 64))),
        max_new_tokens=max_new) for i in range(n)]


def submit_requests(eng: ServingEngine, n: int, max_new: int,
                    seed: int) -> list:
    reqs = _synthetic(eng.cfg.vocab_size, n, max_new, seed)
    for r in reqs:
        eng.submit(r)
    return reqs


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def serve(args, eng: ServingEngine = None, max_steps: int = 10_000,
          requests: list = None) -> dict:
    """Build (unless given) and run one engine over ``requests`` (default:
    the synthetic stream).  Returns the engine, its requests, the modelled
    ``stats`` and the measured wall-clock numbers (host clock around each
    step, which ends in a device sync); ``decode_step_ms`` averages the
    steps whose only work was decode."""
    eng = eng or make_engine(args)
    if requests is None:
        reqs = submit_requests(eng, args.requests, args.max_new, args.seed)
    else:
        reqs = list(requests)
        for r in reqs:
            eng.submit(r)
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
            "device": _device_name(eng.device),
            "wall_s": wall,
            "steps": len(step_s),
            "decoded_steps": decoded_steps,
            "decode_phase_steps": len(decode_s),
            "decode_step_ms": (1e3 * float(np.mean(decode_s))
                               if decode_s else float("nan")),
            "tokens_per_s": stats["tokens"] / wall if wall > 0 else 0.0,
        },
    }


# ----------------------------------------------------------------------
# fleet mode
# ----------------------------------------------------------------------

def parse_replica_classes(spec: str, engine_cfg):
    """``"2xg1b2,2xg2b4"`` -> [(2, ec(G=1,B=2)), (2, ec(G=2,B=4))]:
    each ``CxgGbB`` group adds C replicas with G workers x B slots,
    inheriting every other knob from the base engine config."""
    out = []
    for part in spec.split(","):
        m = re.fullmatch(r"(\d+)xg(\d+)b(\d+)", part.strip())
        if not m:
            raise ValueError(
                f"bad replica class {part!r} (want e.g. '2xg1b2')")
        count, g, b = (int(x) for x in m.groups())
        out.append((count, dataclasses.replace(
            engine_cfg, n_workers=g, slots_per_worker=b)))
    return out


class TimedRouter(FleetRouter):
    """A router wrapper that measures each routing call: host seconds
    around ``route``, with the device synchronised before and after so
    the solve's kernels fall inside.  Every other attribute (``name``,
    ``affinity_weight``, ...) is the wrapped router's."""

    def __init__(self, inner: FleetRouter, device: torch.device):
        self.inner = inner
        self.name = inner.name
        self._cuda = device.type == "cuda"
        self.seconds: list[float] = []

    def __getattr__(self, key):
        return getattr(self.inner, key)

    def reset(self) -> None:
        self.inner.reset()

    def route(self, ctx) -> np.ndarray:
        if self._cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.inner.route(ctx)
        if self._cuda:
            torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out


def make_fleet(args, cfg, params, device) -> dict:
    """The fleet of the reference launcher (barrier or async, with its
    router, classes, predictor, telemetry and recorder) over the one
    shared ``params`` on ``device``, with its requests submitted."""
    engine_cfg = _engine_cfg(args)
    router = f"pod_bfio_p{args.pods}" if args.pods > 1 else args.router
    router = TimedRouter(make_router(router), device)
    classes = parse_replica_classes(args.replica_classes, engine_cfg) \
        if args.replica_classes else None
    n_replicas = sum(c for c, _ in classes) if classes else args.replicas
    telemetry = FleetTelemetry(
        slo=SLOSpec(ttft_s=args.slo_ttft, tpot_s=args.slo_tpot))
    recorder = SpanRecorder() if args.trace_out else None
    common = dict(n_replicas=args.replicas, router=router,
                  policy=args.policy, device=device, telemetry=telemetry,
                  seed=args.seed, fleet_mode=args.fleet_mode,
                  replica_classes=classes, predictor=args.predictor,
                  obs=recorder)
    if args.async_fleet or args.autoscale:
        autoscaler = None
        if args.autoscale:
            autoscaler = make_autoscaler(
                args.autoscale, r_min=args.r_min,
                r_max=args.r_max or n_replicas)
        fleet = AsyncFleetServer(cfg, params, engine_cfg,
                                 autoscaler=autoscaler, **common)
    else:
        fleet = FleetServer(cfg, params, engine_cfg, **common)
    if args.scenario:
        fleet.submit_scenario(make_scenario(
            args.scenario, n_requests=args.requests,
            n_replicas=n_replicas, n_workers=args.workers,
            slots_per_worker=args.slots,
            max_seq_len=engine_cfg.max_seq_len,
            vocab_size=cfg.vocab_size, seed=args.seed))
    else:
        for r in _synthetic(cfg.vocab_size, args.requests, args.max_new,
                            args.seed):
            fleet.submit(r)
    return {"fleet": fleet, "router": router, "telemetry": telemetry,
            "recorder": recorder}


def serve_fleet(args, built: dict = None, max_steps: int = 100_000) -> dict:
    """Build the model and the fleet (unless ``built``, from
    :func:`make_fleet`, is given), run it to completion, and return the
    fleet, its modelled ``stats``, the telemetry summary and the measured
    numbers (host clock around each fleet step, which ends in a device
    sync)."""
    built = built or make_fleet(args, *make_model(args))
    fleet, router = built["fleet"], built["router"]
    device = fleet.device
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    step_s = []
    t0 = time.perf_counter()
    while fleet.has_work():
        if fleet.steps >= max_steps:
            raise RuntimeError("fleet exceeded max_steps")
        ts = time.perf_counter()
        fleet.step()
        if cuda:
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    stats = fleet.stats()
    solve = router.seconds
    return {
        **built, "stats": stats, "summary": built["telemetry"].summary(),
        "measured": {
            "device": _device_name(device),
            "wall_s": wall,
            "fleet_steps": len(step_s),
            "fleet_step_ms": (1e3 * float(np.mean(step_s))
                              if step_s else float("nan")),
            "routing_steps": len(solve),
            "router_solve_ms": (1e3 * float(np.mean(solve))
                                if solve else float("nan")),
            "tokens_per_s": stats["tokens"] / wall if wall > 0 else 0.0,
            "peak_memory_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                               if cuda else float("nan")),
        },
    }


def _print_fleet(args, out) -> None:
    stats, summary, meas = out["stats"], out["summary"], out["measured"]
    fleet = out["fleet"]
    print(f"[fleet] {fleet.engines[0].cfg.name} R={stats['n_replicas']} "
          f"router={stats['router']} "
          f"scenario={args.scenario or 'synthetic'} (modelled, A100 power "
          f"model): {stats['tokens']} tokens in {stats['steps']} steps, "
          f"{stats['throughput_tok_s']:.1f} tok/s, "
          f"E={stats['energy_j']:.1f} J "
          f"({stats['idle_j']:.1f} J barrier idle), "
          f"{stats['energy_per_token']:.3f} J/tok, "
          f"cross-replica imbalance {stats['avg_cross_imbalance']:.1f}")

    def _s(x):     # percentiles are None when nothing completed
        return "n/a" if x is None else f"{x:.3f}s"

    print(f"[fleet] requests: {stats['completed']} done, "
          f"{stats['failed']} failed; "
          f"TTFT p95 {_s(summary['ttft']['p95'])}, "
          f"latency p95 {_s(summary['latency']['p95'])}, "
          f"SLO attainment {summary['slo_attainment']:.0%}")
    print(f"[fleet] measured on {meas['device']}: {meas['wall_s']:.3f} s "
          f"wall, {meas['fleet_step_ms']:.2f} ms per fleet step "
          f"({meas['fleet_steps']} steps), router solve "
          f"{meas['router_solve_ms']:.2f} ms per routing step "
          f"({meas['routing_steps']} steps), {meas['tokens_per_s']:.1f} "
          f"tok/s, peak memory {meas['peak_memory_gb']:.2f} GB")
    if stats.get("fleet_kind") == "async":
        print(f"[fleet] async: utilization {stats['utilization']:.0%}, "
              f"mean replicas on {stats['r_on_mean']:.2f}/"
              f"{stats['n_replicas']}, "
              f"{stats['scale_ups']} scale-ups / "
              f"{stats['scale_downs']} scale-downs, "
              f"{stats['drain_handoffs']} drain handoffs "
              f"({stats['drain_tokens_lost']} tokens recomputed)")
    tel = out["telemetry"]
    if args.telemetry_out:
        tel.write_jsonl(args.telemetry_out)
        print(f"[fleet] telemetry -> {args.telemetry_out} "
              f"({len(tel.steps)} step + {len(tel.requests)} request "
              f"records)")
    if out["recorder"] is not None:
        write_trace(out["recorder"], args.trace_out)
        seen = read_trace(args.trace_out)   # validate what was written
        print(f"[fleet] trace -> {args.trace_out} "
              f"({seen['n_points']} points, "
              f"{len(seen['requests'])} request spans)")
        ledger = fleet.straggler_ledger()
        top = max(ledger["by_cause"].items(),
                  key=lambda kv: kv[1], default=(None, 0.0))
        print(f"[fleet] straggler ledger: "
              f"{ledger['total_idle_j']:.1f} J idle attributed over "
              f"{ledger['charges']} charges; top cause {top[0]} "
              f"({top[1]:.1f} J)")


def _print_engine(args, out) -> None:
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


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if is_fleet(args):
        _print_fleet(args, serve_fleet(args))
    else:
        _print_engine(args, serve(args))


if __name__ == "__main__":
    main()
