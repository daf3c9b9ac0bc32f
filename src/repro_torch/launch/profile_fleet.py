"""Where a fleet step's time goes on the card:
``python -m repro_torch.launch.profile_fleet --arch granite-8b
--replicas 4 --cache-backend paged --policy bfio_h0 --router bfio
--scenario flash_crowd --requests 64 [--skip-steps 4]
[--profile-steps 12]``.

Builds the same fleet as :mod:`repro_torch.launch.serve` (fleet mode,
one shared copy of the weights), runs ``--skip-steps`` fleet steps to
warm up, then records the next ``--profile-steps`` fleet steps with
``torch.profiler`` and prints: the steps' wall time (host clock, each
step ends in a device sync), the host time spent in the router's solve,
the device's busy time (the sum of kernel times: one stream, so kernels
do not overlap), the idle share, the swap-search kernel's device time,
share and launches a routing step, the device kernels each routing step
launches (the kernel launches the profiler records inside the router's
``route``), the paged attention kernel's (K1's) time a launch, and the
kernels that take the most device time.  ``--chrome-trace PATH`` writes
the Chrome trace.  It needs a card.  The replicas' decode steps and the
router's solve run as the fleet runs them on the card, each a replayed
CUDA graph (:mod:`repro_torch.core.graphs`; a replay is one
``cudaGraphLaunch``, counted with the kernel launches); ``--eager``
profiles them op by op (``graphs.eager()``), the path before capture.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..core import graphs
from .profile_decode import _device_us
from .serve import build_parser, make_fleet, make_model

__all__ = ["main"]

_SOLVE = "router_solve"
_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
             "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


def _labelled(route):
    """``route`` inside a profiler range, so that the kernel launches of
    the router's solve can be told from the replicas'."""
    def run(ctx):
        with record_function(_SOLVE):
            return route(ctx)
    return run


def _solve_launches(prof) -> int:
    """Kernel launches (host runtime calls) inside the solve ranges."""
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == _SOLVE]
    return sum(1 for e in events if e.name in _LAUNCHES
               and any(a <= e.time_range.start <= b for a, b in spans))


def main(argv=None) -> None:
    ap = build_parser()
    ap.add_argument("--skip-steps", type=int, default=4)
    ap.add_argument("--profile-steps", type=int, default=12)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--chrome-trace", default=None)
    ap.add_argument("--eager", action="store_true",
                    help="run the decode and the solve op by op "
                    "(graphs.eager())")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or args.device != "cuda":
        raise RuntimeError("profile_fleet measures the card: it needs "
                           "CUDA and --device cuda")
    with graphs.eager() if args.eager else contextlib.nullcontext():
        _profile(args)


def _profile(args) -> None:
    built = make_fleet(args, *make_model(args))
    fleet, router = built["fleet"], built["router"]
    router.inner.route = _labelled(router.inner.route)
    for _ in range(args.skip_steps):
        if fleet.has_work():
            fleet.step()
    torch.cuda.synchronize()
    n_solve = len(router.seconds)
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        while len(walls) < args.profile_steps and fleet.has_work():
            t0 = time.perf_counter()
            fleet.step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    wall_us = 1e6 * sum(walls)
    solve = router.seconds[n_solve:]
    cuda = torch.autograd.DeviceType.CUDA
    # the solve's range shows on the device's timeline too: not a kernel
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda and _device_us(e) > 0
               and e.key != _SOLVE]
    busy_us = sum(_device_us(e) for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    swap = [e for e in kernels if "swap_best" in e.key]
    swap_us = sum(_device_us(e) for e in swap)
    n_route = max(len(solve), 1)
    split = [e for e in kernels if "split_kernel" in e.key]
    merge = [e for e in kernels if "merge_kernel" in e.key]
    print(f"[profile] fleet of {fleet.R} x {fleet.engines[0].cfg.name} "
          f"({'op by op' if args.eager else 'captured'}) on "
          f"{torch.cuda.get_device_name(0)}: {len(walls)} fleet steps "
          f"(after {args.skip_steps}), wall {wall_us / 1e3:.2f} ms, "
          f"device busy {busy_us / 1e3:.2f} ms, idle share "
          f"{1 - busy_us / wall_us:.1%}")
    print(f"[profile] router: {len(solve)} solves, "
          f"{1e3 * sum(solve):.2f} ms host ({1e6 * sum(solve) / wall_us:.1%}"
          f" of the wall), {1e3 * sum(solve) / n_route:.3f} ms a routing "
          f"step; swap-search kernel {swap_us / 1e3:.3f} ms device "
          f"({swap_us / busy_us:.4%} of busy), "
          f"{sum(e.count for e in swap) / n_route:.2f} launches a routing "
          f"step; {_solve_launches(prof) / n_route:.1f} device kernels "
          f"launched a routing step")
    for name, evs in (("split pass", split), ("merge", merge)):
        n = sum(e.count for e in evs)
        if n:
            print(f"[profile] paged attention (K1) {name}: "
                  f"{sum(_device_us(e) for e in evs) / n:.2f} us a launch, "
                  f"{n} launches")
    kernels.sort(key=_device_us, reverse=True)
    for e in kernels[:args.top]:
        print(f"[profile] {_device_us(e) / 1e3:9.3f} ms "
              f"{_device_us(e) / busy_us:6.1%} x{e.count:<6d} {e.key[:90]}")
    if args.chrome_trace:
        prof.export_chrome_trace(args.chrome_trace)
        print(f"[profile] trace -> {args.chrome_trace}")


if __name__ == "__main__":
    main()
