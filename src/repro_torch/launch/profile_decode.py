"""Where a decode step's time goes on the card:
``python -m repro_torch.launch.profile_decode --arch granite-8b
--cache-backend paged [serve flags] [--profile-steps 4]``.

Builds the same engine as :mod:`repro_torch.launch.serve`, runs the
synthetic stream until the first decode-only step, then records the next
``--profile-steps`` decode-only steps with ``torch.profiler`` and prints:
the steps' wall time (host clock, each step ends in a device sync), the
device's busy time (the sum of kernel times: one stream, so kernels do
not overlap), the idle share, the device kernels launched a step, the
RMS-norm kernel's (K2's) launches and device time per launch, the share
of PyTorch's elementwise kernels, and the kernels that take the most
device time.  ``--chrome-trace PATH`` writes the Chrome trace.  It needs a
card.  The decode steps run as the engine runs them on the card, one
replayed CUDA graph a step (:mod:`repro_torch.core.graphs`); ``--eager``
profiles them op by op (``graphs.eager()``), the path before capture.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..core import graphs
from .serve import build_parser, make_engine, submit_requests

__all__ = ["main"]


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def main(argv=None) -> None:
    ap = build_parser()
    ap.add_argument("--profile-steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--chrome-trace", default=None)
    ap.add_argument("--eager", action="store_true",
                    help="run the decode op by op (graphs.eager())")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or args.device != "cuda":
        raise RuntimeError("profile_decode measures the card: it needs "
                           "CUDA and --device cuda")
    with graphs.eager() if args.eager else contextlib.nullcontext():
        _profile(args)


def _profile(args) -> None:
    eng = make_engine(args)
    submit_requests(eng, args.requests, args.max_new, args.seed)
    while True:                      # warm up through prefill
        info = eng.step()
        if info["phase"] == "decode" or not (eng.wait
                                             or eng.table.active.any()):
            break
    torch.cuda.synchronize()
    walls, n = [], 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        while n < args.profile_steps and eng.table.active.any():
            t0 = time.perf_counter()
            info = eng.step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            n += info["phase"] == "decode"
    wall_us = 1e6 * sum(walls)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    print(f"[profile] {eng.cfg.name} "
          f"({'op by op' if args.eager else 'captured'}) on "
          f"{torch.cuda.get_device_name(0)}: "
          f"{len(walls)} steps ({n} decode-only), wall "
          f"{wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms, "
          f"idle share {1 - busy_us / wall_us:.1%}")
    launches = sum(e.count for e in kernels)
    print(f"[profile] device kernel launches: {launches} in {len(walls)} "
          f"steps, {launches / len(walls):.1f} a step")
    norm = [e for e in kernels if "rms_norm" in e.key]
    n_norm = sum(e.count for e in norm)
    if n_norm:
        norm_us = sum(_device_us(e) for e in norm)
        print(f"[profile] K2 (rms_norm): {n_norm} launches, "
              f"{norm_us / n_norm:.2f} us each, {norm_us / busy_us:.1%} of "
              f"device busy")
    elem_us = sum(_device_us(e) for e in kernels if "elementwise" in e.key)
    print(f"[profile] elementwise kernels: {elem_us / busy_us:.1%} of "
          f"device busy")
    kernels.sort(key=_device_us, reverse=True)
    for e in kernels[:args.top]:
        print(f"[profile] {_device_us(e) / 1e3:9.3f} ms "
              f"{_device_us(e) / busy_us:6.1%} x{e.count:<6d} {e.key[:90]}")
    if args.chrome_trace:
        prof.export_chrome_trace(args.chrome_trace)
        print(f"[profile] trace -> {args.chrome_trace}")


if __name__ == "__main__":
    main()
