"""Where a train step's time goes on the card:
``python -m repro_torch.launch.profile_train [--arch granite-8b]
[--layers 8] [--batch 2] [--seq 4096] [--profile-steps 2]``.

Builds the train path of ``chip_smoke.py``: the full-width configuration
with its depth cut to ``--layers`` (0 keeps it whole: ``--arch
zamba2-1.2b --layers 0`` is the hybrid train path), float32 master
weights from the port's seeded init, bfloat16 compute, remat a layer,
AdamW, and the training launcher's batches (``launch.train.train_batches``:
the vlm projector's ``patches`` and the audio encoder's ``frames`` as zero
stubs);
runs one step to warm up, then records ``--profile-steps`` steps
of ``make_train_step`` with ``torch.profiler`` and prints: the steps'
wall time (host clock, each step ends in a device sync), the device's
busy time (the sum of kernel times), the idle share, the device kernels
a step, the RMS-norm kernel's (K2's) and the chunked scan's (K5's) and
their backwards' launches and time, the shares of the GEMMs, of PyTorch's
elementwise and reduction kernels and of its scans (the MoE capacity
count's cumsum), index kernels (the MoE dispatch's gathers and their
backward; ``index_elementwise_kernel`` is also in "elementwise") and
sorts (the MoE router's), and the kernels that take the most device time.
``--chrome-trace PATH`` writes the Chrome trace.  It needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..models import init_params
from ..training import AdamWConfig, init_opt_state, make_train_step
from .profile_decode import _device_us
from .train import train_batches

__all__ = ["main"]

# name fragments of the GEMM kernels cuBLAS picks on Hopper
_GEMM = ("gemm", "nvjet", "xmma", "cutlass", "sm90")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch."
                                      "profile_train")
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--profile-steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--chrome-trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train measures the card: it needs CUDA")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = init_params(dataclasses.replace(cfg, dtype="float32"), 0)
    opt = init_opt_state(params)
    step = make_train_step(cfg, AdamWConfig(), donate=True)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in train_batches(cfg, batch=args.batch,
                                      seq_len=args.seq,
                                      n_batches=args.profile_steps + 1)]
    loss, params, opt = step(params, opt, batches[0])
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches[1:]:
            t0 = time.perf_counter()
            loss, params, opt = step(params, opt, b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    n = len(walls)
    wall_us = 1e6 * sum(walls)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    print(f"[profile] train step, {cfg.name} at {cfg.n_layers} layers, "
          f"batch {args.batch} x {args.seq}, on "
          f"{torch.cuda.get_device_name(0)}: {n} steps, wall "
          f"{wall_us / 1e3:.2f} ms ({wall_us / 1e3 / n:.2f} a step), device "
          f"busy {busy_us / 1e3:.2f} ms, idle share "
          f"{1 - busy_us / wall_us:.1%}, loss {float(loss):.4f}")
    launches = sum(e.count for e in kernels)
    print(f"[profile] device kernel launches: {launches / n:.1f} a step")
    groups = {
        "K2 forward (rms_norm)": lambda k: "rms_norm" in k
        and "bwd" not in k,
        "K2 backward (rms_norm_bwd)": lambda k: "rms_norm_bwd" in k,
        "K5 forward (ssm_chunk_scan)": lambda k: "ssm_s" in k,
        # six device kernels a call
        "K5 backward (ssm_chunk_scan_bwd)": lambda k: "ssm_bwd" in k,
        "GEMMs": lambda k: any(g in k.lower() for g in _GEMM),
        "elementwise": lambda k: "elementwise" in k,
        "reductions": lambda k: "reduce" in k.lower(),
        "scans (cumsum)": lambda k: "scan" in k.lower() and "ssm" not in k,
        "index (gather, index_put)": lambda k: "index" in k.lower(),
        "sorts": lambda k: "sort" in k.lower(),
    }
    for name, hit in groups.items():
        sel = [e for e in kernels if hit(e.key)]
        us = sum(_device_us(e) for e in sel)
        cnt = sum(e.count for e in sel)
        print(f"[profile] {name}: {us / 1e3 / n:.2f} ms a step, "
              f"{us / busy_us:.1%} of device busy, {cnt / n:.1f} launches a "
              f"step" + (f", {us / cnt:.2f} us each" if cnt else ""))
    kernels.sort(key=_device_us, reverse=True)
    for e in kernels[:args.top]:
        print(f"[profile] {_device_us(e) / 1e3 / n:9.3f} ms a step "
              f"{_device_us(e) / busy_us:6.1%} x{e.count // n:<6d} "
              f"{e.key[:90]}")
    if args.chrome_trace:
        prof.export_chrome_trace(args.chrome_trace)
        print(f"[profile] trace -> {args.chrome_trace}")


if __name__ == "__main__":
    main()
