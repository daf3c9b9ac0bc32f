"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
...``

Without ``--smoke`` the full configuration trains on ``cuda`` in its own
dtype; ``--smoke`` takes the reduced same-family variant, and ``--device
cpu`` runs the plain PyTorch path on the CPU.  The weights are the port's
seeded random init (seed 0) and the data ``token_batches``, with the
reference's zero stubs for the vlm patches and the audio frames.

Training always runs under a mesh, as the reference's launcher does
(params placed by the train-mode rules, FSDP over ``"data"``):

* ``--device cpu``: ``make_cpu_mesh()``, a one-rank gloo group;
* on the card, one process (or ``torchrun`` with a world size of one):
  the (1, 1) mesh over a one-rank NCCL group;
* ``torchrun`` with more ranks: the reference's single-pod production
  mesh, 16 x 16, which needs 256 ranks; ``--multi-pod`` the 2 x 16 x 16
  one, which needs 512.  On another world size either raises, naming the
  world size it needs; it never falls back to fewer cards.

A process group the launcher starts, it destroys on the way out.
"""
from __future__ import annotations

import argparse
import os
import socket

import numpy as np

from ..configs import get_config, get_smoke_config
from ..data import token_batches
from ..models import init_params, resolve_device
from ..training import AdamWConfig, train
from .mesh import _make_mesh, make_cpu_mesh, make_production_mesh, mesh_shape

__all__ = ["build_parser", "main", "make_train_mesh", "train_batches"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced variant (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    return ap


def train_batches(cfg, *, batch: int, seq_len: int, n_batches: int,
                  seed: int = 0):
    """``token_batches`` with the reference launcher's stubs for the
    inputs a model family adds: ``patches`` (batch, patch_tokens, d) for
    vlm and ``frames`` (batch, encoder_seq, d) for audio, float32 zeros.
    A generator of dicts of numpy arrays."""
    for b in token_batches(vocab_size=cfg.vocab_size, batch=batch,
                           seq_len=seq_len, n_batches=n_batches, seed=seed):
        if cfg.family == "vlm":
            b["patches"] = np.zeros((batch, cfg.patch_tokens, cfg.d_model),
                                    np.float32)
        if cfg.family == "audio":
            b["frames"] = np.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                   np.float32)
        yield b


def _start_group(device) -> None:
    """The default process group: from ``torchrun``'s environment when it
    set one (NCCL for CUDA tensors, gloo for CPU ones), else one rank:
    gloo on an in-memory store for the CPU, NCCL on a free localhost port
    for the card."""
    import torch
    import torch.distributed as dist
    cuda = device.type == "cuda"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("cpu:gloo,cuda:nccl" if cuda else "gloo")
    elif not cuda:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        torch.cuda.set_device(torch.cuda.current_device()
                              if device.index is None else device.index)
        dist.init_process_group("cpu:gloo,cuda:nccl",
                                init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)


def make_train_mesh(device, *, multi_pod: bool = False):
    """The launcher's mesh (see the module docstring); starts the default
    process group when there is none."""
    import torch.distributed as dist
    if not dist.is_initialized():
        _start_group(device)
    if multi_pod:
        return make_production_mesh(multi_pod=True,
                                    device_type=device.type)
    if device.type == "cpu":
        return make_cpu_mesh()
    if dist.get_world_size() == 1:
        return _make_mesh((1, 1), ("data", "model"), "cuda")
    return make_production_mesh()


def main(argv=None) -> list[float]:
    import torch.distributed as dist
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    started = not dist.is_initialized()
    try:
        mesh = make_train_mesh(device, multi_pod=args.multi_pod)
        print(f"[train] {cfg.name}: {cfg.n_params()/1e6:.1f}M params, "
              f"device {device}, mesh {mesh_shape(mesh)}")
        params = init_params(cfg, 0, device=device)
        opt = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          total_steps=args.steps)
        batches = train_batches(cfg, batch=args.batch, seq_len=args.seq,
                                n_batches=args.steps)
        _, losses = train(cfg, params=params, batches=batches,
                          opt_cfg=opt, mesh=mesh, ckpt_dir=args.ckpt_dir,
                          ckpt_every=max(args.steps // 2, 1)
                          if args.ckpt_dir else 0)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps")
    return losses


if __name__ == "__main__":
    main()
