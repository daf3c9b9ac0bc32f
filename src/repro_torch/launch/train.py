"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
...``

Without ``--smoke`` the full configuration trains on ``cuda`` in its own
dtype; ``--smoke`` takes the reduced same-family variant, and ``--device
cpu`` runs the plain PyTorch path on the CPU.  The weights are the port's
seeded random init (seed 0) and the data ``token_batches``, with the
reference's zero stubs for the vlm patches and the audio frames.  One card
only: ``--multi-pod`` (the reference's production mesh) is ROADMAP Queue
A item 12b.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs import get_config, get_smoke_config
from ..data import token_batches
from ..models import init_params, resolve_device
from ..training import AdamWConfig, train

__all__ = ["build_parser", "main"]


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


def main(argv=None) -> list[float]:
    args = build_parser().parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod: meshes are not ported yet (ROADMAP Queue A item "
            "12b); the port trains on one card")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"[train] {cfg.name}: {cfg.n_params()/1e6:.1f}M params, "
          f"device {device}")
    params = init_params(cfg, 0, device=device)

    def batches():
        for b in token_batches(vocab_size=cfg.vocab_size, batch=args.batch,
                               seq_len=args.seq, n_batches=args.steps):
            if cfg.family == "vlm":
                b["patches"] = np.zeros(
                    (args.batch, cfg.patch_tokens, cfg.d_model), np.float32)
            if cfg.family == "audio":
                b["frames"] = np.zeros(
                    (args.batch, cfg.encoder_seq, cfg.d_model), np.float32)
            yield b

    opt = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                      total_steps=args.steps)
    _, losses = train(cfg, params=params, batches=batches(), opt_cfg=opt,
                      ckpt_dir=args.ckpt_dir,
                      ckpt_every=max(args.steps // 2, 1)
                      if args.ckpt_dir else 0)
    print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps")
    return losses


if __name__ == "__main__":
    main()
