"""The 4 assigned input shapes and ``input_specs()``: meta-device tensors
standing in for every model input (shape and dtype only, no storage; the
dry-run pattern).

Decode shapes describe ``serve_step`` (ONE new token against a KV cache
of ``seq_len``), not ``train_step``.  ``long_500k`` requires
sub-quadratic attention: native for ssm/hybrid; dense/moe/vlm/audio run
it via the sliding-window variant (rolling KV buffer).
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ModelConfig

__all__ = ["InputShape", "SHAPES", "get_shape", "input_specs",
           "LONG_CONTEXT_WINDOW", "config_for_shape"]

LONG_CONTEXT_WINDOW = 8192  # sliding window used for long_500k on
                            # full-attention archs (beyond-paper variant)

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]


def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-dependent config adjustments: long_500k switches the pure
    full-attention families to the sliding-window variant (rolling KV).
    Hybrid zamba2 keeps full attention: its few shared-attention
    applications hold little KV."""
    if (shape.name == "long_500k" and cfg.sliding_window == 0
            and cfg.family in ("dense", "moe", "vlm", "audio")):
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_specs(cfg: ModelConfig, batch: int) -> dict:
    from ..models.transformer import torch_dtype  # lazy: avoid cycle
    dtype = torch_dtype(cfg.dtype)
    out = {}
    if cfg.family == "vlm":
        out["patches"] = _spec((batch, cfg.patch_tokens, cfg.d_model), dtype)
    if cfg.family == "audio":
        out["frames"] = _spec((batch, cfg.encoder_seq, cfg.d_model), dtype)
    return out


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Meta-tensor stand-ins for the step function's inputs.

    train  -> {tokens, targets, mask (+frontend)}
    prefill-> {tokens, lengths (+frontend)}
    decode -> {tokens (B,), cache (the init_cache tree, on meta)}
    """
    cfg = config_for_shape(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        specs = {"tokens": _spec((B, S), i32),
                 "targets": _spec((B, S), i32),
                 "mask": _spec((B, S), torch.float32)}
        specs.update(_frontend_specs(cfg, B))
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": _spec((B, S), i32), "lengths": _spec((B,), i32)}
        specs.update(_frontend_specs(cfg, B))
        return specs
    if shape.kind == "decode":
        from ..models.transformer import init_cache  # lazy: avoid cycle
        return {"tokens": _spec((B,), i32),
                "cache": init_cache(cfg, B, S, device="meta")}
    raise ValueError(shape.kind)
