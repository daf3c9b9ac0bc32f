"""Registry of the 10 assigned architectures (one module per arch, each
citing its source).  ``--arch <id>`` selects one in the launchers;
``smoke_variant`` derives the reduced CPU-testable variant."""
from __future__ import annotations

from . import (
    granite_34b,
    granite_8b,
    granite_moe_3b_a800m,
    llava_next_mistral_7b,
    minitron_4b,
    qwen2_72b,
    qwen3_moe_30b_a3b,
    whisper_tiny,
    xlstm_350m,
    zamba2_1p2b,
)
from .base import ModelConfig, smoke_variant

__all__ = ["ARCHS", "get_config", "get_smoke_config", "list_archs"]

_MODULES = [
    qwen3_moe_30b_a3b,
    whisper_tiny,
    granite_moe_3b_a800m,
    llava_next_mistral_7b,
    xlstm_350m,
    zamba2_1p2b,
    granite_34b,
    minitron_4b,
    qwen2_72b,
    granite_8b,
]

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke_config(name: str) -> ModelConfig:
    return smoke_variant(get_config(name))


def list_archs() -> list[str]:
    return sorted(ARCHS)
