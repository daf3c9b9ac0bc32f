"""Model / architecture configuration schema.

Every assigned architecture is expressed as a ``ModelConfig``; reduced smoke
variants are derived with ``smoke_variant``.  Families:

  dense   — decoder-only transformer (GQA, RoPE, SwiGLU)
  moe     — dense attention + top-k routed expert FFN (expert parallel)
  ssm     — xLSTM-style recurrent blocks (mLSTM / sLSTM), no KV cache
  hybrid  — Mamba2 blocks with a periodically applied *shared* attention
            block (Zamba2)
  vlm     — decoder-only LM consuming interleaved image-patch embeddings
            (vision tower is a stub per the assignment carve-out)
  audio   — encoder-decoder backbone consuming precomputed audio-frame
            embeddings (conv/mel frontend is a stub)
"""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "smoke_variant"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance auxiliary loss
    # --- SSM / hybrid ---
    ssm_state: int = 0               # N: state size per head (mamba2)
    ssm_heads: int = 0               # number of SSM heads (0 -> n_heads)
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_conv_width: int = 4          # causal depthwise conv kernel
    slstm_every: int = 0             # xLSTM: every k-th block is sLSTM
    attn_every: int = 0              # zamba2: shared attn after every k SSMs
    # --- attention ---
    rope_theta: float = 1e4
    qkv_bias: bool = False
    sliding_window: int = 0          # 0 = full causal attention
    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed frame-embedding length
    # --- vlm ---
    patch_tokens: int = 0            # image patch-embedding tokens per sample
    # --- misc ---
    mlp_variant: str = "swiglu"      # "swiglu" (3 mats) | "gelu" (2 mats)
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    source: str = ""                 # citation for the assigned config

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or self.n_heads

    @property
    def has_kv_cache(self) -> bool:
        return self.family != "ssm"

    def n_params(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, v = self.d_model, self.vocab_size
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        di, N, H = self.d_inner, self.ssm_state, self.n_ssm_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
        ffn_mats = 3 if self.mlp_variant == "swiglu" else 2
        per_ffn = ffn_mats * d * self.d_ff
        per_moe = 3 * d * self.moe_d_ff * self.n_experts + d * self.n_experts
        # mamba2 block: in_proj (z,x,B,C,dt) + out_proj
        per_mamba = d * (2 * di + 2 * N + H) + di * d
        # mlstm block: up (2di) + qkv (3 di^2) + gates + out
        per_mlstm = d * 2 * di + 3 * di * di + di * 2 * H + di * d
        # slstm block: gates (4 d^2) + recurrent + small ffn (2x 2d^2)
        per_slstm = 4 * d * d + 4 * d * (d // max(H, 1)) + 4 * d * d

        if self.family == "ssm":
            n_s = self.n_layers // self.slstm_every if self.slstm_every else 0
            n_m = self.n_layers - n_s
            return int(emb + n_m * per_mlstm + n_s * per_slstm)
        if self.family == "hybrid":
            n_attn_apps = self.n_layers // (self.attn_every + 1)
            n_ssm = self.n_layers - n_attn_apps
            # shared attn block: ONE weight set (tied across applications)
            return int(emb + n_ssm * per_mamba + per_attn + per_ffn)
        n_dec = self.n_layers
        block = per_attn + (per_moe if self.is_moe else per_ffn) + 2 * d
        total = emb + n_dec * block
        if self.encoder_layers:
            total += self.encoder_layers * (per_attn + per_ffn)
            total += n_dec * per_attn  # cross attention
        return int(total)

    def active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        dense_part = self.n_params() - 3 * d * self.moe_d_ff * self.n_experts \
            * self.n_layers
        active_ffn = 3 * d * self.moe_d_ff * self.experts_per_token \
            * self.n_layers
        return int(dense_part + active_ffn)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts."""
    d = min(cfg.d_model, 256)
    nh = max(2, min(cfg.n_heads, 4))
    nkv = max(1, min(cfg.n_kv_heads, nh))
    hd = max(8, d // nh)
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=d,
        n_heads=nh,
        n_kv_heads=nkv,
        head_dim=hd,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else cfg.d_ff,
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
    )
    if cfg.is_moe:
        changes.update(n_experts=4, experts_per_token=2,
                       moe_d_ff=min(cfg.moe_d_ff, 128))
    if cfg.family in ("ssm", "hybrid"):
        changes.update(ssm_state=min(cfg.ssm_state or 16, 16),
                       ssm_heads=max(2, min(cfg.n_ssm_heads, 4)))
        if cfg.slstm_every:
            changes.update(slstm_every=2)
        if cfg.attn_every:
            changes.update(attn_every=1)
    if cfg.encoder_layers:
        changes.update(encoder_layers=1, encoder_seq=min(cfg.encoder_seq, 64))
    if cfg.patch_tokens:
        changes.update(patch_tokens=min(cfg.patch_tokens, 16))
    return dataclasses.replace(cfg, **changes)
