"""zamba2-1.2b [hybrid] — assigned architecture config."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_heads=32, ssm_expand=2,
    attn_every=5,  # 6 shared-attn applications + 2 tail mamba blocks
    source="arXiv:2411.15242 — Mamba2 blocks + shared attention block "
           "(weight-tied applications); fractional KV drift",
)
