"""granite-moe-3b-a800m [moe] — assigned architecture config."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=0, moe_d_ff=512, n_experts=40, experts_per_token=8,
    vocab_size=49155,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base family — 40 experts "
           "top-8 (40 % 16 != 0 -> TP-within-expert sharding)",
)
