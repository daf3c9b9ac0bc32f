"""granite-34b [dense] — assigned architecture config."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    mlp_variant="gelu",
    source="arXiv:2405.04324 — llama-arch code model, MQA (kv=1)",
)
