"""minitron-4b [dense] — assigned architecture config."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256000,
    mlp_variant="gelu",
    source="arXiv:2407.14679 — pruned nemotron, 256k vocabulary",
)
