"""granite-8b [dense] — assigned architecture config."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=49152,
    source="arXiv:2405.04324 — llama-arch code model",
)
