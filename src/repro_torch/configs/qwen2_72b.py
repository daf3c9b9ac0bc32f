"""qwen2-72b [dense] — assigned architecture config."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    source="arXiv:2407.10671 — GQA kv=8, QKV bias",
)
