"""whisper-tiny [audio] — assigned architecture config."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51865,
    encoder_layers=4, encoder_seq=1500,  # 30 s of mel frames (stub conv)
    source="arXiv:2212.04356 — enc-dec; conv/mel frontend is a stub "
           "(precomputed frame embeddings)",
)
