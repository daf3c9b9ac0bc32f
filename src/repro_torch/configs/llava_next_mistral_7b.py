"""llava-next-mistral-7b [vlm] — assigned architecture config."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000, rope_theta=1e6,
    patch_tokens=2880,  # anyres tiling: ~5 tiles x 576 patches (stub ViT)
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf — anyres tiling; vision "
           "tower is a stub (precomputed patch embeddings)",
)
