"""xlstm-350m [ssm] — assigned architecture config."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304,
    ssm_heads=4, ssm_expand=2, slstm_every=8,  # xLSTM[7:1]
    source="arXiv:2405.04517 — sLSTM + mLSTM blocks, no KV cache "
           "(delta_k == 0 workload class)",
)
