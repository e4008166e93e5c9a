"""olmo-1b [arXiv:2402.00838; hf] — dense, non-parametric LayerNorm."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparametric",
    act="swish",
    glu=True,
    rope_theta=1e4,
    tie_embeddings=True,
)
