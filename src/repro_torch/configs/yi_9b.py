"""yi-9b [arXiv:2403.04652; hf] — llama-arch GQA (kv=4)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    norm_type="rmsnorm",
    act="swish",
    glu=True,
    rope_theta=1e4,
)
