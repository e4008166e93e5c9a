"""qwen2.5-14b [hf:Qwen/Qwen2.5-*] — dense GQA with QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    norm_type="rmsnorm",
    act="swish",
    glu=True,
    rope_theta=1e6,
)
