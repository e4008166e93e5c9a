"""internvl2-2b [arXiv:2404.16821; hf] — InternLM2-1.8B backbone + ViT stub.

The modality frontend is a stub: the cache-free ``forward`` takes
precomputed patch embeddings (``batch["frontend_embeds"]``, frontend_tokens x
d_model) and prepends them to the text-token embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    norm_type="rmsnorm",
    act="swish",
    glu=True,
    rope_theta=1e6,
    frontend="vision",
    frontend_tokens=256,
)
