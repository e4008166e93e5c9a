"""seamless-m4t-large-v2 [arXiv:2308.11596; hf] — encoder-decoder, audio stub.

24-layer speech encoder over precomputed frame embeddings (the conformer
frontend is a stub: ``batch["frontend_embeds"]``) + 24-layer text decoder
with cross-attention. head_dim = 1024/16 = 64.
"""
from .base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    norm_type="layernorm",
    act="relu",
    glu=False,
    rope_theta=1e4,
    encdec=EncDecConfig(encoder_layers=24, encoder_seq_factor=1.0),
    frontend="audio",
)
