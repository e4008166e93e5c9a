"""zamba2-7b [arXiv:2411.15242; unverified] — Mamba2 backbone + shared attention.

81 Mamba2 (SSD) layers with a weight-shared full-attention block applied every
9 SSM layers (the paper's shared transformer blocks in a 9 x 9 grouping).
The shared attention is H32/KV32 at head_dim 112.
"""
from .base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    norm_type="rmsnorm",
    act="swish",
    glu=True,
    rope_theta=1e4,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4, chunk_size=256),
    hybrid=HybridConfig(attn_every=9, shared_attn_blocks=1),
    subquadratic=True,
)
