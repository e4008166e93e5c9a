"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-*; unverified] — interleaved
MoE (128 routed top-1 + 1 shared expert every other layer, dense 16384 between).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    norm_type="rmsnorm",
    act="swish",
    glu=True,
    rope_theta=5e5,
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        d_ff_shared=8192,
        first_dense_layers=0,
        moe_every=2,
        d_ff_dense=16384,
    ),
)
