"""deepseek-v3-671b [arXiv:2412.19437; hf] — MLA + 1 shared + 256 routed top-8 MoE.

First 3 layers are dense (d_ff 18432); the remaining 58 are MoE with
2048-wide experts. The MTP head is out of scope, as in the reference.
"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=2048,
    vocab_size=129280,
    norm_type="rmsnorm",
    act="swish",
    glu=True,
    rope_theta=1e4,
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        d_ff_shared=2048,
        first_dense_layers=3,
        moe_every=1,
        d_ff_dense=18432,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
)
