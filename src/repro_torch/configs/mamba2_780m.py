"""mamba2-780m [arXiv:2405.21060; unverified] — pure SSD (state-space duality),
attention-free. d_inner = 2*1536 = 3072, 48 SSD heads of dim 64, state 128."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    norm_type="rmsnorm",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk_size=256),
    subquadratic=True,
)
