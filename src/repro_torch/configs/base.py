"""Model configuration system (PyTorch port of ``repro.configs.base``).

The dataclasses, field names and defaults are the reference's, so a config
compares field for field with its JAX twin. ``dtype`` stays a string; the
port maps it to a torch dtype through :data:`TORCH_DTYPES`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    first_dense_layers: int = 0
    moe_every: int = 1
    d_ff_dense: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    num_heads: int = 0
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    attn_every: int = 9
    shared_attn_blocks: int = 1


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int = 24
    encoder_seq_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | hybrid | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric
    act: str = "swish"
    glu: bool = True
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[str] = None
    frontend_tokens: int = 256
    dtype: str = "bfloat16"
    subquadratic: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.dtype]

    @property
    def kv_groups(self) -> int:
        return max(1, self.num_heads // max(self.num_kv_heads, 1))

    def validate(self) -> None:
        if self.num_heads:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name
        if self.moe:
            assert self.family in ("moe",), self.name
        if self.family == "ssm":
            assert self.ssm is not None
        if self.family == "hybrid":
            assert self.ssm is not None and self.hybrid is not None
        if self.family == "audio":
            assert self.encdec is not None



@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell shape. ``kind`` selects which step the dry run
    traces: ``train``, ``prefill`` or ``decode``."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """The reference's skip rule: ``long_500k`` only for sub-quadratic mixers."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "quadratic full attention at 524k ctx — architecturally inapplicable"
    return True, ""

def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 128) -> ModelConfig:
    """Family-preserving small config for CPU smoke tests (the reference's rules)."""
    scale = d_model / cfg.d_model
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    head_dim = max(16, d_model // heads)
    updates = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=heads if cfg.num_heads else 0,
        num_kv_heads=kv if cfg.num_heads else 0,
        head_dim=head_dim,
        d_ff=max(32, int(cfg.d_ff * scale)) if cfg.d_ff else 0,
        vocab_size=256,
        frontend_tokens=8,
        dtype="float32",
    )
    if cfg.moe:
        updates["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            d_ff_shared=64 if cfg.moe.num_shared_experts else 0,
            d_ff_dense=64 if cfg.moe.d_ff_dense else 0,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
        )
    if cfg.mla:
        updates["mla"] = MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16
        )
        updates["head_dim"] = 16
    if cfg.ssm:
        updates["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=16, chunk_size=32, num_heads=0
        )
    if cfg.hybrid:
        updates["hybrid"] = dataclasses.replace(cfg.hybrid, attn_every=max(1, layers // 2))
    if cfg.encdec:
        updates["encdec"] = dataclasses.replace(cfg.encdec, encoder_layers=layers)
    return dataclasses.replace(cfg, **updates)
