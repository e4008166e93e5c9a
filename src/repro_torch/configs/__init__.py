"""Architecture registry: ``--arch <id>`` resolves here.

Registered so far: olmo-1b (dense) and deepseek-v3-671b (MLA + MoE); the
other architectures arrive with their model families.
"""
from __future__ import annotations

from . import deepseek_v3_671b, olmo_1b
from .base import (
    TORCH_DTYPES,
    EncDecConfig,
    HybridConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    reduced,
)

ARCHS = {
    "olmo-1b": olmo_1b.CONFIG,
    "deepseek-v3-671b": deepseek_v3_671b.CONFIG,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    cfg = ARCHS[arch]
    cfg.validate()
    return cfg


__all__ = [
    "ARCHS",
    "TORCH_DTYPES",
    "get_config",
    "reduced",
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "HybridConfig",
    "EncDecConfig",
]
