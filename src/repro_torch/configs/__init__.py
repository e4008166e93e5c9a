"""Architecture registry: ``--arch <id>`` resolves here.

Only olmo-1b is registered so far; the other architectures arrive with their
model families.
"""
from __future__ import annotations

from . import olmo_1b
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
