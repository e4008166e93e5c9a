"""Architecture registry: ``--arch <id>`` resolves here.

Registered: every arch of the reference: the seven transformer decoders
(dense, MLA + MoE, interleaved dense/MoE, and the vision-stub VLM), the
recurrent mamba2-780m (SSD) and zamba2-7b (SSD + a shared attention block),
and the encoder-decoder seamless-m4t-large-v2 (audio stub).
"""
from __future__ import annotations

from . import (
    deepseek_v3_671b,
    internvl2_2b,
    llama4_maverick,
    mamba2_780m,
    olmo_1b,
    qwen2_5_14b,
    qwen3_8b,
    seamless_m4t_v2,
    yi_9b,
    zamba2_7b,
)
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
    "qwen3-8b": qwen3_8b.CONFIG,
    "qwen2.5-14b": qwen2_5_14b.CONFIG,
    "yi-9b": yi_9b.CONFIG,
    "deepseek-v3-671b": deepseek_v3_671b.CONFIG,
    "llama4-maverick-400b-a17b": llama4_maverick.CONFIG,
    "internvl2-2b": internvl2_2b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
    "seamless-m4t-large-v2": seamless_m4t_v2.CONFIG,
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
