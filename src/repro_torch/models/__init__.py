"""Unified model API (port of ``repro.models``); dense and MoE (MLA) families so far."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import EngineContext

from . import blocks, mla, params as P, transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig

    def specs(self):
        return transformer.decoder_specs(self.cfg)

    def init(self, generator: torch.Generator, dtype=torch.float32):
        """Random parameters on the generator's device."""
        return P.init(self.specs(), generator, dtype)

    def load_numpy(self, tree, device):
        """The reference's raw parameter tree (numpy leaves) on ``device``."""
        return P.load_numpy_params(tree, device, specs=self.specs())

    def forward(self, prms, batch, ctx: EngineContext, *, remat: bool = False):
        """Cache-free forward: ``batch["tokens"]`` (B, S) -> (logits, aux)."""
        return transformer.forward(prms, batch, self.cfg, ctx, remat=remat)

    def decode_step(self, prms, tokens, cache, ctx: EngineContext):
        return transformer.decode_step(prms, tokens, cache, self.cfg, ctx)

    def make_cache(self, batch: int, max_len: int, dtype=torch.float32, device=None):
        return transformer.make_cache(self.cfg, batch, max_len, dtype, device)


def get_model(cfg: ModelConfig) -> ModelApi:
    cfg.validate()
    return ModelApi(cfg)


__all__ = ["ModelApi", "get_model", "blocks", "mla", "transformer"]
