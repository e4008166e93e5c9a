"""Unified model API over every arch family (port of ``repro.models``): the
decoder-only families (dense, MoE with MLA, vision stub, SSM, hybrid) in
``transformer``, the encoder-decoder (audio stub) in ``encdec``."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import EngineContext

from . import blocks, encdec, mamba2, mla, params as P, transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig

    def specs(self):
        if self.cfg.family == "audio":
            return encdec.encdec_specs(self.cfg)
        return transformer.decoder_specs(self.cfg)

    def init(self, generator: torch.Generator, dtype=torch.float32):
        """Random parameters on the generator's device."""
        return P.init(self.specs(), generator, dtype)

    def load_numpy(self, tree, device):
        """The reference's raw parameter tree (numpy leaves) on ``device``."""
        return P.load_numpy_params(tree, device, specs=self.specs())

    def forward(self, prms, batch, ctx: EngineContext, *, remat: bool = False):
        """Cache-free forward: ``batch["tokens"]`` (B, S) -> (logits, aux)."""
        if self.cfg.family == "audio":
            return encdec.forward(prms, batch, self.cfg, ctx, remat=remat)
        return transformer.forward(prms, batch, self.cfg, ctx, remat=remat)

    def decode_step(self, prms, tokens, cache, ctx: EngineContext):
        if self.cfg.family == "audio":
            return encdec.decode_step(prms, tokens, cache, self.cfg, ctx)
        return transformer.decode_step(prms, tokens, cache, self.cfg, ctx)

    def make_cache(self, batch: int, max_len: int, dtype=torch.float32, device=None):
        if self.cfg.family == "audio":
            return encdec.make_cache(self.cfg, batch, max_len, dtype, device)
        return transformer.make_cache(self.cfg, batch, max_len, dtype, device)


def get_model(cfg: ModelConfig) -> ModelApi:
    cfg.validate()
    return ModelApi(cfg)


__all__ = ["ModelApi", "get_model", "blocks", "encdec", "mamba2", "mla", "transformer"]
