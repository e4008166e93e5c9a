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

    def serving_specs(self):
        """The specs the port places a served tree by on a mesh
        (``sharding.partition.serving_specs``: the reference's, but for the
        leaves the port keeps whole on every model rank)."""
        from repro_torch.sharding.partition import serving_specs

        return serving_specs(self.specs())

    def init(self, generator: torch.Generator, dtype=torch.float32, mesh=None):
        """Random parameters on the generator's device (``mesh``: this
        rank's shards of them)."""
        return P.init(self.serving_specs() if mesh is not None else self.specs(), generator,
                      dtype, mesh)

    def abstract_params(self, dtype=torch.float32):
        """Meta tensors of every parameter's shape (the dry run's stand-in)."""
        return P.abstract(self.specs(), dtype)

    def param_axes(self):
        return P.axes_tree(self.specs())

    def count_params(self) -> int:
        return P.count_params(self.specs())

    def load_numpy(self, tree, device, mesh=None):
        """The reference's raw parameter tree (numpy leaves) on ``device``
        (``mesh``: this rank's shards of it)."""
        return P.load_numpy_params(tree, device, mesh=mesh,
                                   specs=self.serving_specs() if mesh is not None
                                   else self.specs())

    def forward(self, prms, batch, ctx: EngineContext, *, remat: bool = False):
        """Cache-free forward: ``batch["tokens"]`` (B, S) -> (logits, aux)."""
        if self.cfg.family == "audio":
            return encdec.forward(prms, batch, self.cfg, ctx, remat=remat)
        return transformer.forward(prms, batch, self.cfg, ctx, remat=remat)

    def decode_step(self, prms, tokens, cache, ctx: EngineContext):
        if self.cfg.family == "audio":
            return encdec.decode_step(prms, tokens, cache, self.cfg, ctx)
        return transformer.decode_step(prms, tokens, cache, self.cfg, ctx)

    def make_cache(self, batch: int, max_len: int, dtype=torch.float32, device=None,
                   mesh=None):
        """The decode cache; ``mesh``: a rank's under tensor parallelism."""
        if self.cfg.family == "audio":
            return encdec.make_cache(self.cfg, batch, max_len, dtype, device, mesh)
        return transformer.make_cache(self.cfg, batch, max_len, dtype, device, mesh)


def get_model(cfg: ModelConfig) -> ModelApi:
    cfg.validate()
    return ModelApi(cfg)


__all__ = ["ModelApi", "get_model", "blocks", "encdec", "mamba2", "mla", "transformer"]
