"""Exact backend: the f32/bf16 matmul, the paper's FP32 baseline (port of
``repro.core.backends.exact``).

A plain product, which the reference too computes outside any Pallas kernel:
``torch.matmul`` in ``compute_dtype``. Under a mesh a row-parallel product
is this partial product in f32, summed over the model axis, then cast to
``compute_dtype`` (``partial_dot`` / ``finish_partial``). On the card an f32 product is held
with TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``), which the
serving CLI and ``chip_smoke.py`` set.
"""
from __future__ import annotations

import torch

from .base import Backend, PreparedWeight

__all__ = ["ExactBackend"]


class ExactBackend(Backend):
    name = "exact"

    def dot(self, ctx, x, w, *, name: str = ""):
        if isinstance(w, PreparedWeight):
            w = w.data
        cd = ctx.compute_dtype
        return torch.matmul(x.to(cd), w.to(cd)).to(cd)

    def partial_dot(self, ctx, x, w):
        if isinstance(w, PreparedWeight):
            w = w.data
        cd = ctx.compute_dtype
        return torch.matmul(x.to(cd), w.to(cd)).to(torch.float32)

    def finish_partial(self, ctx, acc, w):
        return acc.to(ctx.compute_dtype)
