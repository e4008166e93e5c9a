"""Execution-backend protocol + the prepared-weight container (port of
``repro.core.backends.base``).

The port's kernel backend stores the signed-digit weight *integers*
(``round(grid * 2**w_frac)``): int8 for ``FXP8_UNIT``, int16 for
``FXP16_UNIT``. They are exact (|z| <= 127 at FxP8) and take a quarter of
the reference's f32 grid bytes. ``point`` is the small int32 params vector
(dot depth and formats) that a kernel reads at run time. The carmen backend
stores the reference's f32 signed-digit grid, the int8 backend int8
qvalues (K-major, as every integer bank) with their per-channel ``scale``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..fxp import FXP8_UNIT, FXP16_UNIT, FxPFormat

__all__ = ["Backend", "PreparedWeight", "unit_fmt"]


def unit_fmt(fmt: FxPFormat) -> FxPFormat:
    """Weight (multiplier-port) format paired with an activation format."""
    return FXP8_UNIT if fmt.bits <= 8 else FXP16_UNIT


@dataclasses.dataclass
class PreparedWeight:
    """One prepared weight-bank leaf: payload + runtime params vector.

    A stacked layer bank has ``data`` of shape ``(layers, ...)``, ``point``
    of shape ``(layers, 5)`` and ``scale`` (int8 only) of keepdims shape
    ``(layers, 1, ..., C)``; :meth:`layer` slices one layer's view of each.
    ``meta`` records the preparation point as (key, value) pairs, as in the
    reference (carmen's ``x_fmt``, int8's ``effective_bits`` and ``depth``).
    """

    data: Any
    backend: str = "exact"
    point: Any = None
    scale: Any = None
    meta: Tuple[Tuple[str, Any], ...] = ()

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    def get(self, key, default=None):
        """meta lookup, e.g. ``w.get("x_fmt")``."""
        return dict(self.meta).get(key, default)

    def layer(self, i: int) -> "PreparedWeight":
        """The ``i``-th slice of a stacked bank (views, no copy)."""
        point = self.point[i] if self.point is not None else None
        scale = self.scale[i] if self.scale is not None else None
        return PreparedWeight(self.data[i], self.backend, point, scale, self.meta)

    def reshape(self, *shape) -> "PreparedWeight":
        """Reshape the payload, carrying the per-channel scale along as the
        reference does: a plain reshape when the channel axis survives, a
        broadcast-then-reshape when trailing axes fold into it."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        data = self.data.reshape(*shape)
        scale = self.scale
        if scale is not None:
            if data.shape[-1] == self.data.shape[-1]:
                scale = scale.reshape((1,) * (data.ndim - 1) + (scale.shape[-1],))
            elif data.shape[0] == self.data.shape[0]:
                full = torch.broadcast_to(scale, (1,) + tuple(self.data.shape[1:]))
                scale = full.reshape((1,) + tuple(data.shape[1:]))
            else:
                raise ValueError(f"cannot reshape per-channel scale {tuple(self.scale.shape)} "
                                 f"for {tuple(self.data.shape)} -> {tuple(data.shape)}")
        return PreparedWeight(data, self.backend, self.point, scale, self.meta)


class Backend:
    """One execution mode of the engine."""

    name: str = "?"

    def prepare(self, w, lp, *, stacked_axes: int = 0, in_axes: Optional[int] = None):
        return w

    def dot(self, ctx, x, w, *, name: str = ""):
        raise NotImplementedError
