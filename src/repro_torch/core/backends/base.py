"""Execution-backend protocol + the prepared-weight container (port of
``repro.core.backends.base``).

The port's kernel backend stores the signed-digit weight *integers*
(``round(grid * 2**w_frac)``): int8 for ``FXP8_UNIT``, int16 for
``FXP16_UNIT``. They are exact (|z| <= 127 at FxP8) and take a quarter of
the reference's f32 grid bytes. ``point`` is the small int32 params vector
(dot depth and formats) that a kernel reads at run time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..fxp import FXP8_UNIT, FXP16_UNIT, FxPFormat

__all__ = ["Backend", "PreparedWeight", "unit_fmt"]


def unit_fmt(fmt: FxPFormat) -> FxPFormat:
    """Weight (multiplier-port) format paired with an activation format."""
    return FXP8_UNIT if fmt.bits <= 8 else FXP16_UNIT


@dataclasses.dataclass
class PreparedWeight:
    """One prepared weight-bank leaf: integer payload + runtime params vector.

    A stacked layer bank has ``data`` of shape ``(layers, ...)`` and ``point``
    of shape ``(layers, 5)``; :meth:`layer` slices one layer's view of both.
    """

    data: Any
    backend: str = "exact"
    point: Any = None

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    def layer(self, i: int) -> "PreparedWeight":
        """The ``i``-th slice of a stacked bank (views, no copy)."""
        point = self.point[i] if self.point is not None else None
        return PreparedWeight(self.data[i], self.backend, point)

    def reshape(self, *shape) -> "PreparedWeight":
        return PreparedWeight(self.data.reshape(*shape), self.backend, self.point)


class Backend:
    """One execution mode of the engine."""

    name: str = "?"

    def prepare(self, w, lp, *, stacked_axes: int = 0, in_axes: Optional[int] = None):
        return w

    def dot(self, ctx, x, w, *, name: str = ""):
        raise NotImplementedError
