"""kernel backend: prepared CORDIC dots through the fused dot+AF kernel
(port of ``repro.core.backends.kernel``).

``prepare`` rounds each weight once to its depth-d signed-digit integers and
attaches the execution point's int32 ``point`` vector. ``dot`` / ``dot_af``
run :func:`repro_torch.kernels.cordic_fused.fused_dot_af`, which launches the
Hopper kernel on a CUDA tensor and runs the plain version on a CPU tensor.
The kernel tiles the contraction, so there is no ``FUSE_MAX_K`` fallback and
no ``fused`` switch: every prepared dot goes through it.
"""
from __future__ import annotations

import torch

from .. import cordic
from .base import Backend, PreparedWeight, unit_fmt

__all__ = ["KernelBackend", "make_point"]

POINT_LEN = 5


def make_point(depth: int, x_fmt, w_fmt, device=None) -> torch.Tensor:
    """The int32[5] params vector: [depth, x_frac, x_qmin, x_qmax, w_frac]."""
    return torch.tensor([int(depth), x_fmt.frac, x_fmt.qmin, x_fmt.qmax, w_fmt.frac],
                        dtype=torch.int32, device=device)


class KernelBackend(Backend):
    name = "kernel"

    def prepare(self, w, lp, *, stacked_axes: int = 0, in_axes=None):
        fmt = unit_fmt(lp.fmt)
        ints = cordic.signed_digit_ints(w, int(lp.depth), fmt)
        data = ints.to(fmt.storage_dtype).contiguous()
        point = make_point(int(lp.depth), lp.fmt, fmt, device=w.device)
        if stacked_axes:
            point = point.expand(tuple(w.shape[:stacked_axes]) + (POINT_LEN,)).contiguous()
        return PreparedWeight(data, self.name, point)

    def _fused(self, ctx, x, w, af_mode: str):
        from repro_torch.kernels.cordic_fused import fused_dot_af

        lp_af = ctx.layer_precision("af")
        out = fused_dot_af(
            x, w.data, w.point,
            af_mode=af_mode,
            af_depth=int(lp_af.depth),
            af_fmt=lp_af.fmt,
            compute_round=ctx.compute_dtype != torch.float32,
        )
        return out.to(ctx.compute_dtype)

    def dot(self, ctx, x, w, *, name: str = ""):
        if isinstance(w, PreparedWeight) and w.point is not None:
            return self._fused(ctx, x, w, "identity")
        raise NotImplementedError(
            "the per-call kernel dot (cordic_mac kernel) is not yet ported; "
            "prepare the weights with prepare_params"
        )

    def dot_af(self, ctx, x, w, *, af: str, name: str = ""):
        """Fused dot + activation epilogue; NotImplemented -> caller unfuses."""
        from repro_torch.kernels.cordic_fused import FUSED_AFS

        if not (isinstance(w, PreparedWeight) and w.point is not None and af in FUSED_AFS):
            return NotImplemented
        return self._fused(ctx, x, w, af)
