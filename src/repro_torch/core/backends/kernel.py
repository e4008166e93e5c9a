"""kernel backend: CORDIC dots through the Hopper kernels (port of
``repro.core.backends.kernel``).

Prepared path: ``prepare`` rounds each weight once to its depth-d
signed-digit integers and attaches the execution point's int32 ``point``
vector; ``dot`` / ``dot_af`` run
:func:`repro_torch.kernels.cordic_fused.fused_dot_af`. The kernel tiles the
contraction, so there is no ``FUSE_MAX_K`` fallback and no ``fused`` switch:
every prepared dot goes through it.

Per-call path: a raw float weight is re-rounded on every call and the dot
runs the MAC-array kernel (:func:`repro_torch.kernels.cordic_mac.cordic_mac`)
at the policy's static formats; ``dot_af`` declines it, so the caller runs
the activation as its own multi-AF pass. The reference's third branch, a
legacy prepared leaf that carried its formats in ``meta``, is not ported:
its ``prepare`` always sets ``point``, so nothing builds such a leaf.

Every bank is stored K-major, the only layout Hopper's integer MMAs take:
its contraction axes innermost in memory (a stacked ``(L, d, H, hd)`` leaf
as ``(L, H, hd, d)``, a ``wo`` ``(L, H, hd, d)`` as ``(L, d, H, hd)``), K
padded to whole 16 bytes, and viewed back in the logical shape, so values
and shapes are the reference's and the models' 2-D reshapes are views with
``stride == (1, K_pad)``.

Under a mesh a row-parallel product runs the split form of its kernel:
``partial_dot`` is the int32 dot of the shard (the partial-sum
instantiation of the fused kernel, or per call of the MAC-array kernel), the
engine sums it over the model axis, and ``finish_partial`` runs that
kernel's epilogue kernel on the sum. Per call, the shard's rounding is the
shard of the whole weight's (it is elementwise) and the scales are the
formats' constants, so the sum is bitwise the unsharded call's.

Each kernel launches on a CUDA tensor and its plain version runs on a CPU
tensor.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.int_dot import k_major_empty

from .. import cordic
from .base import Backend, PreparedWeight, unit_fmt

__all__ = ["KernelBackend", "make_point"]

POINT_LEN = 5
# elements per step of the elementwise weight rounding: bounds its int32
# temporaries (a full-width lm_head is 0.9 G elements)
_PREPARE_CHUNK = 1 << 24


def make_point(depth: int, x_fmt, w_fmt, device=None) -> torch.Tensor:
    """The int32[5] params vector: [depth, x_frac, x_qmin, x_qmax, w_frac]."""
    return torch.tensor([int(depth), x_fmt.frac, x_fmt.qmin, x_fmt.qmax, w_fmt.frac],
                        dtype=torch.int32, device=device)


def _chunks(shape, limit: int):
    """Index tuples that cut a tensor of ``shape`` into pieces of at most
    ``limit`` elements, along its leading axes."""
    if not shape:
        yield ()
        return
    inner = math.prod(shape[1:])
    if inner <= limit:
        step = max(1, limit // max(inner, 1))
        for i in range(0, shape[0], step):
            yield (slice(i, i + step),)
        return
    for i in range(shape[0]):
        for rest in _chunks(shape[1:], limit):
            yield (i, *rest)


def _signed_digit_storage(w, depth: int, fmt, stacked_axes: int = 0,
                          in_axes: int = 1) -> torch.Tensor:
    """``cordic.signed_digit_ints`` in the storage dtype as a K-major bank in
    ``w``'s logical shape: the ``in_axes`` contraction axes after the
    ``stacked_axes`` leading ones are innermost in memory, their product K
    padded to whole 16 bytes. Computed in chunks of ``w`` (the rounding is
    elementwise), so nothing larger than a chunk is ever materialized in f32."""
    w = torch.as_tensor(w)
    lead = tuple(w.shape[:stacked_axes])
    k = math.prod(w.shape[stacked_axes:stacked_axes + in_axes])
    n = math.prod(w.shape[stacked_axes + in_axes:])
    out = k_major_empty(lead, k, n, fmt.storage_dtype, w.device).reshape(w.shape)
    for idx in _chunks(tuple(w.shape), _PREPARE_CHUNK):
        out[idx] = cordic.signed_digit_ints(w[idx], depth, fmt).to(out.dtype)
    return out


class KernelBackend(Backend):
    name = "kernel"

    def prepare(self, w, lp, *, stacked_axes: int = 0, in_axes=None):
        fmt = unit_fmt(lp.fmt)
        data = _signed_digit_storage(w, int(lp.depth), fmt, stacked_axes,
                                     1 if in_axes is None else in_axes)
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
        if isinstance(w, PreparedWeight):
            return self._fused(ctx, x, w, "identity")
        from repro_torch.kernels.cordic_mac import cordic_mac

        lp = ctx.layer_precision(name)
        out = cordic_mac(x.reshape(-1, x.shape[-1]), w, depth=int(lp.depth), x_fmt=lp.fmt,
                         w_fmt=unit_fmt(lp.fmt))
        return out.reshape(*x.shape[:-1], w.shape[-1]).to(ctx.compute_dtype)

    def dot_af(self, ctx, x, w, *, af: str, name: str = ""):
        """Fused dot + activation epilogue; NotImplemented -> caller unfuses."""
        from repro_torch.kernels.cordic_fused import FUSED_AFS

        if not (isinstance(w, PreparedWeight) and w.point is not None and af in FUSED_AFS):
            return NotImplemented
        return self._fused(ctx, x, w, af)

    def partial_dot(self, ctx, x, w, *, name: str = ""):
        """A row-parallel shard's exact int32 dot: the fused kernel's
        partial-sum instantiation on a prepared bank; per call, the MAC-array
        kernel's on the shard rounded here."""
        if isinstance(w, PreparedWeight):
            from repro_torch.kernels.cordic_fused import fused_dot_partial

            return fused_dot_partial(x, w.data, w.point), None
        from repro_torch.kernels.cordic_mac import (mac_matmul_partial, quantize_activations,
                                                    quantize_weights)

        lp = ctx.layer_precision(name)
        x_q, xs = quantize_activations(x.reshape(-1, x.shape[-1]), lp.fmt)
        w_q, ws = quantize_weights(w, int(lp.depth), unit_fmt(lp.fmt))
        acc = mac_matmul_partial(x_q, w_q)
        return acc.reshape(*x.shape[:-1], w.shape[-1]), (xs, ws)

    def finish_partial(self, ctx, acc, w, carry):
        """The split kernel's epilogue on the int32 sum over the model axis."""
        if isinstance(w, PreparedWeight):
            from repro_torch.kernels.cordic_fused import fused_epilogue

            lp_af = ctx.layer_precision("af")
            out = fused_epilogue(acc, w.point, af_mode="identity", af_depth=int(lp_af.depth),
                                 af_fmt=lp_af.fmt,
                                 compute_round=ctx.compute_dtype != torch.float32)
            return out.to(ctx.compute_dtype)
        from repro_torch.kernels.cordic_mac import mac_epilogue

        xs, ws = carry
        acc2 = acc.reshape(-1, acc.shape[-1])
        m, n = acc2.shape
        x_scale = torch.full((m, 1), xs, dtype=torch.float32, device=acc.device)
        w_scale = torch.full((1, n), ws, dtype=torch.float32, device=acc.device)
        out = mac_epilogue(acc2, x_scale, w_scale)
        return out.reshape(acc.shape).to(ctx.compute_dtype)
