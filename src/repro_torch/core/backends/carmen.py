"""carmen backend: paper-faithful CORDIC simulation over the FxP substrate
(port of ``repro.core.backends.carmen``).

Per-call path: activations fake-quantized to the FxP format, weights rounded
to the depth-d signed-digit grid by a full-trip masked loop
(:func:`sd_round_traced`, the linear-CORDIC multiplier), one f32 product.
Prepared path (serving): the grid is materialized once by ``prepare`` at the
policy depth, and the forward only fake-quantizes activations and runs the
product; it is bitwise the per-call forward, since the masked and the static
rounders agree digit for digit.

The f32 product of grid values is ``torch.matmul``, as the reference computes
it with ``jnp.dot`` outside Pallas; a partial sum can pass 2**24, so it
agrees with the reference to reduction-order ulps, not bits.

Training (QAT) goes through the per-call product with the reference's
straight-through backward (``_carmen_fwd`` / ``_carmen_bwd``), here the
autograd Function :class:`CarmenSTE`: the forward is the quantized product,
the backward the float one's, ``dx = g @ w.T`` and ``dw = x.T @ g`` in f32
at the inputs' dtypes, and nothing flows to ``depth``. A call that records
no gradient runs the forward alone.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import cordic
from ..fxp import FXP8, FxPFormat, dequantize, quantize, to_int32
from .base import Backend, PreparedWeight, unit_fmt

__all__ = ["CarmenBackend", "CarmenSTE", "carmen_dot", "quantize_activations", "sd_round_traced"]


def sd_round_traced(w, depth, w_fmt: FxPFormat) -> torch.Tensor:
    """``signed_digit_round`` with a run-time depth (an int or a tensor): a
    full-depth loop whose steps past ``depth`` are masked out, so one program
    serves every depth. Bitwise ``cordic.signed_digit_round``."""
    z = to_int32(torch.round(torch.as_tensor(w, dtype=torch.float32) * float(1 << w_fmt.frac)))
    z = torch.clamp(z, w_fmt.qmin, w_fmt.qmax)
    acc = torch.zeros_like(z)
    for k in range(cordic.full_depth(w_fmt)):
        d = torch.where(z >= 0, 1, -1).to(torch.int32)
        step = (w_fmt.one >> k) * d
        if isinstance(depth, torch.Tensor):
            step = torch.where(k < depth, step, torch.zeros_like(step))
        elif k >= depth:  # a host depth masks its steps on the host: no copy to the card
            step = torch.zeros_like(step)
        z = z - step
        acc = acc + step
    return acc.to(torch.float32) * np.float32(w_fmt.scale).item()


def quantize_activations(x, x_fmt: FxPFormat) -> torch.Tensor:
    """Fake-quantize activations into the FxP grid (f32 values out). The
    identity on non-finite inputs, as in the reference: the grid cast would
    otherwise launder a NaN/Inf into a plausible finite value that the
    serving fault flag could never see at the logits."""
    xf = torch.as_tensor(x, dtype=torch.float32)
    q = dequantize(quantize(xf, x_fmt), x_fmt)
    return torch.where(torch.isfinite(xf), q, xf)


def _carmen_product(x, w, depth, x_fmt: FxPFormat, w_fmt: FxPFormat) -> torch.Tensor:
    return torch.matmul(quantize_activations(x, x_fmt), sd_round_traced(w, depth, w_fmt))


class CarmenSTE(torch.autograd.Function):
    """The quantized product forward, the float product's gradient backward
    (the reference's ``_carmen_matmul_ste``)."""

    @staticmethod
    def forward(ctx, x, w, depth, x_fmt, w_fmt):
        ctx.save_for_backward(x, w)
        return _carmen_product(x, w, depth, x_fmt, w_fmt)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf = g.to(torch.float32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(gf, w.to(torch.float32).T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.to(torch.float32).reshape(-1, x.shape[-1]).T,
                              gf.reshape(-1, g.shape[-1])).to(w.dtype)
        return dx, dw, None, None, None


def carmen_dot(x, w, depth, x_fmt: FxPFormat = FXP8, w_fmt: Optional[FxPFormat] = None):
    """The per-call carmen product of ``(..., K)`` by ``(K, N)``: f32 out,
    differentiable through :class:`CarmenSTE`."""
    w_fmt = w_fmt or unit_fmt(x_fmt)
    return CarmenSTE.apply(torch.as_tensor(x), torch.as_tensor(w), depth, x_fmt, w_fmt)


class CarmenBackend(Backend):
    name = "carmen"

    def prepare(self, w, lp, *, stacked_axes: int = 0, in_axes=None):
        fmt = unit_fmt(lp.fmt)
        data = cordic.signed_digit_round(w, int(lp.depth), fmt)
        # x_fmt makes the bank self-describing: the prepared dot quantizes
        # activations at the preparation point's format, so a multi-point
        # bank never consults ctx.policy
        return PreparedWeight(data, self.name, meta=(
            ("depth", int(lp.depth)), ("fmt", (fmt.bits, fmt.frac)),
            ("x_fmt", (lp.fmt.bits, lp.fmt.frac))))

    def dot(self, ctx, x, w, *, name: str = ""):
        shape = tuple(x.shape[:-1]) + (w.shape[-1],)
        x2 = x.reshape(-1, x.shape[-1])
        if isinstance(w, PreparedWeight):
            x_fmt = w.get("x_fmt")
            x_fmt = FxPFormat(*x_fmt) if x_fmt else ctx.layer_precision(name).fmt
            out = torch.matmul(quantize_activations(x2, x_fmt), w.data)
        else:
            lp = ctx.layer_precision(name)
            out = carmen_dot(x2, w, lp.depth, lp.fmt, unit_fmt(lp.fmt))
        return out.reshape(shape).to(ctx.compute_dtype)

    def partial_dot(self, ctx, x, w):
        """A row-parallel shard's f32 product of fake-quantized activations
        and the prepared grid (prepared weights only)."""
        x_fmt = w.get("x_fmt")
        x_fmt = FxPFormat(*x_fmt) if x_fmt else ctx.layer_precision("").fmt
        x2 = x.reshape(-1, x.shape[-1])
        out = torch.matmul(quantize_activations(x2, x_fmt), w.data)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    def finish_partial(self, ctx, acc, w):
        return acc.to(ctx.compute_dtype)
