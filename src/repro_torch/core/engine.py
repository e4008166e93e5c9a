"""The CARMEN vector engine: one entry point for every matmul (port of
``repro.core.engine``).

Model code calls ``EngineContext.linear`` / ``linear_af``; the backend is
resolved per call from the prepared leaf (or the context mode). Dispatch to
a kernel goes by the tensor's device: a CUDA tensor launches the Hopper
kernel, a CPU tensor runs its plain PyTorch version. There is no ``fused``
switch: prepared kernel-mode dots always take the fused kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .backends import prepare_params, resolve
from .backends.base import PreparedWeight
from .fxp import FXP8
from .precision_policy import LayerPrecision, PrecisionPolicy

__all__ = ["EngineContext", "PreparedWeight", "prepare_params"]

ATTN_IMPLS = ("xla", "decode_kernel", "flash")


@dataclasses.dataclass(frozen=True)
class EngineContext:
    """Static engine configuration threaded through model code.

    ``attn_impl``: ``"xla"`` runs the plain attention chains (the
    reference's XLA paths, in torch ops); ``"decode_kernel"`` runs the GQA
    and MLA cache-decode kernels on the cache path; ``"flash"`` runs the
    cache-free flash and MLA flash kernels on the cache-free path
    (``forward``). Each kernel's plain version runs on CPU tensors. As in
    the reference, only the cache path reads ``"decode_kernel"`` and only the
    cache-free path ``"flash"``: elsewhere either behaves like ``"xla"``.
    """

    mode: str = "exact"
    policy: Optional[PrecisionPolicy] = None
    compute_dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "xla"

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")

    def layer_precision(self, name: str) -> LayerPrecision:
        policy = self.policy or PrecisionPolicy.accurate(FXP8)
        return policy.for_layer(name)

    def dot(self, x, w, *, name: str = ""):
        return resolve(w, self.mode).dot(self, x, w, name=name)

    def linear(self, x, w, b=None, *, name: str = ""):
        out = self.dot(x, w, name=name)
        if b is not None:
            out = out + b.to(out.dtype)
        return out

    def activate(self, x, af: str):
        """Activation through the CARMEN multi-AF block, or the exact float
        reference in ``exact`` mode. In kernel mode it is the elementwise AF
        kernel, or for ``"softmax"`` the row-softmax kernel over the last axis
        (their plain versions on CPU tensors); ``carmen`` and ``int8`` run
        ``multi_af_float`` as the reference does. The multi-AF modes run at
        the policy's ``af`` depth and format."""
        if af == "identity":
            return x
        if self.mode == "exact":
            from .activations import af_ref

            return af_ref(x, af).to(x.dtype)
        lp = self.layer_precision("af")
        if self.mode == "kernel":
            from repro_torch.kernels.cordic_af import multi_af

            return multi_af(x, af, depth=int(lp.depth), fmt=lp.fmt).to(x.dtype)
        from .activations import multi_af_float

        return multi_af_float(x, af, lp.depth, lp.fmt).to(x.dtype)

    def linear_af(self, x, w, b=None, *, af: str, name: str = ""):
        """Linear followed by an activation, fused into one kernel pass when
        the backend offers ``dot_af`` (kernel backend, prepared weights);
        otherwise the linear, then :meth:`activate`."""
        backend = resolve(w, self.mode)
        dot_af = getattr(backend, "dot_af", None)
        if b is None and dot_af is not None:
            out = dot_af(self, x, w, af=af, name=name)
            if out is not NotImplemented:
                return out
        return self.activate(self.linear(x, w, b, name=name), af)
