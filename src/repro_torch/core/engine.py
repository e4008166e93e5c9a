"""The CARMEN vector engine: one entry point for every matmul (port of
``repro.core.engine``).

Model code calls ``EngineContext.linear`` / ``linear_af``; the backend is
resolved per call from the prepared leaf (or the context mode). Dispatch to
a kernel goes by the tensor's device: a CUDA tensor launches the Hopper
kernel, a CPU tensor runs its plain PyTorch version. There is no ``fused``
switch: prepared kernel-mode dots always take the fused kernel.

Under tensor parallelism (``mesh``) every rank holds its shard of each
weight (``sharding.partition.shard_params``): a column-parallel product (N
over ``model``: q/k/v over heads, up/gate over the MLP width, the lm_head
over the vocab) is the plain call on the shard, whose output columns are
the rank's; a row-parallel one (K over ``model``: ``wo``, ``down``) is
``linear(..., k_sharded=True)``: the backend's partial product, its sum over
the model axis, then the backend's finish (:meth:`EngineContext.linear`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

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
    # tensor parallelism: the rank's mesh (launch.mesh.Mesh; None: one
    # device) and the number of data shards the batch rows are split over (a
    # slot batch's; 1 where every data rank runs the same rows)
    mesh: Optional[Any] = None
    batch_shards: int = 1
    # the partition specs of the served tree on ``mesh``
    # (``sharding.partition.prepared_shardings``): the FSDP gathers read them
    param_specs: Optional[Any] = None

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")

    def model_split(self, dim: int) -> int:
        """The shards a logical dim of global extent ``dim`` is split into
        over the ``model`` axis (the extent when it divides, else 1: the
        partition rules' divisibility fallback)."""
        m = self.mesh.size("model") if self.mesh is not None else 1
        return m if m > 1 and dim % m == 0 else 1

    def attention_plan(self, b: int, heads: int, kv_heads: Optional[int] = None):
        """The (B, H[, KV]) a cache-attention kernel plans its key splits
        from: the whole batch and head counts, whatever shard of them a rank
        holds, so a row's bits do not depend on the mesh."""
        b = b * self.batch_shards
        return (b, heads) if kv_heads is None else (b, heads, kv_heads)

    def layer_precision(self, name: str) -> LayerPrecision:
        policy = self.policy or PrecisionPolicy.accurate(FXP8)
        return policy.for_layer(name)

    def dot(self, x, w, *, name: str = ""):
        return resolve(w, self.mode).dot(self, x, w, name=name)

    def linear(self, x, w, b=None, *, name: str = "", k_sharded: bool = False):
        """``x @ w (+ b)``. ``k_sharded``: ``w`` is this rank's shard of the
        contraction (a row-parallel product): the backend's partial product
        is summed over the ``model`` axis before its finish, and the bias
        added once, after the sum. In kernel mode the partial is the exact
        int32 dot, so the sum and the result are bitwise the unsharded ones;
        in ``exact`` and ``carmen`` it is an f32 product, whose sum differs
        from the unsharded product by reduction-order ulps."""
        if k_sharded and self.mesh is not None:
            from repro_torch.sharding.collectives import all_reduce

            backend = resolve(w, self.mode)
            partial = getattr(backend, "partial_dot", None)
            if partial is None or (backend.name != "exact" and not isinstance(w, PreparedWeight)):
                raise NotImplementedError(
                    f"a row-parallel {backend.name!r} product under a mesh needs its "
                    "partial-sum form: per-call weights and the int8 mode wait for kernel 6's "
                    "partial-sum variant (ROADMAP Queue 1)")
            out = backend.finish_partial(self, all_reduce(partial(self, x, w), self.mesh), w)
        else:
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
