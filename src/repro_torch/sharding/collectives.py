"""The collectives of tensor parallelism, over the process groups of a
:class:`repro_torch.launch.mesh.Mesh` (port-only: the reference leaves them
to GSPMD).

* :func:`all_reduce`: a sum over one mesh axis, of int32 (the row-parallel
  partial dots of the kernel and int8 modes, which wrap modulo 2**32 in any
  order, so the sum is exact) or of f32 (the row-parallel partial products
  of the exact and carmen modes, which differ from an unsplit product by
  reduction-order ulps, as the reference's GSPMD partial sums do). A sum in
  which every element has one non-zero term (a masked embedding gather, the
  MoE's per-choice outputs) is exact too: x + 0 == x.
* :func:`amax`: the maximum of a tensor over some of its dims, across the
  shards of those dims over one axis (the int8 mode's per-token and
  per-channel maxima of a K shard): exact.
* :func:`all_gather`: shards concatenated along a dim in coordinate order
  (the vocab-sharded logits, the router's expert columns, and, over
  ``data``, a burst's per-slot tokens and margins).
* :func:`gather_data`: the FSDP gather. A weight whose spec has a ``data``
  entry is stored as the data rank's block along that dim; where a layer
  (or the embedding, the final norm, the lm_head) is used, every such leaf
  is all-gathered over the data group into the model-sharded whole, and an
  integer bank copied back into its K-major layout (``int_dot.to_k_major``).
* :func:`enter_model`: the identity, whose gradient is summed over the
  model axis (below).

**Gradients.** Under autograd every collective names its backward. A
training step's loss is the same on every rank of the ``model`` axis (each
computes it from the same gathered logits) and differs over ``data`` (each
data rank has its own rows; ``train.train_loop`` sums the data ranks'
losses). So the adjoint of a collective depends on its axis:

* over ``model``, a sum's backward is the identity (the rank's input fed
  the one loss through the sum), a gather's is the rank's slice of the
  gradient, and :func:`amax` routes the gradient to the elements that hold
  the maximum, split evenly among them across every shard, as ``jnp.max``
  over the whole dim splits it. The gradient that reaches a collective
  must then be the whole one on every rank: where an activation that every
  model rank holds whole enters the rank's shard (its columns, heads or
  experts: q/k/v, up/gate, the experts, ``in_proj``, the lm_head), the
  rank's own gradient of it is partial, and the model code passes it
  through :func:`enter_model` first, whose backward sums it over ``model``
  (the same holds for a weight every rank holds whole that acts on the
  rank's heads, such as ``q_norm``);
* over ``data`` (and ``pod``), a sum's backward is a sum of the ranks'
  gradients and a gather's a sum then the rank's slice (a reduce-scatter:
  the FSDP gather's backward, and that of the embedding's gathered rows).

Every call, forward or backward, counts the bytes of its result under the
reference's collective kinds (``"all-reduce"``, ``"all-gather"``), as
``hlo_analysis`` counts an HLO collective's result bytes: :func:`counts`
reads them and :func:`reset_counts` zeroes them. An axis of extent 1 has no
group: the call returns its input and counts nothing.

The transport is the group's backend, chosen by the caller when the process
group was made. ``gloo`` takes host tensors, so a CUDA tensor goes to the
host and back around a ``gloo`` collective (ranks that share one card talk
through the host anyway); ``nccl`` takes it where it lies.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.distributed as dist

__all__ = ["all_gather", "all_reduce", "amax", "counts", "enter_model", "gather_data",
           "reset_counts"]

_bytes: Dict[str, int] = {}


def reset_counts() -> None:
    _bytes.clear()


def counts() -> Dict:
    """``{"collective_bytes": total, "collective_by_kind": {kind: bytes}}``
    since the last :func:`reset_counts`."""
    return {"collective_bytes": float(sum(_bytes.values())),
            "collective_by_kind": {k: float(v) for k, v in sorted(_bytes.items())}}


def _count(kind: str, t: torch.Tensor) -> None:
    _bytes[kind] = _bytes.get(kind, 0) + t.numel() * t.element_size()


def _group(mesh, axis: str):
    return mesh.group(axis) if mesh is not None else None


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The transport of a reduction: a new tensor on ``t``'s device."""
    staged = _staged(t, group)
    buf = t.detach().to("cpu") if staged else t.detach().clone()
    dist.all_reduce(buf, op=_OPS[op], group=group)
    _count("all-reduce", buf)
    return buf.to(t.device) if staged else buf


def _gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The transport of a gather along ``dim``, in coordinate order."""
    group = mesh.group(axis)
    staged = _staged(t, group)
    src = (t.detach().to("cpu") if staged else t.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    _count("all-gather", out)
    return out.to(t.device) if staged else out


def _own(g: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``g`` along ``dim`` (its shard of a gather)."""
    n = g.shape[dim] // mesh.size(axis)
    return g.narrow(dim, mesh.coord(axis) * n, n)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _reduce(t, mesh.group(axis))

    @staticmethod
    def backward(ctx, g):
        if ctx.axis == "model":
            return g, None, None
        return _reduce(g, ctx.mesh.group(ctx.axis)), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.axis != "model":  # a reduce-scatter: every data rank's gradient of the shard
            g = _reduce(g, ctx.mesh.group(ctx.axis))
        return _own(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh.group("model")), None


class _Amax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dims, mesh, axis):
        out = _reduce(torch.amax(t, dim=dims, keepdim=True), mesh.group(axis), "max")
        ctx.save_for_backward(t, out)
        ctx.dims, ctx.mesh, ctx.axis = dims, mesh, axis
        return out

    @staticmethod
    def backward(ctx, g):
        t, out = ctx.saved_tensors
        held = t == out
        ties = _reduce(held.sum(dim=ctx.dims, keepdim=True).to(g.dtype),
                       ctx.mesh.group(ctx.axis))
        return held.to(g.dtype) * (g / ties), None, None, None


def all_reduce(t: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``mesh``'s ``axis`` (a new tensor on
    ``t``'s device; ``t`` itself where the axis has extent 1)."""
    if _group(mesh, axis) is None:
        return t
    return _Sum.apply(t, mesh, axis)


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The shards of ``t`` over ``mesh``'s ``axis``, concatenated along
    ``dim`` in coordinate order (``t`` itself where the axis has extent 1)."""
    if _group(mesh, axis) is None:
        return t
    return _Gather.apply(t, mesh, axis, dim)


def amax(t: torch.Tensor, dims: Sequence[int], mesh, axis: str = "model") -> torch.Tensor:
    """``torch.amax(t, dims, keepdim=True)`` over the whole of ``dims``, whose
    shards the ranks of ``mesh``'s ``axis`` hold: the local maximum, then
    the maximum over the axis. Its gradient goes to every element, on any
    rank, that holds the maximum, split evenly among them."""
    dims = tuple(dims)
    if _group(mesh, axis) is None:
        return torch.amax(t, dim=dims, keepdim=True)
    return _Amax.apply(t, dims, mesh, axis)


def enter_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t``, an activation (or weight) every rank of the model axis holds
    whole, as it enters this rank's shard of a computation: the identity,
    whose gradient is summed over the model axis (the ranks' shards each
    give part of it)."""
    if _group(mesh, "model") is None:
        return t
    return _Enter.apply(t, mesh)


def _data_dim(spec) -> "int | None":
    """The dim a spec shards over ``data``, or None."""
    for i, e in enumerate(spec):
        axes = (e,) if isinstance(e, str) else tuple(e or ())
        if "data" in axes:
            if axes != ("data",):
                raise NotImplementedError(
                    f"a weight sharded over {axes}: the FSDP gather takes the data axis alone "
                    "(the pod axis of production meshes is ROADMAP Queue 1)")
            return i
    return None


def gather_data(tree, specs, mesh, lead: int = 0):
    """``tree`` (parameters as a rank stores them, or a layer of them: its
    ``lead`` stacked axes indexed away) with every leaf whose partition spec
    (``specs``, the ``partition.prepared_shardings`` tree) has a ``data``
    entry all-gathered over the data group along that dim. A prepared
    integer bank is K-major again after the gather, its contraction and
    stacked axes those of the rank's shard (:func:`_k_major_axes`). An int8
    bank's per-channel scale is gathered with it where its channel axis is
    the sharded one."""
    from repro_torch.core.backends.base import PreparedWeight

    if mesh is None or mesh.size("data") == 1:
        return tree

    def one(leaf, spec):
        data = leaf.data if isinstance(leaf, PreparedWeight) else leaf
        d = _data_dim((spec.data if isinstance(spec, PreparedWeight) else spec)[lead:])
        if d is None:
            return leaf
        full = all_gather(data, mesh, "data", d)
        if not isinstance(leaf, PreparedWeight):
            return full
        if not full.dtype.is_floating_point:  # laid out as the rank's shard is
            from repro_torch.kernels.int_dot import to_k_major

            stacked, end = _k_major_axes(data)
            k = math.prod(full.shape[stacked:end])
            full = to_k_major(full.reshape(*full.shape[:stacked], k, -1)).reshape(full.shape)
        scale = leaf.scale
        if scale is not None:
            ds = _data_dim(spec.scale[lead:])
            if ds is not None:
                scale = all_gather(scale, mesh, "data", ds)
        return PreparedWeight(full, leaf.backend, leaf.point, scale, leaf.meta)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return one(node, spec)

    return walk(tree, specs)


def _k_major_axes(t: torch.Tensor):
    """``(first, end)``: the contraction axes ``first .. end - 1`` of a
    K-major integer bank (as ``prepare_params`` and
    ``partition.shard_params`` lay one out), the run of axes that ends at
    its stride-1 axis, each axis's stride the span of the next. The axes
    before them are stacked (a hybrid group's Mamba2 layers), a size-1 axis
    among them too."""
    st, sh = t.stride(), t.shape
    last = max(i for i in range(t.ndim - 1) if st[i] == 1 and sh[i] > 1)
    first = last
    while first > 0 and sh[first - 1] > 1 and st[first - 1] == st[first] * sh[first]:
        first -= 1
    return first, last + 1
