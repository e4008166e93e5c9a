"""The collectives of tensor-parallel serving, over the process groups of a
:class:`repro_torch.launch.mesh.Mesh` (port-only: the reference leaves them
to GSPMD).

* :func:`all_reduce`: a sum over one mesh axis, of int32 (the row-parallel
  partial dots of kernel mode, which wrap modulo 2**32 in any order, so the
  sum is exact) or of f32 (the row-parallel partial products of the exact
  and carmen modes, which differ from an unsplit product by reduction-order
  ulps, as the reference's GSPMD partial sums do). A sum in which every
  element has one non-zero term (a masked embedding gather, the MoE's
  per-choice outputs) is exact too: x + 0 == x.
* :func:`all_gather`: shards concatenated along a dim in coordinate order
  (the vocab-sharded logits, the router's expert columns, and, over
  ``data``, a burst's per-slot tokens and margins).
* :func:`gather_data`: the FSDP gather. A weight whose spec has a ``data``
  entry is stored as the data rank's block along that dim; where a layer
  (or the embedding, the final norm, the lm_head) is used, every such leaf
  is all-gathered over the data group into the model-sharded whole, and an
  integer bank copied back into its K-major layout (``int_dot.to_k_major``).

Every call counts the bytes of its result under the reference's collective
kinds (``"all-reduce"``, ``"all-gather"``), as ``hlo_analysis`` counts an
HLO collective's result bytes: :func:`counts` reads them and
:func:`reset_counts` zeroes them. An axis of extent 1 has no group: the call
returns its input and counts nothing.

The transport is the group's backend, chosen by the caller when the process
group was made. ``gloo`` takes host tensors, so a CUDA tensor goes to the
host and back around a ``gloo`` collective (ranks that share one card talk
through the host anyway); ``nccl`` takes it where it lies.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist

__all__ = ["all_gather", "all_reduce", "counts", "gather_data", "reset_counts"]

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


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``mesh``'s ``axis`` (a new tensor
    on ``t``'s device; ``t`` itself where the axis has extent 1)."""
    group = mesh.group(axis) if mesh is not None else None
    if group is None:
        return t
    staged = _staged(t, group)
    buf = t.detach().to("cpu") if staged else t.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    _count("all-reduce", buf)
    return buf.to(t.device) if staged else buf


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The shards of ``t`` over ``mesh``'s ``axis``, concatenated along
    ``dim`` in coordinate order (``t`` itself where the axis has extent 1)."""
    group = mesh.group(axis) if mesh is not None else None
    if group is None:
        return t
    staged = _staged(t, group)
    src = (t.detach().to("cpu") if staged else t.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    _count("all-gather", out)
    return out.to(t.device) if staged else out


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
    integer bank is K-major again after the gather (its contraction axes: all
    but the last for ``wo``, the first otherwise, as ``prepare_params`` lays
    them out)."""
    from repro_torch.core.backends.base import PreparedWeight

    if mesh is None or mesh.size("data") == 1:
        return tree

    def one(leaf, spec, key):
        data = leaf.data if isinstance(leaf, PreparedWeight) else leaf
        d = _data_dim((spec.data if isinstance(spec, PreparedWeight) else spec)[lead:])
        if d is None:
            return leaf
        full = all_gather(data, mesh, "data", d)
        if not isinstance(leaf, PreparedWeight):
            return full
        if not full.dtype.is_floating_point:
            from repro_torch.kernels.int_dot import to_k_major

            k_axes = full.ndim - 1 if key == "wo" else 1
            k = math.prod(full.shape[:k_axes])
            full = to_k_major(full.reshape(k, -1)).reshape(full.shape)
        return PreparedWeight(full, leaf.backend, leaf.point, leaf.scale, leaf.meta)

    def walk(node, spec, key):
        if isinstance(node, dict):
            return {k: walk(v, spec[k], k) for k, v in node.items()}
        return one(node, spec, key)

    return walk(tree, specs, None)
