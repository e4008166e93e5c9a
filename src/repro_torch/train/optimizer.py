"""AdamW (from scratch) over nested-dict parameter trees (port of
``repro.train.optimizer``).

The arithmetic is the reference's, in f32 on the parameters' device: the
warm-up/cosine schedule, the global-norm clip and the bias-corrected
update with decoupled weight decay. A leaf whose gradient is ``None`` (torch
gives no gradient where every path to a weight passes an integer cast, as
the carmen and int8 modes' multi-AF gate does; JAX gives zeros there) is
updated as with a zero gradient: its moments decay, and weight decay still
moves it. ``abstract_state`` gives the state as meta tensors, which the dry
run traces.

**ZeRO on a mesh** (the reference's state sharding): ``m`` and ``v`` are
built on the rank's parameter shards, so they take the parameters' specs
(:func:`state_shardings`); the step is whole on every rank. With
``shardings`` (the parameters' ``partition.TreeShardings``) the global norm
sums each leaf's local sum of squares over exactly the mesh axes its spec
shards, so a leaf every rank holds whole counts once, and the clip and the
update then run on the shards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.sharding.collectives import all_reduce
from repro_torch.sharding.partition import TreeShardings, local_shape, sharded_axes

from ._tree import leaves_like, leaves_with_specs, tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "AdamWState", "abstract_state", "apply_updates", "global_norm",
           "init_state", "state_shardings"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any
    v: Any


def init_state(params) -> AdamWState:
    """Zero moments shaped like ``params`` (on a mesh: the rank's shards)."""
    z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), m=z,
                      v=tree_map(torch.clone, z))


def state_shardings(shardings):
    """The optimizer state's placement from its parameters' (a
    ``partition.TreeShardings``): ``m`` and ``v`` sharded like the
    parameters, the step whole on every rank."""
    return TreeShardings(AdamWState((), shardings.specs, shardings.specs), shardings.mesh)


def abstract_state(params, shardings=None) -> AdamWState:
    """Meta tensors of the state's shapes and dtypes (the dry run's
    stand-in); ``m`` and ``v`` are trees of their own, as on the card.
    ``params`` are whole; with ``shardings`` (theirs) the moments are one
    rank's shards."""
    def shape(p, spec):
        return p.shape if shardings is None else local_shape(p.shape, spec, shardings.mesh)

    def zeros():
        pairs = leaves_with_specs(params, shardings.specs) if shardings is not None else \
            [(p, None) for p in tree_leaves(params)]
        return tree_unflatten(params, [torch.empty(shape(p, spec), dtype=torch.float32,
                                                   device="meta") for p, spec in pairs])

    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"), m=zeros(),
                      v=zeros())


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A host constant as an f32 tensor on ``like``'s device: a divisor (or
    dividend) must be a tensor, since torch computes ``t / host_scalar`` and
    ``host_scalar / t`` through a reciprocal, not as the reference's
    quotient."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``: f32 scalar."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / _f32(max(cfg.warmup_steps, 1), s), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (``None`` leaves count 0),
    summed leaf by leaf in flatten order. With ``shardings`` (the tree's
    ``partition.TreeShardings``) ``tree`` holds this rank's shards: the
    leaves are summed in flatten order within each set of mesh axes their
    specs shard, each set's sum is summed over those axes, and the sets are
    added in the order they first appear."""
    pairs = leaves_with_specs(tree, shardings.specs) if shardings is not None else \
        [(g, None) for g in tree_leaves(tree)]
    sums = {}
    for g, spec in pairs:
        if g is None:
            continue
        sq = torch.sum(torch.square(g.to(torch.float32)))
        axes = () if spec is None else sharded_axes(spec, shardings.mesh)
        sums[axes] = sq if axes not in sums else sums[axes] + sq
    if not sums:
        raise ValueError("global_norm of a tree without gradients")
    total = None
    for axes, sq in sums.items():
        for axis in axes:
            sq = all_reduce(sq, shardings.mesh, axis)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig, shardings=None):
    """Returns ``(new_params, new_state, metrics)``; ``grads`` has the
    params' tree shape, with ``None`` where a leaf received no gradient.
    ``shardings``: the params' placement on a mesh (``params``, ``grads``
    and the moments are this rank's shards), read by the global norm."""
    step = state.step + 1
    gnorm = global_norm(grads, shardings)
    scale = torch.clamp(_f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(cfg.b1, stepf), stepf)
    bc2 = 1 - torch.pow(_f32(cfg.b2, stepf), stepf)

    def upd(p, g, m, v):
        g = torch.zeros_like(p, dtype=torch.float32) if g is None else g.to(torch.float32)
        g = g * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m2 / bc1
        vhat = v2 / bc2
        pf = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype), m2, v2

    flat_p = tree_leaves(params)
    flat_g = leaves_like(params, grads)
    out = [upd(p, g, m, v) for p, g, m, v in
           zip(flat_p, flat_g, tree_leaves(state.m), tree_leaves(state.v))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr}
