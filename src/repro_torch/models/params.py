"""Parameter specs (port of ``repro.models.params``).

A model declares its parameters as a nested dict of :class:`ParamSpec`
(shape, logical axes, init rule). ``init`` draws the port's own random bits
from an explicit ``torch.Generator`` with the reference's shapes and scales;
``load_numpy_params`` takes the reference's raw parameter tree (nested dicts
of numpy arrays) by path, which is how tests give both packages the same
weights. ``abstract`` gives meta tensors, which the dry run traces.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | small_normal
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: tree_map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def spec_leaves(specs, prefix=()):
    """(path, ParamSpec) pairs in the tree's insertion order."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from spec_leaves(v, prefix + (k,))
    else:
        yield prefix, specs


def stack_layers(spec_fn, n: int):
    """Stack one layer's specs along a leading 'layers' axis."""
    return tree_map_specs(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale), spec_fn()
    )



def abstract(specs, dtype=torch.float32):
    """Meta tensors of the specs' shapes in ``dtype``: the dry run's
    zero-memory stand-in."""
    return tree_map_specs(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), specs)


def axes_tree(specs):
    """Each parameter's logical axes, in the specs' tree."""
    return tree_map_specs(lambda s: s.axes, specs)


def count_params(specs) -> int:
    return int(sum(math.prod(s.shape) for _, s in spec_leaves(specs)))

def init(specs, generator: torch.Generator, dtype=torch.float32, mesh=None):
    """Materialize parameters on the generator's device. With ``mesh``
    (tensor parallelism) each leaf is drawn whole, in the same order and from
    the same generator, and only this rank's shard of it is kept
    (``sharding.partition.shard_tensor``): the shards of the unsharded init,
    never the whole tree at once."""
    device = generator.device
    if mesh is not None:
        from repro_torch.sharding.partition import param_pspec, shard_tensor

        whole = init
        return tree_map_specs(
            lambda s: shard_tensor(whole({"x": s}, generator, dtype)["x"],
                                   param_pspec(s, mesh), mesh), specs)

    def make(s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=device)
        scale = s.scale
        if s.init == "small_normal":
            scale = s.scale / math.sqrt(max(s.shape[0], 1))
        out = torch.randn(s.shape, generator=generator, dtype=dtype, device=device)
        return out.mul_(scale)

    return tree_map_specs(make, specs)


def load_numpy_params(tree, device, specs=None, dtype=torch.float32, mesh=None):
    """The reference's raw parameter tree (nested dicts of numpy arrays) as the
    port's tree of tensors on ``device``, path by path. With ``specs`` every
    spec path must be present with its shape, and no other leaf may be.

    With ``mesh`` (and ``specs``) the sharded form: each numpy leaf is
    sliced to this rank's shard before it becomes a tensor, so a rank never
    holds the whole tree on ``device``."""
    def convert(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)

    if mesh is not None:
        if specs is None:
            raise ValueError("load_numpy_params(mesh=) needs the specs")
        from repro_torch.sharding.partition import local_index, param_pspec

        def walk(node, spec):
            if isinstance(node, dict):
                return {k: walk(v, spec[k]) for k, v in node.items()}
            if tuple(np.shape(node)) != tuple(spec.shape):
                raise ValueError(f"leaf of shape {np.shape(node)} for spec {spec.shape}")
            return convert(np.asarray(node)[local_index(spec.shape, param_pspec(spec, mesh),
                                                        mesh)])

        return walk(tree, specs)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return convert(node)

    out = walk(tree)
    if specs is not None:
        want = {p: s.shape for p, s in spec_leaves(specs)}
        got = {p: tuple(t.shape) for p, t in spec_leaves(out)
               if isinstance(t, torch.Tensor)}
        if want != got:
            missing = sorted(set(want) - set(got))
            extra = sorted(set(got) - set(want))
            bad = sorted(p for p in set(want) & set(got) if want[p] != got[p])
            raise ValueError(f"parameter tree does not match the specs: missing {missing}, "
                             f"extra {extra}, wrong shape {bad}")
    return out
