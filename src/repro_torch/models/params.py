"""Parameter specs (port of ``repro.models.params``).

A model declares its parameters as a nested dict of :class:`ParamSpec`
(shape, logical axes, init rule). ``init`` draws the port's own random bits
from an explicit ``torch.Generator`` with the reference's shapes and scales;
``load_numpy_params`` takes the reference's raw parameter tree (nested dicts
of numpy arrays) by path, which is how tests give both packages the same
weights.
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


def init(specs, generator: torch.Generator, dtype=torch.float32):
    """Materialize parameters on the generator's device."""
    device = generator.device

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


def load_numpy_params(tree, device, specs=None, dtype=torch.float32):
    """The reference's raw parameter tree (nested dicts of numpy arrays) as the
    port's tree of tensors on ``device``, path by path. With ``specs`` every
    spec path must be present with its shape, and no other leaf may be."""
    def convert(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)

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
