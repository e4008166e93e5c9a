"""Backend registry + the one-time ``prepare_params`` pass (port of
``repro.core.backends``).

The engine's four execution modes (``exact`` / ``carmen`` / ``int8`` /
``kernel``) are registered backends. The classification rules (which leaves
reach ``EngineContext.dot``, their policy names and stacked axes) and the
tied ``lm_head`` materialization are the reference's.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from ..precision_policy import PrecisionPolicy
from .base import Backend, PreparedWeight, unit_fmt
from .carmen import CarmenBackend, carmen_dot, quantize_activations, sd_round_traced
from .exact import ExactBackend
from .int8 import Int8Backend, effective_bits, int8_dot, quantize_weight
from .kernel import KernelBackend

__all__ = [
    "Backend", "PreparedWeight", "get_backend", "register", "resolve",
    "iter_dot_weights", "prepare_params", "unit_fmt", "carmen_dot", "int8_dot",
    "quantize_activations", "sd_round_traced", "effective_bits", "quantize_weight",
]

_REGISTRY: Dict[str, Backend] = {}


def register(backend: Backend) -> Backend:
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown engine mode {name!r}") from None


def resolve(w, mode: str) -> Backend:
    """Backend for one dot: the prepared leaf's own backend wins, else the mode."""
    if isinstance(w, PreparedWeight) and w.backend != "exact":
        return get_backend(w.backend)
    return get_backend(mode)


for _b in (ExactBackend(), CarmenBackend(), Int8Backend(), KernelBackend()):
    register(_b)


_DOT_WEIGHT_NAMES = frozenset({
    "wq", "wk", "wv", "wo", "up", "gate", "down",
    "in_proj", "out_proj", "wq_a", "wq_b", "wkv_a", "lm_head",
})

_KEY_RENAMES = {
    "wq": "q", "wk": "k", "wv": "v", "wo": "o",
    "wq_a": "q_a", "wq_b": "q_b", "wkv_a": "kv_a",
    "self_attn": "self", "cross_attn": "cross",
    "enc_layers": "enc", "dec_layers": "dec",
}

_SEG_RE = re.compile(r"^seg\d+_(\w+)$")


def _flatten(tree, prefix=()):
    """(path keys, leaf) pairs of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _unflatten_like(tree, leaves, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, leaves, prefix + (str(k),)) for k, v in tree.items()}
    return leaves[prefix]


def _eligible(keys) -> bool:
    if not keys or keys[-1] not in _DOT_WEIGHT_NAMES:
        return False
    if len(keys) >= 2 and keys[-2] == "moe":
        return False
    return True


def _policy_name(keys) -> str:
    return ".".join("layer" if _SEG_RE.match(k) else _KEY_RENAMES.get(k, k) for k in keys)


def _stacked_axes(keys, spec) -> int:
    if spec is not None:
        n = 0
        for ax in spec.axes:
            if ax != "layers":
                break
            n += 1
        return n
    m = _SEG_RE.match(keys[0]) if keys else None
    if m:
        return 2 if m.group(1) == "hybrid" else 1
    if keys and keys[0] in ("enc_layers", "dec_layers"):
        return 1
    return 0


def _classify(keys, leaf, spec):
    """(policy_name, stacked_axes, in_axes) of an engine-routed matmul weight,
    or None when the leaf never reaches ``EngineContext.dot``."""
    if not _eligible(keys) or not hasattr(leaf, "ndim"):
        return None
    stacked = _stacked_axes(keys, spec)
    if leaf.ndim - stacked < 2:
        return None
    in_axes = leaf.ndim - stacked - 1 if keys[-1] == "wo" else 1
    return _policy_name(keys), stacked, in_axes


def iter_dot_weights(params, *, specs=None):
    """Yield ``(keys, policy_name, leaf, stacked_axes, in_axes)`` for every
    weight leaf of ``params`` that reaches ``EngineContext.dot``: the leaves
    ``prepare_params`` formats and the names the calibration scan perturbs.
    Raw and prepared trees alike (a :class:`PreparedWeight` is one leaf, and
    a prepared tree's materialized ``lm_head`` is yielded); a tied raw tree
    has no ``lm_head`` leaf, so callers add that name themselves."""
    spec_of = dict(_flatten(specs)) if specs is not None else {}
    for keys, leaf in _flatten(params):
        info = _classify(keys, leaf, spec_of.get(keys))
        if info is not None:
            name, stacked, in_axes = info
            yield keys, name, leaf, stacked, in_axes


def prepare_params(params, policy: Optional[PrecisionPolicy], mode: str, *,
                   specs=None, memo: Optional[Dict] = None):
    """Materialize per-layer prepared weight banks for serving.

    Replaces every engine-routed matmul weight with the ``mode`` backend's
    prepared form at the policy's per-layer (fmt, depth): signed-digit
    integers for ``kernel``, the f32 signed-digit grid for ``carmen``, int8
    qvalues + per-channel scales for ``int8``, the tree itself for
    ``exact``. Tied-embedding models get an explicit prepared ``lm_head``
    (the transposed embedding); the embedding itself stays float for the
    table lookup.
    """
    backend = get_backend(mode)
    if mode == "exact":
        return params
    policy = policy or PrecisionPolicy.accurate()
    if memo is None:
        memo = {}
    out = dict(_flatten(params))
    for keys, name, leaf, stacked, in_axes in iter_dot_weights(params, specs=specs):
        if isinstance(leaf, PreparedWeight):
            continue
        lp = policy.for_layer(name)
        key = (id(leaf), mode, lp, stacked)
        if key not in memo:
            memo[key] = backend.prepare(leaf, lp, stacked_axes=stacked, in_axes=in_axes)
        out[keys] = memo[key]
    prepared = _unflatten_like(params, out)

    if isinstance(prepared, dict) and "lm_head" not in prepared and "embed" in prepared:
        embed = params["embed"]
        if isinstance(embed, torch.Tensor) and embed.ndim == 2:
            lp = policy.for_layer("lm_head")
            key = (id(embed), "lm_head.T", mode, lp)
            if key not in memo:
                memo[key] = backend.prepare(embed.T, lp, stacked_axes=0)
            prepared = dict(prepared)
            prepared["lm_head"] = memo[key]
    return prepared
