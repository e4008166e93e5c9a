"""Deterministic fault injection for serving-resilience tests and the card's
smoke (port of ``repro.resilience.inject``).

A :class:`FaultInjector` holds a set of fault descriptions, each pinned to a
decode-round index (``at_round``); the server calls
``injector.before_round(server, round_idx, slot_of)`` immediately before
dispatching each burst / speculative round, and any fault whose round has
come fires exactly once. Nothing here reads the wall clock or an unseeded
PRNG — a fault plan is pure configuration, so an injected run is exactly as
reproducible as a clean one (which is what lets the robustness gates hold
the unaffected slots' streams *bit-identical*).

Fault kinds:

* :class:`NaNCacheFault` — overwrite one request's KV-cache rows (all
  layers, optionally one layer) with NaN, in place: the server's captured
  graphs keep reading the cache they were captured with, so the cache is
  never rebound (the reference rebinds ``server.cache``).
* :class:`NaNWeightFault` — poison prepared-weight leaves (optionally
  filtered by a path substring) at one execution point: f32 leaves (the
  carmen grid, the int8 scales) become NaN, integer banks (kernel and int8
  qvalues) become zeros — what the reference's kernel-mode dot makes of a
  NaN weight (its float→int cast maps NaN to 0). The poisoned
  point gets private copies of the leaves it matches (a bank's points share
  leaves, which must stay clean at the other points), and the server drops
  that point's graphs, to be re-captured at its next visit; every other
  point replays its graphs untouched. The poisoned tree persists for the
  rest of the server's life — build a fresh server per injected run.
* :class:`DelayFault` — sleep before one round's dispatch: models a stalled
  device / preempted host, for driving deadline expiry deterministically.

``oversized_request`` builds the admission-time shed probe (`too_long`).

In ``kernel`` mode a NaN does not reach a logit: every projection quantizes
its input (NaN to 0, saturating), so a poisoned slot's or point's logits
stay finite and its stream changes instead; the reference's kernel mode
does the same. ``ResilienceConfig.logit_limit`` is what flags a lane there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.backends.base import PreparedWeight

__all__ = ["DelayFault", "FaultInjector", "NaNCacheFault", "NaNWeightFault",
           "oversized_request", "poison_cache_slot", "poison_tree"]


def poison_cache_slot(cache, slot: int, layer: Optional[int] = None):
    """NaN every float leaf of ``cache`` at batch row ``slot``, in place.

    Cache leaves are stacked ``(layers, slots, ...)`` tensors; integer leaves
    (the per-layer write indices) are left intact so the decode program's
    control flow is untouched — only the slot's numerics blow up. Returns
    ``cache`` (the same object).
    """
    lsel = slice(None) if layer is None else layer
    for leaf in _leaves(cache):
        if leaf.is_floating_point():
            leaf[lsel, slot] = float("nan")
    return cache


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _zeros_strided(t: torch.Tensor) -> torch.Tensor:
    """A zero tensor with ``t``'s shape, strides and storage size (a K-major
    bank keeps its padded layout)."""
    store = torch.zeros(t.untyped_storage().nbytes() // t.element_size(), dtype=t.dtype,
                        device=t.device)
    return store.as_strided(t.shape, t.stride(), t.storage_offset())


def poison_tree(tree, match: Optional[str] = None):
    """A copy of a prepared-weight tree with its float leaves NaN and its
    integer banks zero (path-substring filtered, on the reference's path
    names: ``['seg0_dense']['attn']['wq']``). Matched leaves are new
    tensors; the others are the input tree's own."""
    hit = 0

    def walk(node, path):
        nonlocal hit
        if isinstance(node, dict):
            return {k: walk(v, f"{path}[{k!r}]") for k, v in node.items()}
        if match is not None and match not in path:
            return node
        if isinstance(node, PreparedWeight):
            hit += 1
            data = (torch.full_like(node.data, float("nan")) if node.data.is_floating_point()
                    else _zeros_strided(node.data))
            scale = None if node.scale is None else torch.full_like(node.scale, float("nan"))
            return dataclasses.replace(node, data=data, scale=scale)
        if isinstance(node, torch.Tensor) and node.is_floating_point():
            hit += 1
            return torch.full_like(node, float("nan"))
        return node

    out = walk(tree, "")
    if hit == 0:
        raise ValueError(f"no float weight leaf matched {match!r}")
    return out


@dataclasses.dataclass(frozen=True)
class NaNCacheFault:
    """Poison request ``rid``'s KV rows before round ``at_round``."""

    rid: int
    at_round: int
    layer: Optional[int] = None

    def apply(self, server, slot_of: Dict[int, int]) -> None:
        if not server.batched_prefill:
            raise ValueError(
                f"cache fault injection needs a scatterable KV cache; the "
                f"{server.model.cfg.family!r} family carries recurrent state"
            )
        if self.rid not in slot_of:
            raise ValueError(
                f"NaNCacheFault: request {self.rid} is not active at round "
                f"{self.at_round} (active slots: {sorted(slot_of)})"
            )
        with torch.no_grad():
            poison_cache_slot(server.cache, slot_of[self.rid], self.layer)


@dataclasses.dataclass(frozen=True)
class NaNWeightFault:
    """Poison prepared-weight leaves before round ``at_round``.

    ``point`` picks the bank execution point to corrupt (default: whatever
    the server would serve the next round at); ``layer`` is a substring
    matched against the leaf path (``None``: every weight leaf).
    """

    at_round: int
    layer: Optional[str] = None
    point: Optional[str] = None

    def apply(self, server, slot_of: Dict[int, int]) -> None:
        bank = getattr(server, "_bank", None)
        if bank is None:
            server.params = poison_tree(server.params, self.layer)
            server.weights_replaced(None)
            return
        name = self.point or server._serving_point() or bank.reference
        bank.trees[name] = poison_tree(bank.tree(name), self.layer)
        server.weights_replaced(name)


@dataclasses.dataclass(frozen=True)
class DelayFault:
    """Stall the host for ``seconds`` before round ``at_round`` dispatches."""

    at_round: int
    seconds: float

    def apply(self, server, slot_of: Dict[int, int]) -> None:
        time.sleep(self.seconds)


class FaultInjector:
    """Fires each configured fault once, at its round, before dispatch."""

    def __init__(self, *faults) -> None:
        self.faults: Tuple = tuple(faults)
        self.fired = []  # (round_idx, fault) in firing order

    def before_round(self, server, round_idx: int, slot_of: Dict[int, int]) -> None:
        for fault in self.faults:
            if fault.at_round == round_idx:
                fault.apply(server, slot_of)
                self.fired.append((round_idx, fault))


def oversized_request(rid: int, max_len: int, max_new: int = 8,
                      request_cls=None):
    """A request whose ``prompt + max_new`` overflows ``max_len`` — the
    admission-time ``too_long`` shed probe (legacy servers raise on it)."""
    if request_cls is None:
        from repro_torch.serve.engine import Request as request_cls
    prompt = np.ones((max(max_len - max_new + 1, 1),), np.int32)
    return request_cls(rid=rid, prompt=prompt, max_new=max_new)
