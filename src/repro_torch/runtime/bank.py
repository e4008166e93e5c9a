"""Multi-point weight banks: every execution mode prepared in one pass (port
of ``repro.runtime.bank``).

An :class:`ExecutionPoint` names a whole-model precision policy (the paper's
"approximate" / "accurate" configuration-register settings, generalized to a
ladder). :func:`build_bank` runs ``prepare_params`` once per point through a
shared memo, so any layer whose per-layer (format, depth) agrees between two
points is materialized once and aliased into every tree. The server then
switches points by handing another resident tree to its programs: no
weight-side work and no copy per switch.

In kernel mode a leaf's integers depend on its depth (the signed-digit
rounding), so points that differ in depth or format hold separate banks:
olmo-1b's default ladder holds three. On the card each (program, point) is
its own captured graph (``serve/engine.py``), since a graph replays the
addresses it was captured with.

Under tensor parallelism a rank holds the shard of every point's tree
(:func:`place_bank` shards a whole bank, each shared leaf once, so aliasing
survives; ``build_bank(mesh=)`` slices the raw tree first and prepares only
the shards, so a rank never holds a whole prepared bank).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.core.backends import PreparedWeight, prepare_params
from repro_torch.core.fxp import FXP8, FXP16, FxPFormat
from repro_torch.core.precision_policy import PrecisionPolicy, pin_critical

from .telemetry import calibration_id, estimate_point_cycles

__all__ = ["ExecutionPoint", "MultiPointBank", "build_bank", "default_points", "place_bank"]


@dataclasses.dataclass(frozen=True)
class ExecutionPoint:
    """One runtime-selectable mode: a name plus the policy it executes."""

    name: str
    policy: PrecisionPolicy


def default_points(
    fmt: FxPFormat = FXP8,
    *,
    base_policy: Optional[PrecisionPolicy] = None,
    hifi_fmt: Optional[FxPFormat] = FXP16,
) -> Tuple[ExecutionPoint, ...]:
    """The canonical mode ladder: {approx fmt, full fmt, full hifi_fmt}.

    When ``base_policy`` carries per-layer overrides (a sensitivity-scan
    assignment), it becomes the cheapest point, ``"mixed"``. Otherwise the
    cheapest point is uniform approximate depth with the critical-layer
    floor pinned. ``hifi_fmt=None`` (or equal to ``fmt``) drops the third
    point.
    """
    if base_policy is not None and base_policy.overrides:
        cheap = ExecutionPoint("mixed", pin_critical(base_policy))
    else:
        cheap = ExecutionPoint("approx", pin_critical(PrecisionPolicy.approximate(fmt)))
    points = [cheap, ExecutionPoint("accurate", PrecisionPolicy.accurate(fmt))]
    if hifi_fmt is not None and hifi_fmt != fmt:
        points.append(ExecutionPoint("hifi", PrecisionPolicy.accurate(hifi_fmt)))
    return tuple(points)


@dataclasses.dataclass
class MultiPointBank:
    """Prepared trees for every execution point, cheapest first.

    ``cycles_per_token`` is the estimated engine MAC cycles one decoded token
    costs at each point (``runtime.telemetry``); ``reference`` names the
    all-accurate baseline savings are quoted against and ``cycle_model`` the
    calibration (or ``"analytic"``) behind the cycles. ``shared_leaves``
    counts prepared leaves aliased between at least two points.
    """

    mode: str
    points: Tuple[ExecutionPoint, ...]
    trees: Dict[str, Any]
    cycles_per_token: Dict[str, float]
    reference: str
    shared_leaves: int = 0
    unique_leaves: int = 0
    cycle_model: str = "analytic"
    # the mesh whose shards the trees hold (None: whole trees)
    mesh: Any = None

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.points)

    def tree(self, name: str):
        return self.trees[name]

    def index(self, name: str) -> int:
        return self.names.index(name)

    def rel_cycles(self, name: str) -> float:
        """Cycle cost of ``name`` relative to the all-accurate reference."""
        return self.cycles_per_token[name] / self.cycles_per_token[self.reference]


def _prepared_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _prepared_leaves(v)
    elif isinstance(tree, PreparedWeight):
        yield tree


def _leaf_ids(tree) -> set:
    return {id(leaf) for leaf in _prepared_leaves(tree)}


def build_bank(
    params,
    mode: str,
    points: Optional[Sequence[ExecutionPoint]] = None,
    *,
    specs=None,
    reference: Optional[str] = None,
    calibration: Optional[Dict] = None,
    mesh=None,
) -> MultiPointBank:
    """Materialize the multi-point weight bank (one prepare pass, shared memo)
    on the device of ``params``.

    Points are ordered cheapest to most expensive by estimated MAC cycles.
    ``reference`` defaults to ``"accurate"`` when present, else the most
    expensive point. ``calibration`` (a ``sim.calibrate`` export) refines the
    per-point cycle estimates; ``bank.cycle_model`` records which model
    produced them. With ``mesh`` (tensor parallelism) the cycles are the
    whole model's, and the trees hold this rank's shards: the raw tree is
    sliced once, then every point prepares the slices.
    """
    if mode == "exact":
        raise ValueError(
            "adaptive banks need a depth-configurable backend "
            "(carmen | int8 | kernel); 'exact' has no precision knob"
        )
    points = tuple(points if points is not None else default_points())
    if len(points) < 2:
        raise ValueError("a multi-point bank needs at least two execution points")
    if len({p.name for p in points}) != len(points):
        raise ValueError("execution point names must be unique")

    cycles = {
        p.name: estimate_point_cycles(params, p.policy, specs=specs,
                                      calibration=calibration)
        for p in points
    }
    points = tuple(sorted(points, key=lambda p: cycles[p.name]))
    if reference is None:
        reference = "accurate" if "accurate" in cycles else points[-1].name
    if reference not in cycles:
        raise ValueError(f"reference point {reference!r} not in {sorted(cycles)}")

    if mesh is not None:
        if specs is None:
            raise ValueError("build_bank(mesh=) needs the model's param specs")
        from repro_torch.sharding.partition import shard_params

        params = shard_params(params, specs, mesh)
    memo: Dict = {}
    trees = {
        p.name: prepare_params(params, p.policy, mode, specs=specs, memo=memo)
        for p in points
    }

    id_sets = [_leaf_ids(t) for t in trees.values()]
    all_ids = set().union(*id_sets)
    shared = {i for i in all_ids if sum(i in s for s in id_sets) >= 2}
    return MultiPointBank(
        mode=mode,
        points=points,
        trees=trees,
        cycles_per_token=cycles,
        reference=reference,
        shared_leaves=len(shared),
        unique_leaves=len(all_ids),
        cycle_model=calibration_id(calibration),
        mesh=mesh,
    )


def place_bank(bank: MultiPointBank, mesh, specs) -> MultiPointBank:
    """Shard every tree of ``bank`` for this rank of ``mesh`` with the
    logical-axis rules (``sharding.partition.shard_params``): each leaf
    once per tensor identity, re-aliased into every point's tree, so pinned
    and agreeing layers stay one copy. Mutates ``bank.trees`` in place
    (controllers and speculative decoders hold the bank) and returns the
    bank. Idempotent for the same mesh; a bank placed on another raises."""
    if bank.mesh is mesh:
        return bank
    if bank.mesh is not None:
        raise ValueError("the bank already holds another mesh's shards")
    if specs is None:
        raise ValueError("place_bank needs the model's param specs (model.specs())")
    from repro_torch.sharding.partition import shard_params

    memo: Dict = {}
    for name in bank.names:
        bank.trees[name] = shard_params(bank.trees[name], specs, mesh, memo)
    bank.mesh = mesh
    return bank
