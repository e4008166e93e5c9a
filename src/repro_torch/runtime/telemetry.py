"""Serving telemetry: mode occupancy, MAC-cycle accounting, switch counts
(port of ``repro.runtime.telemetry``).

Cycle model: one iteration of the iterative CORDIC PE is one cycle, so a
K-length dot at depth d costs K*(d+1) cycles. A weight tensor therefore costs
numel(W)*(d+1) cycles per token pushed through it;
:func:`estimate_point_cycles` folds that over every engine-routed weight at a
policy's per-layer depths. It is the paper's iterative-PE model, not the time
a GPU takes: on the card an approximate and an accurate FxP8 point move the
same int8 bank bytes.

A ``sim.calibrate`` export refines the constant: its ``mac_overhead`` (extra
cycles per MAC beyond the depth+1 pipeline) joins the per-leaf charge, and
every record names which calibration (or ``"analytic"``) produced its
``est_cycles``.

Cycle sums are host float64 over the weights in the reference's order (its
tree flattening sorts dict keys), so they equal the reference's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.backends import iter_dot_weights
from repro_torch.core.precision_policy import PrecisionPolicy

__all__ = ["TelemetryRecorder", "calibration_id", "estimate_point_cycles",
           "layer_cost_table", "teacher_forced_agreement"]


def calibration_id(calibration: Optional[Dict]) -> str:
    """The provenance tag a telemetry record carries for its cycle model."""
    if calibration is None:
        return "analytic"
    return str(calibration.get("id", "calibrated"))


def _mac_overhead(calibration: Optional[Dict]) -> float:
    if calibration is None:
        return 0.0
    return float(calibration.get("constants", {}).get("mac_overhead", 0.0))


def _iter_costed_weights(params, *, specs=None):
    """Yield ``(name, shape)`` for every engine-routed weight the cycle model
    charges, in sorted key order: the ``iter_dot_weights`` leaves plus the
    tied-embedding lm_head (a raw tree has no leaf for it; the engine still
    pays its dot)."""
    for _, name, leaf, _, _ in sorted(iter_dot_weights(params, specs=specs),
                                      key=lambda item: item[0]):
        yield name, tuple(int(s) for s in leaf.shape)
    if isinstance(params, dict) and "lm_head" not in params and "embed" in params:
        embed = params["embed"]
        if hasattr(embed, "shape") and getattr(embed, "ndim", 0) == 2:
            v, d = (int(s) for s in embed.shape)
            yield "lm_head", (d, v)


def estimate_point_cycles(params, policy: PrecisionPolicy, *, specs=None,
                          calibration: Optional[Dict] = None) -> float:
    """Estimated engine MAC cycles per decoded token under ``policy``:
    numel * (mac_overhead + depth + 1) summed over the leaves
    ``prepare_params`` formats (plus the tied lm_head), raw or prepared tree.
    ``calibration=None`` is the analytic model (overhead 0)."""
    overhead = _mac_overhead(calibration)
    total = 0.0
    for name, shape in _iter_costed_weights(params, specs=specs):
        depth = policy.for_layer(name).depth
        total += float(np.prod(shape)) * (overhead + depth + 1)
    return total


def layer_cost_table(params, policies: Dict[str, PrecisionPolicy], *,
                     specs=None) -> List[Dict]:
    """One JSON-able row per engine-routed weight leaf: its policy name,
    shape, and the (depth, format bits) each execution point runs it at."""
    rows = []
    for name, shape in _iter_costed_weights(params, specs=specs):
        rows.append({
            "layer": name,
            "shape": list(shape),
            "points": {
                pname: {"depth": int(pol.for_layer(name).depth),
                        "bits": int(pol.for_layer(name).fmt.bits)}
                for pname, pol in policies.items()
            },
        })
    return rows


def teacher_forced_agreement(model, ctx, tree, requests, results, margins):
    """Greedy-match rate of ``tree`` against a reference run's outputs.

    Teacher-forced: the execution point under test re-predicts every
    generated token of the reference run given the reference run's own
    prefix (one cache-free ``forward`` a request, on the device of ``tree``).
    Returns ``(overall, high_confidence, threshold, n_high)``, tokens split at
    the median reference top-2 margin. Requests that generated nothing are
    skipped; a run where every request is empty raises; a request's margins
    must align one-to-one with its generated tokens; with no token at or
    above the threshold the high-confidence rate is the overall rate and
    ``n_high`` is 0.
    """
    device = _tree_device(tree)
    matches, flat = [], []
    for req in requests:
        gen = np.asarray(results[req.rid], np.int32)
        if gen.size == 0:  # nothing generated: nothing to score
            continue
        req_margins = margins[req.rid]
        if len(req_margins) != gen.size:
            raise ValueError(
                f"request {req.rid}: {len(req_margins)} margins for "
                f"{gen.size} generated tokens — margins must align "
                "one-to-one with the reference run's tokens"
            )
        seq = np.concatenate([np.asarray(req.prompt, np.int32), gen])
        tokens = torch.as_tensor(seq[None, :-1], dtype=torch.int64, device=device)
        with torch.no_grad():
            logits, _ = model.forward(tree, {"tokens": tokens}, ctx)
        pred = logits[0].argmax(-1).cpu().numpy()
        start = len(req.prompt) - 1
        matches.extend(pred[start:start + len(gen)] == gen)
        flat.extend(req_margins)
    matches, flat = np.asarray(matches), np.asarray(flat, np.float64)
    if matches.size == 0:
        raise ValueError(
            "teacher_forced_agreement: no generated tokens to score (every "
            "request's generation is empty)"
        )
    thr = float(np.median(flat))
    high = flat >= thr
    overall = float(matches.mean())
    high_conf = float(matches[high].mean()) if high.any() else overall
    return overall, high_conf, thr, int(high.sum())


def _tree_device(tree) -> torch.device:
    """The device of the first tensor in a (possibly prepared) weight tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            dev = _tree_device(v)
            if dev is not None:
                return dev
        return None
    data = getattr(tree, "data", tree)
    return data.device if isinstance(data, torch.Tensor) else None


@dataclasses.dataclass
class TelemetryRecorder:
    """Accumulates per-observation serving telemetry for one adaptive run.

    ``record_burst`` is called once per decode burst (the server's host
    round-trip) with the executed point, the tokens emitted and the engine
    steps it ran; ``record_step`` is its ``steps=1`` case (a classic step or
    a speculative round); ``record_prefill`` charges prompt tokens without
    counting an observation or a switch. ``steps`` counts observations,
    aligned with ``min_margins``; ``decode_steps`` counts engine steps.
    Savings are relative to running every token at the bank's reference
    (all-accurate) point.
    """

    cycles_per_token: Dict[str, float]
    reference: str
    cycle_model: str = "analytic"  # which calibration produced est_cycles

    def __post_init__(self):
        self.reset()

    @classmethod
    def for_bank(cls, bank) -> "TelemetryRecorder":
        return cls(dict(bank.cycles_per_token), bank.reference,
                   getattr(bank, "cycle_model", "analytic"))

    def reset(self) -> None:
        self.steps = 0  # observations: bursts, classic steps, spec rounds
        self.decode_steps = 0
        self.switches = 0
        self.tokens_by_point: Dict[str, int] = {k: 0 for k in self.cycles_per_token}
        self.steps_by_point: Dict[str, int] = {k: 0 for k in self.cycles_per_token}
        self.est_cycles = 0.0
        self.baseline_cycles = 0.0
        self.min_margins: list = []
        self._prev_point: Optional[str] = None

    def _charge(self, point: str, tokens: int) -> None:
        self.tokens_by_point[point] += tokens
        self.est_cycles += tokens * self.cycles_per_token[point]
        self.baseline_cycles += tokens * self.cycles_per_token[self.reference]

    def record_prefill(self, point: str, tokens: int) -> None:
        self._charge(point, tokens)

    def record_burst(self, point: str, tokens: int, steps: int = 1,
                     min_margin: Optional[float] = None) -> None:
        """One decode burst: ``tokens`` emitted over ``steps`` engine steps,
        all at ``point``; ``min_margin`` is the min over its emitted tokens."""
        self.steps += 1
        self.decode_steps += steps
        self.steps_by_point[point] += 1
        if self._prev_point is not None and point != self._prev_point:
            self.switches += 1
        self._prev_point = point
        self._charge(point, tokens)
        if min_margin is not None:
            self.min_margins.append(float(min_margin))

    def record_step(self, point: str, active: int, min_margin: Optional[float] = None) -> None:
        self.record_burst(point, tokens=active, steps=1, min_margin=min_margin)

    @property
    def tokens(self) -> int:
        return sum(self.tokens_by_point.values())

    def savings_frac(self) -> float:
        """Estimated fraction of MAC cycles saved vs all-accurate serving."""
        if self.baseline_cycles <= 0:
            return 0.0
        return 1.0 - self.est_cycles / self.baseline_cycles

    def to_dict(self) -> Dict:
        """The unified telemetry record, one shape shared with
        :meth:`repro_torch.spec.telemetry.SpecTelemetry.to_dict`: ``kind``,
        ``cycle_model``, ``reference``, ``tokens``, ``est_cycles``,
        ``baseline_cycles``, ``est_cycle_savings_frac`` (full precision) and
        the kind's ``summary()`` under ``detail``."""
        return {
            "kind": "adaptive",
            "cycle_model": self.cycle_model,
            "reference": self.reference,
            "tokens": self.tokens,
            "est_cycles": self.est_cycles,
            "baseline_cycles": self.baseline_cycles,
            "est_cycle_savings_frac": self.savings_frac(),
            "detail": self.summary(),
        }

    def summary(self) -> Dict:
        tokens = max(self.tokens, 1)
        return {
            "steps": self.steps,
            "decode_steps": self.decode_steps,
            "tokens": self.tokens,
            "switches": self.switches,
            "mode_occupancy": {
                k: round(v / tokens, 4) for k, v in self.tokens_by_point.items()
            },
            "steps_by_point": dict(self.steps_by_point),
            "est_mac_cycles": self.est_cycles,
            "all_accurate_mac_cycles": self.baseline_cycles,
            "est_cycle_savings_frac": round(self.savings_frac(), 4),
            "reference": self.reference,
        }
