"""Speculative-serving telemetry: acceptance + weight-pass cycle accounting
(port of ``repro.spec.telemetry``; pure host bookkeeping).

Cycle model (the ``K*(depth+1)`` iterative-PE model, latency form): decode is
weight-bound — every step streams the weight bank through the PE array once,
at ``numel(W) * (depth+1)`` cycles per engine dot (``runtime.telemetry``'s
per-token quantity). A multi-token verify forward streams the bank ONCE for
all ``k+1`` positions (weight-stationary PEs broadcast each resident weight
across the block), so one speculative round costs

    k * cycles(draft_point) + 1 * cycles(verify_point)

weight-pass cycles per slot and emits ``accepted + 1`` tokens, against
``emitted * cycles(verify_point)`` for accurate-only serving of the same
tokens. Savings are positive once the mean accepted length clears
``k * rel_cycles(draft)`` — the break-even the bench records. (Pure MAC *op*
counts go up under speculation; the win is sequential weight passes, which is
what decode latency follows.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class SpecTelemetry:
    """Accumulates per-round speculative-serving telemetry for one run."""

    cycles_per_token: Dict[str, float]
    reference: str
    draft_len: int
    cycle_model: str = "analytic"  # which calibration produced est_cycles

    def __post_init__(self):
        self.reset()

    @classmethod
    def for_bank(cls, bank, draft_len: int) -> "SpecTelemetry":
        return cls(dict(bank.cycles_per_token), bank.reference, draft_len,
                   getattr(bank, "cycle_model", "analytic"))

    def reset(self) -> None:
        self.rounds = 0
        self.drafted = 0
        self.accepted = 0
        self.emitted = 0
        self.rounds_by_draft_point: Dict[str, int] = {
            k: 0 for k in self.cycles_per_token
        }
        self.est_cycles = 0.0
        self.baseline_cycles = 0.0

    def record_round(self, draft_point: str, verify_point: str,
                     accepted, emitted) -> None:
        """One draft+verify round: per-active-slot accepted/emitted counts."""
        self.rounds += 1
        self.rounds_by_draft_point[draft_point] += 1
        c_draft = self.cycles_per_token[draft_point]
        c_verify = self.cycles_per_token[verify_point]
        for acc, emit in zip(accepted, emitted):
            self.drafted += self.draft_len
            self.accepted += int(acc)
            self.emitted += int(emit)
            self.est_cycles += self.draft_len * c_draft + c_verify
            self.baseline_cycles += int(emit) * c_verify

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)

    @property
    def tokens_per_step(self) -> float:
        """Mean tokens committed per verify step (slot-rounds)."""
        slot_rounds = self.drafted / max(self.draft_len, 1)
        return self.emitted / max(slot_rounds, 1)

    def savings_frac(self) -> float:
        """Estimated weight-pass cycles saved vs accurate-only serving."""
        if self.baseline_cycles <= 0:
            return 0.0
        return 1.0 - self.est_cycles / self.baseline_cycles

    def to_dict(self) -> Dict:
        """The unified telemetry export shape shared with
        :meth:`repro_torch.runtime.telemetry.TelemetryRecorder.to_dict` — common
        keys (``kind``/``reference``/``tokens``/``est_cycles``/
        ``baseline_cycles``/``est_cycle_savings_frac``) with the speculative
        ``summary()`` under ``detail``, so adaptive and speculative records
        from one run are consumed uniformly by the metrics registry and the
        trace header."""
        return {
            "kind": "speculative",
            "cycle_model": self.cycle_model,
            "reference": self.reference,
            "tokens": self.emitted,
            "est_cycles": self.est_cycles,
            "baseline_cycles": self.baseline_cycles,
            # full precision, like TelemetryRecorder.to_dict: the replay
            # gate compares against this value (summary() rounds for humans)
            "est_cycle_savings_frac": self.savings_frac(),
            "detail": self.summary(),
        }

    def summary(self) -> Dict:
        return {
            "rounds": self.rounds,
            "draft_len": self.draft_len,
            "drafted": self.drafted,
            "accepted": self.accepted,
            "emitted": self.emitted,
            "acceptance_rate": round(self.acceptance_rate, 4),
            "mean_accepted_per_step": round(
                self.accepted * self.draft_len / max(self.drafted, 1), 4
            ),
            "tokens_per_step": round(self.tokens_per_step, 4),
            "rounds_by_draft_point": dict(self.rounds_by_draft_point),
            "est_weight_pass_cycles": self.est_cycles,
            "accurate_only_cycles": self.baseline_cycles,
            "est_cycle_savings_frac": round(self.savings_frac(), 4),
            "reference": self.reference,
        }
