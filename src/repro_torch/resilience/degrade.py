"""Graceful precision degradation: a cap layered on the controller's ladder
(port of ``repro.resilience.degrade``, pure Python as there).

CARMEN's runtime knob — CORDIC iteration depth — trades accuracy for cycles
with zero weight-side work per switch. :class:`DegradationPolicy` uses that
knob for *survival*: under sustained overload (deadline misses, shed
requests, a full queue with nothing free) it caps the whole batch's
execution point further and further down the bank's cheap->accurate ladder,
so the engine emits approximate tokens fast instead of accurate tokens
late; when the pressure clears it lifts the cap back one rung at a time
with its own (longer) hysteresis, so a transient lull does not bounce the
batch straight back into overload.

The policy *wraps* a :class:`~repro_torch.runtime.controller.ModeController` and
is duck-type compatible with it (``point`` / ``tree()`` / ``observe()`` /
``reset()`` / ``bank`` / ``switches`` / ``on_switch``), so
``BatchedServer(controller=DegradationPolicy(inner))`` needs no engine
changes: the effective point is ``min(inner's choice, cap)`` on the ladder
index, which composes with both adaptive controllers (the margin/budget
logic keeps voting underneath the cap) and pinned ones (``pin="accurate"``
under a cap degrades the whole batch — the benchmark's comparison case).
Only *effective*-point changes fire ``on_switch``, so the serving trace and
switch counters describe what actually executed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["DegradationConfig", "DegradationPolicy"]


@dataclasses.dataclass(frozen=True)
class DegradationConfig:
    floor: Optional[str] = None     # cheapest point the cap may reach (default: rung 0)
    demote_hysteresis: int = 1      # consecutive pressured observations per cap drop
    promote_hysteresis: int = 4     # consecutive calm observations per cap lift

    def __post_init__(self):
        if self.demote_hysteresis < 1 or self.promote_hysteresis < 1:
            raise ValueError("hysteresis values must be >= 1")


class DegradationPolicy:
    """Overload-driven cap over a ModeController's execution-point ladder."""

    def __init__(self, inner, config: Optional[DegradationConfig] = None):
        self.inner = inner
        self.cfg = config or DegradationConfig()
        self.bank = inner.bank
        if self.cfg.floor is not None and self.cfg.floor not in self.bank.names:
            raise ValueError(
                f"unknown floor point {self.cfg.floor!r}; bank has "
                f"{self.bank.names}"
            )
        self._floor_idx = (self.bank.index(self.cfg.floor)
                           if self.cfg.floor is not None else 0)
        self._top_idx = len(self.bank.points) - 1
        self.on_switch = None  # wired per run by the server (observer hook)
        self.reset()

    def reset(self) -> None:
        self.inner.reset()
        self._cap = self._top_idx
        self._pressure_streak = 0
        self._calm_streak = 0
        self.switches = 0
        self.demotions = 0
        self.promotions = 0

    # -- ModeController duck-type ---------------------------------------------

    @property
    def point(self) -> str:
        """The capped effective point the next step executes at."""
        idx = min(self.bank.index(self.inner.point), self._cap)
        return self.bank.points[idx].name

    @property
    def cap(self) -> str:
        return self.bank.points[self._cap].name

    def tree(self):
        return self.bank.tree(self.point)

    @property
    def rel_cycles_ema(self) -> float:
        return self.inner.rel_cycles_ema

    def observe(self, signals) -> str:
        """Feed the inner controller, then move the cap on overload signals.

        Pressure is any of: a deadline missed this observation, a request
        shed this observation, or a non-empty queue with zero free slots.
        The inner controller's ``on_switch`` stays unwired — only effective-
        point changes (cap moves or uncapped inner moves) fire ours.
        """
        old = self.point
        self.inner.observe(signals)
        pressure = (
            getattr(signals, "deadline_misses", 0) > 0
            or getattr(signals, "shed", 0) > 0
            or (signals.queue_depth > 0 and signals.free_slots == 0)
        )
        if pressure:
            self._calm_streak = 0
            self._pressure_streak += 1
            if (self._pressure_streak >= self.cfg.demote_hysteresis
                    and self._cap > self._floor_idx):
                self._cap -= 1
                self.demotions += 1
                self._pressure_streak = 0
        else:
            self._pressure_streak = 0
            self._calm_streak += 1
            if (self._calm_streak >= self.cfg.promote_hysteresis
                    and self._cap < self._top_idx):
                self._cap += 1
                self.promotions += 1
                self._calm_streak = 0
        new = self.point
        if new != old:
            self.switches += 1
            if self.on_switch is not None:
                self.on_switch(old, new, signals)
        return new
