"""The serving-loop mode controller: per-observation execution-point selection
(port of ``repro.runtime.controller``; pure host logic).

Once per observation (a whole decode burst, or a speculative round) the
:class:`ModeController` reads :class:`StepSignals` and votes to demote (a
cheaper execution point), promote (toward accurate), or hold:

* **cycle budget**: an EMA of the relative MAC-cycle cost of recent steps is
  steered toward ``cycle_budget`` (a fraction of the all-accurate cost).
  Over budget always demotes and blocks promotion.
* **admission pressure**: a non-empty queue with no free slot demotes.
* **logit margin**: a least-confident top-2 margin at or above
  ``margin_demote`` demotes, one below ``margin_promote`` promotes; a
  non-finite margin votes as no margin.

A vote must repeat ``hysteresis`` consecutive observations before the
controller moves one rung. Every reachable point pins the critical layers
accurate (``pin_critical``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .bank import MultiPointBank

__all__ = ["ControllerConfig", "ModeController", "StepSignals"]


@dataclasses.dataclass(frozen=True)
class StepSignals:
    """One observation's telemetry, as seen by the controller. A burst is one
    observation: ``min_margin`` is the min over every token it emitted and
    ``steps`` the engine steps it covered (the budget EMA advances as if each
    step had been observed). ``deadline_misses`` and ``shed`` are overload
    signals that the base controller ignores."""

    active: int = 0
    queue_depth: int = 0
    free_slots: int = 0
    min_margin: Optional[float] = None  # top-2 logit margin, least confident slot
    steps: int = 1                      # engine steps this observation covers
    deadline_misses: int = 0
    shed: int = 0


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    margin_demote: float = 6.0      # min margin above which approx is safe
    margin_promote: float = 1.5     # min margin below which accuracy is wanted
    cycle_budget: Optional[float] = None  # target mean relative cycles (0, 1]
    hysteresis: int = 2             # consecutive same-direction votes per move
    ema: float = 0.9                # smoothing of the relative-cycle estimate
    pin: Optional[str] = None       # fix the controller to one point (no adaptation)
    start: Optional[str] = None     # initial point (default: the reference)


class ModeController:
    """Feedback loop selecting the bank execution point for each decode step."""

    def __init__(self, bank: MultiPointBank, config: Optional[ControllerConfig] = None):
        self.bank = bank
        self.cfg = config or ControllerConfig()
        for name in (self.cfg.pin, self.cfg.start):
            if name is not None and name not in bank.names:
                raise ValueError(f"unknown execution point {name!r}; bank has {bank.names}")
        if self.cfg.cycle_budget is not None and not 0.0 < self.cfg.cycle_budget:
            raise ValueError("cycle_budget must be positive")
        # optional switch listener ``(old_point, new_point, signals)``; kept
        # across reset(). Nothing in the port subscribes yet (observability)
        self.on_switch = None
        self.reset()

    def reset(self) -> None:
        """Return to the configured initial point with no accumulated state
        (``BatchedServer.run`` calls this on entry)."""
        initial = self.cfg.pin or self.cfg.start or self.bank.reference
        self._idx = self.bank.index(initial)
        self._streak = 0
        self.switches = 0
        self._rel_ema = self.bank.rel_cycles(initial)

    @property
    def point(self) -> str:
        """The execution point the NEXT step will run at."""
        return self.bank.points[self._idx].name

    def tree(self):
        """The prepared weight tree for the current point (no copy)."""
        return self.bank.tree(self.point)

    @property
    def rel_cycles_ema(self) -> float:
        return self._rel_ema

    def observe(self, signals: StepSignals) -> str:
        """Account for the step or burst just executed and pick the next
        point. An observation of ``signals.steps`` engine steps moves the
        relative-cycle EMA as far as that many single-step observations at
        the same point would."""
        cfg = self.cfg
        alpha = cfg.ema ** max(signals.steps, 1)
        self._rel_ema = alpha * self._rel_ema + (1.0 - alpha) * self.bank.rel_cycles(
            self.point
        )
        if cfg.pin is not None:
            return self.point

        over_budget = cfg.cycle_budget is not None and self._rel_ema > cfg.cycle_budget
        pressure = signals.queue_depth > 0 and signals.free_slots == 0
        margin = signals.min_margin
        if margin is not None and not math.isfinite(margin):
            margin = None
        confident = margin is not None and margin >= cfg.margin_demote
        uncertain = margin is not None and margin < cfg.margin_promote

        if uncertain and not over_budget and not pressure:
            want = +1
        elif over_budget or pressure or confident:
            want = -1
        else:
            want = 0

        if want == 0:
            self._streak = 0
            return self.point
        self._streak = want if self._streak * want <= 0 else self._streak + want
        if abs(self._streak) >= cfg.hysteresis:
            new_idx = min(max(self._idx + (1 if want > 0 else -1), 0),
                          len(self.bank.points) - 1)
            if new_idx != self._idx:
                old = self.point
                self._idx = new_idx
                self.switches += 1
                if self.on_switch is not None:
                    self.on_switch(old, self.point, signals)
            self._streak = 0
        return self.point
