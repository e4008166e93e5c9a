"""Cycle model of the CARMEN PE array (paper §II, Tables 2/3/5); the port's
own copy of ``repro.sim.array``, pure cycle arithmetic.

The array is ``n_pes`` weight-stationary iterative CORDIC PEs, each mapped
to one output channel of the current dot, plus a time-multiplexed AF block
and a weight-stream port. All costs are in PE clock cycles; wall-clock is
``cycles * sec_per_cycle`` once calibrated.

Per-MAC latency: one CORDIC iteration is one cycle, so a K-length dot at
depth d costs ``K * (mac_overhead + d + 1)`` cycles on one PE —
``mac_overhead=0`` recovers the analytic :func:`repro_torch.core.mac.mac_cycles`
model exactly (test-asserted), and a calibration fit can add fractional
pipeline overhead per MAC.

A full dot pass (K, N) for P positions schedules in output-channel *waves*
of ``n_pes`` lanes. Per wave, three resources can bound the cycle count:

* **compute** — ``K * (mac_overhead + depth + 1) * positions`` per lane
  (lanes run in parallel; a partial last wave still pays full compute time).
* **weight stream** — a wave's lanes need ``K * lanes * bits`` weight bits;
  at ``weight_bits_per_cycle`` port bandwidth the wave cannot finish faster
  than the stream. FXP16 points stream twice the bits of FXP8 — the format
  half of the paper's precision/throughput trade.
* **AF block** — ``n * positions`` outputs share ``af_blocks`` AF units at
  ``af_iter_cycles * (depth + 1)`` each (the AF block is CORDIC-iterative
  too, so its cost rides the same depth ladder as the MACs — which is what
  keeps per-point cost *ratios*, and hence savings fractions, faithful under
  calibration). AF work hides under the MAC shadow of the whole pass; only
  the excess stalls.

``parallel_overhead_exp`` models imperfect lane scaling (Table 5's measured
time exponent): total cycles scale by ``n_pes ** exp``, so a 64- vs 256-PE
simulation reproduces the measured exponent by construction (0 = ideal).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

__all__ = ["ArrayConfig", "CostBreakdown", "dot_pass_cost"]


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """One simulated CARMEN array. Defaults are the paper's ideal 256-PE
    array with analytic constants; :meth:`from_calibration` loads fitted
    ones."""

    n_pes: int = 256
    # -- MAC stage ----------------------------------------------------------
    # extra cycles per MAC beyond the depth+1 CORDIC pipeline (fitted;
    # 0 = the analytic model)
    mac_overhead: float = 0.0
    # -- AF block -----------------------------------------------------------
    af_blocks: int = 32  # AF units time-multiplexed over the PE columns
    # the AF block is CORDIC-iterative like the PEs: one evaluation costs
    # af_iter_cycles * (depth + 1). Fitted as cycles-per-AF-iteration so AF
    # cost stays proportional to depth (what keeps per-point cost ratios —
    # and therefore savings fractions — faithful to the depth ladder).
    af_iter_cycles: float = 1.0
    # fixed override: cycles one AF evaluation takes regardless of depth
    # (diagnostic / stress configs; None = the iterative model above)
    af_cycles_per_elem: Optional[float] = None
    # -- weight stream ------------------------------------------------------
    # port bandwidth; default streams one 8-bit weight per PE per cycle, so
    # the stream never stalls FXP8 compute on the ideal array
    weight_bits_per_cycle: Optional[float] = None
    # -- scaling / host -----------------------------------------------------
    # measured parallel-efficiency exponent: cycles *= n_pes ** exp
    parallel_overhead_exp: float = 0.0
    # cycles the array sits idle per host round-trip (dispatch + transfer) —
    # what makes burst=1 serving predictably slower than burst=8
    host_sync_cycles: float = 0.0
    # configuration-register write + pipeline drain on a mode switch
    switch_cycles: float = 256.0
    # wall-clock anchor (seconds per cycle), set by calibration
    sec_per_cycle: Optional[float] = None

    def __post_init__(self):
        if self.n_pes <= 0:
            raise ValueError("n_pes must be positive")
        if self.af_blocks <= 0:
            raise ValueError("af_blocks must be positive")

    @property
    def bandwidth(self) -> float:
        if self.weight_bits_per_cycle is not None:
            return self.weight_bits_per_cycle
        return 8.0 * self.n_pes

    def scaled(self, **overrides) -> "ArrayConfig":
        """A copy with fields replaced (e.g. the 64-PE Table 5 variant)."""
        return dataclasses.replace(self, **overrides)

    @classmethod
    def from_calibration(cls, calibration: Optional[Dict], *,
                         n_pes: int = 256, **overrides) -> "ArrayConfig":
        """Build an array from a ``sim.calibrate`` export of either package
        (``None`` = the ideal analytic array)."""
        if calibration is None:
            return cls(n_pes=n_pes, **overrides)
        c = calibration.get("constants", {})
        fields = dict(
            n_pes=n_pes,
            mac_overhead=float(c.get("mac_overhead", 0.0)),
            af_iter_cycles=float(c.get("af_iter_cycles", 1.0)),
            parallel_overhead_exp=float(c.get("parallel_overhead_exp", 0.0)),
            host_sync_cycles=float(c.get("host_sync_cycles", 0.0)),
            sec_per_cycle=c.get("sec_per_cycle"),
        )
        fields.update(overrides)
        return cls(**fields)


@dataclasses.dataclass
class CostBreakdown:
    """Cycle attribution of one scheduled unit of work. ``total`` is the
    bound resource's time; ``weight_stall`` / ``af_stall`` are the cycles by
    which the stream / AF block exceeded the MAC shadow (already included in
    ``total``). ``ideal_macs`` counts MAC iterations (the numerator of PE
    occupancy)."""

    total: float = 0.0
    compute: float = 0.0
    weight_stall: float = 0.0
    af_stall: float = 0.0
    ideal_macs: float = 0.0

    def __add__(self, other: "CostBreakdown") -> "CostBreakdown":
        return CostBreakdown(
            self.total + other.total,
            self.compute + other.compute,
            self.weight_stall + other.weight_stall,
            self.af_stall + other.af_stall,
            self.ideal_macs + other.ideal_macs,
        )

    def scale(self, k: float) -> "CostBreakdown":
        return CostBreakdown(self.total * k, self.compute * k,
                             self.weight_stall * k, self.af_stall * k,
                             self.ideal_macs * k)


def dot_pass_cost(cfg: ArrayConfig, k: int, n: int, depth: int, *,
                  positions: int = 1, bits: int = 8,
                  reps: int = 1) -> CostBreakdown:
    """Cycles to push ``positions`` activation rows through a (K, N) dot at
    ``depth`` on ``cfg``, repeated ``reps`` times (stacked/scanned layers).

    On the ideal config with one PE and one lane this is exactly
    ``mac_cycles(k, depth) * positions`` — the analytic model the rest of
    the repo charges; everything else (waves, stalls, overheads) refines it.
    """
    if k <= 0 or n <= 0 or positions <= 0:
        return CostBreakdown()
    per_mac = cfg.mac_overhead + depth + 1
    full, rem = divmod(n, cfg.n_pes)
    compute = weight_stall = total = 0.0
    for lanes, waves in ((cfg.n_pes, full), (rem, 1 if rem else 0)):
        if waves == 0:
            continue
        wave_compute = k * per_mac * positions
        wave_stream = k * lanes * bits / cfg.bandwidth
        compute += wave_compute * waves
        weight_stall += max(0.0, wave_stream - wave_compute) * waves
        total += max(wave_compute, wave_stream) * waves
    # AF: n*positions outputs share af_blocks units; excess over the pass's
    # MAC shadow stalls the array
    af_c = cfg.af_cycles_per_elem if cfg.af_cycles_per_elem is not None \
        else cfg.af_iter_cycles * (depth + 1)
    af_serial = math.ceil(n * positions / cfg.af_blocks) * af_c
    af_stall = max(0.0, af_serial - compute)
    total += af_stall
    penalty = cfg.n_pes ** cfg.parallel_overhead_exp
    return CostBreakdown(
        total=total * penalty * reps,
        compute=compute * penalty * reps,
        weight_stall=weight_stall * penalty * reps,
        af_stall=af_stall * penalty * reps,
        ideal_macs=float(k) * n * positions * (depth + 1) * reps,
    )
