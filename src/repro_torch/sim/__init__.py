"""Trace-driven cycle model of the paper's CARMEN PE array (port of
``repro.sim``).

* :mod:`repro_torch.sim.array`: the array model (PEs, per-MAC latency over
  depth and format, AF-block contention, weight stream, mode switches).
  Pure cycle arithmetic, the reference's own copy.
* :mod:`repro_torch.sim.replay`: replays a ``carmen-serve-trace`` JSONL
  (either package's) onto the array, with per-phase, per-point, per-layer
  and per-request attribution. CLI: ``python -m repro_torch.sim.replay
  trace.jsonl``.
* :mod:`repro_torch.sim.analyze`: the report layer (JSON and table) and the
  savings-drift and ordering checks.
* :mod:`repro_torch.sim.calibrate`: measures the reference's protocol on
  the card (each function one CUDA-graph replay) and fits the model's
  constants into the reference's calibration JSON.
"""
from .array import ArrayConfig, CostBreakdown, dot_pass_cost
from .calibrate import (CALIBRATION_SCHEMA, CALIBRATION_VERSION, fit_calibration,
                        load_calibration, run_calibration, save_calibration)
from .replay import ReplayResult, replay_trace

__all__ = [
    "ArrayConfig",
    "CALIBRATION_SCHEMA",
    "CALIBRATION_VERSION",
    "CostBreakdown",
    "ReplayResult",
    "dot_pass_cost",
    "fit_calibration",
    "load_calibration",
    "replay_trace",
    "run_calibration",
    "save_calibration",
]
