"""Runtime-adaptive precision (port of ``repro.runtime``): execution mode as a
per-burst serving decision.

* :mod:`.bank`: multi-point weight banks, every execution point prepared in
  one pass through a shared memo;
* :mod:`.controller`: the mode controller (margin, queue pressure, cycle
  budget, hysteresis);
* :mod:`.telemetry`: mode occupancy, estimated MAC cycles (the paper's
  K*(depth+1) iterative-PE model) and switch counts;
* :mod:`.calibrate`: the startup sensitivity scan.
"""
from .bank import ExecutionPoint, MultiPointBank, build_bank, default_points, place_bank
from .calibrate import calibration_scan
from .controller import ControllerConfig, ModeController, StepSignals
from .telemetry import TelemetryRecorder, estimate_point_cycles, teacher_forced_agreement

__all__ = [
    "ExecutionPoint",
    "MultiPointBank",
    "build_bank",
    "default_points",
    "place_bank",
    "calibration_scan",
    "ControllerConfig",
    "ModeController",
    "StepSignals",
    "TelemetryRecorder",
    "estimate_point_cycles",
    "teacher_forced_agreement",
]
