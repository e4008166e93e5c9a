"""The loader of a PE-array calibration export (the part of
``repro.sim.calibrate`` that serving reads).

A calibration is a JSON file that the reference's ``repro.sim.calibrate``
writes: fitted constants of the cycle model (``mac_overhead`` among them)
under ``constants`` and an ``id``. ``launch/serve.py --calibration`` loads one
and ``runtime.build_bank(calibration=...)`` prices the bank's points with it.
The measurement and the fit are not ported yet.
"""
from __future__ import annotations

import json
from typing import Dict

CALIBRATION_SCHEMA = "carmen-sim-calibration"
CALIBRATION_VERSION = 1

__all__ = ["CALIBRATION_SCHEMA", "CALIBRATION_VERSION", "load_calibration"]


def load_calibration(path: str) -> Dict:
    """Read a calibration export; raises ``ValueError`` for another schema or
    a version newer than this reader."""
    with open(path) as f:
        calibration = json.load(f)
    if calibration.get("schema") != CALIBRATION_SCHEMA:
        raise ValueError(
            f"{path}: not a {CALIBRATION_SCHEMA} export "
            f"(schema={calibration.get('schema')!r})")
    if calibration.get("version", 0) > CALIBRATION_VERSION:
        raise ValueError(
            f"{path}: calibration version {calibration['version']} is newer "
            f"than this reader ({CALIBRATION_VERSION})")
    return calibration
