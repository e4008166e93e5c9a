"""PE-array simulator (port of ``repro.sim``): only the calibration loader so far."""
from .calibrate import CALIBRATION_SCHEMA, CALIBRATION_VERSION, load_calibration

__all__ = ["CALIBRATION_SCHEMA", "CALIBRATION_VERSION", "load_calibration"]
