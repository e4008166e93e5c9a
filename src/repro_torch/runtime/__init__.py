"""Serving-side runtime (port of ``repro.runtime``): the startup calibration scan."""
from .calibrate import calibration_scan

__all__ = ["calibration_scan"]
