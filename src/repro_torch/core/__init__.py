"""CARMEN core (PyTorch port): fixed-point formats, CORDIC, multi-AF block,
precision policy, engine."""
from .fxp import FXP8, FXP8_UNIT, FXP16, FXP16_UNIT, FxPFormat, dequantize, quantize
from .cordic import (
    approx_depth,
    cordic_div,
    cordic_exp,
    cordic_mul,
    full_depth,
    signed_digit_round,
)
from .activations import AF_INDEX, AF_NAMES, af_ref, cordic_softmax, multi_af, multi_af_float
from .mac import carmen_matmul_fast, cordic_dot, cordic_matmul, mac_cycles
from .engine import EngineContext, PreparedWeight, prepare_params
from .precision_policy import (
    CRITICAL_KEYWORDS,
    LayerPrecision,
    PrecisionPolicy,
    assign_depths,
    pin_critical,
    sensitivity_scan,
)
from .normalization import layernorm, nonparametric_ln, rmsnorm

__all__ = [
    "FXP8", "FXP8_UNIT", "FXP16", "FXP16_UNIT", "FxPFormat", "dequantize", "quantize",
    "approx_depth", "cordic_div", "cordic_exp", "cordic_mul", "full_depth",
    "signed_digit_round",
    "AF_INDEX", "AF_NAMES", "af_ref", "cordic_softmax", "multi_af", "multi_af_float",
    "carmen_matmul_fast", "cordic_dot", "cordic_matmul", "mac_cycles",
    "EngineContext", "PreparedWeight", "prepare_params",
    "CRITICAL_KEYWORDS", "LayerPrecision", "PrecisionPolicy", "assign_depths", "pin_critical",
    "sensitivity_scan", "layernorm", "nonparametric_ln", "rmsnorm",
]
