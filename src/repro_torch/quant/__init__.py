"""Scaled-integer quantization (port of ``repro.quant``)."""
from .qat import (
    QuantizedLinear,
    calibrate_activation_scales,
    dequantize_params,
    fake_quant,
    quantize_params_int8,
)

__all__ = [
    "QuantizedLinear",
    "calibrate_activation_scales",
    "dequantize_params",
    "fake_quant",
    "quantize_params_int8",
]
