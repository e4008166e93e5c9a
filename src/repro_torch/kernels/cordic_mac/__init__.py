"""CARMEN's MAC array as a blocked integer matmul: Hopper kernel and plain version."""
from .ops import (cordic_mac, mac_matmul, mac_matmul_scaled_grad, quantize_activations,
                  quantize_weights)
from .ref import mac_matmul_ref

__all__ = [
    "cordic_mac",
    "mac_matmul",
    "mac_matmul_ref",
    "mac_matmul_scaled_grad",
    "quantize_activations",
    "quantize_weights",
]
