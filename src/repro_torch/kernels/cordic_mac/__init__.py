"""CARMEN's MAC array as a blocked integer matmul: Hopper kernel and plain version."""
from .ops import cordic_mac, mac_matmul, quantize_activations, quantize_weights
from .ref import mac_matmul_ref

__all__ = [
    "cordic_mac",
    "mac_matmul",
    "mac_matmul_ref",
    "quantize_activations",
    "quantize_weights",
]
