"""CARMEN's MAC array as a blocked integer matmul: Hopper kernel and plain
version, and its split form for row-parallel products (partial int32 dot,
scale epilogue)."""
from .ops import (cordic_mac, mac_epilogue, mac_epilogue_scaled_grad, mac_matmul,
                  mac_matmul_partial, mac_matmul_scaled_grad, quantize_activations,
                  quantize_weights)
from .ref import mac_epilogue_ref, mac_matmul_partial_ref, mac_matmul_ref

__all__ = [
    "cordic_mac",
    "mac_epilogue",
    "mac_epilogue_ref",
    "mac_epilogue_scaled_grad",
    "mac_matmul",
    "mac_matmul_partial",
    "mac_matmul_partial_ref",
    "mac_matmul_ref",
    "mac_matmul_scaled_grad",
    "quantize_activations",
    "quantize_weights",
]
