"""Fused CORDIC dot + activation epilogue: Hopper kernel and plain version."""
from .ops import FUSED_AFS, POINT_LEN, fused_dot_af, plan
from .ref import af_epilogue, fused_dot_af_ref

__all__ = [
    "FUSED_AFS",
    "POINT_LEN",
    "af_epilogue",
    "fused_dot_af",
    "fused_dot_af_ref",
    "plan",
]
