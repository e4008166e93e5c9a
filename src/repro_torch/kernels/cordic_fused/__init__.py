"""Fused CORDIC dot + activation epilogue: Hopper kernel and plain version,
and its split form for row-parallel products (partial int32 dot, epilogue)."""
from .ops import (FUSED_AFS, POINT_LEN, fused_dot_af, fused_dot_partial, fused_epilogue,
                  plan)
from .ref import af_epilogue, fused_dot_af_ref, fused_dot_partial_ref, fused_epilogue_ref

__all__ = [
    "FUSED_AFS",
    "POINT_LEN",
    "af_epilogue",
    "fused_dot_af",
    "fused_dot_af_ref",
    "fused_dot_partial",
    "fused_dot_partial_ref",
    "fused_epilogue",
    "fused_epilogue_ref",
    "plan",
]
