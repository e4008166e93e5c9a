"""Cache-free flash attention (GQA): Hopper kernel and plain version."""
from .ops import TOLERANCE, flash_attention
from .ref import flash_attention_ref

__all__ = ["TOLERANCE", "flash_attention", "flash_attention_ref"]
