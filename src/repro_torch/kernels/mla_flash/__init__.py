"""Cache-free MLA flash attention: Hopper kernel and plain version."""
from .ops import TOLERANCE, mla_flash_attention
from .ref import mla_flash_attention_ref

__all__ = ["TOLERANCE", "mla_flash_attention", "mla_flash_attention_ref"]
