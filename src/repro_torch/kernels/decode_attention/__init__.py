"""GQA cache-decode attention: Hopper kernel and plain version."""
from .ops import TOLERANCE, gqa_decode_attention
from .ref import gqa_decode_attention_ref

__all__ = ["TOLERANCE", "gqa_decode_attention", "gqa_decode_attention_ref"]
