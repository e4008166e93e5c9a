"""Cache-decode attention (GQA and absorbed MLA): Hopper kernels and plain versions."""
from .ops import TOLERANCE, gqa_decode_attention, mla_decode_attention
from .ref import gqa_decode_attention_ref, mla_decode_attention_ref

__all__ = [
    "TOLERANCE",
    "gqa_decode_attention",
    "gqa_decode_attention_ref",
    "mla_decode_attention",
    "mla_decode_attention_ref",
]
