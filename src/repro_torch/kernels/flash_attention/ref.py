"""Plain PyTorch version of the cache-free flash attention, in model layout.

Mirrors the reference's oracle ``repro/kernels/flash_attention/ref.py``
``attention_ref`` behind its wrapper's GQA repeat (``ops.py``): K and V
repeated over the groups, f32 scores divided by sqrt(D), the causal mask
(query index >= key index) at -1e30, softmax, P·V in f32, the output in q's
dtype.
"""
from __future__ import annotations

import math

import torch

from ..decode_attention.ref import kv_rows

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, head_offset: int = 0, groups=None):
    """q (B, Sq, H, D); k, v (B, Sk, KV, D); q head i reads kv head
    (head_offset + i) // groups (by default H % KV == 0 and groups =
    H // KV). Returns (B, Sq, H, D) in q's dtype."""
    sq, h, d = q.shape[1:]
    sk = k.shape[1]
    kr, vr = kv_rows(k, h, head_offset, groups), kv_rows(v, h, head_offset, groups)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kr.to(torch.float32))
    s = s / math.sqrt(d)
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr.to(torch.float32)).to(q.dtype)
