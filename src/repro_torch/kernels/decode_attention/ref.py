"""Plain PyTorch versions of the cache-decode attentions.

GQA mirrors the reference's XLA cache chain (``repro/models/blocks.py``
attention with a cache): einsum, mask at -1e30, softmax, cast to the cache
dtype, einsum. K and V are repeated over the groups here, as the chain does
(each q head takes its kv head's rows, ``kv_rows``).
MLA mirrors ``repro/models/mla.py``'s ``_block`` in the absorbed form: the
two score einsums, scale, mask at -1e30, softmax, and P·c_kv, all in f32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def kv_rows(k, h: int, head_offset: int = 0, groups=None):
    """``k`` (..., KV, hd) with, for each of ``h`` q heads, the rows of the
    kv head it reads: (head_offset + i) // groups. By default (groups None:
    H % KV == 0) each kv head repeated H // KV times, as the chain does."""
    if groups is None:
        g = h // k.shape[-2]
        return torch.repeat_interleave(k, g, dim=-2) if g > 1 else k
    idx = torch.div(head_offset + torch.arange(h, device=k.device), groups,
                    rounding_mode="floor")
    return k.index_select(k.ndim - 2, idx)


def gqa_decode_attention_ref(q, ck, cv, positions, *, scale: float, head_offset: int = 0,
                             groups=None):
    """q (B, S, H, hd) against caches ck/cv (B, T, KV, hd); positions (B, S).
    q head i reads kv head (head_offset + i) // groups (by default H % KV
    == 0 and groups = H // KV). Returns (B, S, H, hd) in the cache dtype."""
    t = ck.shape[1]
    k_pos = torch.arange(t, device=q.device)
    valid = k_pos[None, None, :] <= positions[:, :, None].to(k_pos.dtype)  # (B, S, T)
    h = q.shape[2]
    ckr, cvr = kv_rows(ck, h, head_offset, groups), kv_rows(cv, h, head_offset, groups)
    scores = torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32), ckr.to(torch.float32))
    scores = torch.where(valid[:, None], scores * scale, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", probs.to(cvr.dtype), cvr)


def mla_decode_attention_ref(q_lat, q_rope, c_kv, k_rope, positions, *, scale: float):
    """q_lat (B, S, H, R), q_rope (B, S, H, r) against the latent cache
    c_kv (B, T, R) and k_rope (B, T, r); positions (B, S). Returns the latent
    output (B, S, H, R) in f32."""
    t = c_kv.shape[1]
    k_pos = torch.arange(t, device=q_lat.device)
    valid = k_pos[None, None, :] <= positions[:, :, None].to(k_pos.dtype)  # (B, S, T)
    c_kv_f, k_rope_f = c_kv.to(torch.float32), k_rope.to(torch.float32)
    scores = torch.einsum("bqhr,btr->bhqt", q_lat.to(torch.float32), c_kv_f)
    scores = scores + torch.einsum("bqhr,btr->bhqt", q_rope.to(torch.float32), k_rope_f)
    scores = torch.where(valid[:, None], scores * scale, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqt,btr->bqhr", probs, c_kv_f)
