"""Plain PyTorch versions of the cache-decode attentions.

GQA mirrors the reference's XLA cache chain (``repro/models/blocks.py``
attention with a cache): einsum, mask at -1e30, softmax, cast to the cache
dtype, einsum. K and V are repeated over the groups here, as the chain does.
MLA mirrors ``repro/models/mla.py``'s ``_block`` in the absorbed form: the
two score einsums, scale, mask at -1e30, softmax, and P·c_kv, all in f32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def gqa_decode_attention_ref(q, ck, cv, positions, *, scale: float):
    """q (B, S, H, hd) against caches ck/cv (B, T, KV, hd); positions (B, S).
    Returns (B, S, H, hd) in the cache dtype."""
    g = q.shape[2] // ck.shape[2]
    t = ck.shape[1]
    k_pos = torch.arange(t, device=q.device)
    valid = k_pos[None, None, :] <= positions[:, :, None].to(k_pos.dtype)  # (B, S, T)
    ckr = torch.repeat_interleave(ck, g, dim=2) if g > 1 else ck
    cvr = torch.repeat_interleave(cv, g, dim=2) if g > 1 else cv
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
