"""Plain PyTorch version of the cache-free MLA flash attention.

Mirrors the reference's oracle ``repro/kernels/mla_flash/ref.py``
``mla_attention_ref`` behind its wrapper (``ops.py``), with the model's
quantities: ``q_cat = [q_lat, q_rope]`` against the shared latent
``k_cat = [c_kv, k_rope]``, the value ``c_kv``; f32 scores times ``scale``,
the causal mask at -1e30, softmax, P·c_kv in f32. The reference folds
``scale`` into q and divides by sqrt(R + r) (the same product); here it is
applied once.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mla_flash_attention_ref(q_lat, q_rope, c_kv, k_rope, *, scale: float, causal: bool = True):
    """q_lat (B, S, H, R), q_rope (B, S, H, r) against c_kv (B, T, R) and
    k_rope (B, T, r). Returns the latent output (B, S, H, R) in f32."""
    q_cat = torch.cat([q_lat, q_rope], dim=-1).to(torch.float32)
    k_cat = torch.cat([c_kv, k_rope], dim=-1).to(torch.float32)
    s = torch.einsum("bqhr,btr->bhqt", q_cat, k_cat) * scale
    if causal:
        sq, sk = q_cat.shape[1], k_cat.shape[1]
        mask = (torch.arange(sq, device=s.device)[:, None]
                >= torch.arange(sk, device=s.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqt,btr->bqhr", p, c_kv.to(torch.float32))
