"""Transformer building blocks (port of ``repro.models.blocks``): RoPE, norms,
GQA attention on the KV-cache path, and the gated MLP.

Every matmul goes through ``EngineContext``. The cache path writes the KV
cache in place (the reference returns a new one); the attention itself is
the GQA cache-decode kernel (``attn_impl="decode_kernel"``) or the plain
chain (``"xla"``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import EngineContext
from repro_torch.core.normalization import layernorm, nonparametric_ln, rmsnorm
from repro_torch.kernels.decode_attention import gqa_decode_attention, gqa_decode_attention_ref

from .params import ParamSpec


def norm_spec(cfg: ModelConfig, dim: Optional[int] = None):
    d = dim or cfg.d_model
    if cfg.norm_type == "nonparametric":
        return {}
    if cfg.norm_type == "layernorm":
        return {
            "scale": ParamSpec((d,), ("embed",), "ones"),
            "bias": ParamSpec((d,), ("embed",), "zeros"),
        }
    return {"scale": ParamSpec((d,), ("embed",), "ones")}


def apply_norm(p, x, cfg: ModelConfig):
    if cfg.norm_type == "nonparametric":
        return nonparametric_ln(x)
    if cfg.norm_type == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S). Rotates pairs (D/2)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def attention_specs(cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), "zeros")
        specs["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), "zeros")
        specs["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
        specs["k_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
    return specs


def _proj(ctx, x, w, b, name):
    """(B,S,D) x (D,H,hd) -> (B,S,H,hd) through the engine (2D matmul form)."""
    d = w.shape[0]
    out = ctx.linear(x, w.reshape(d, -1), b.reshape(-1) if b is not None else None, name=name)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def cache_row_write(c: torch.Tensor, x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Write block ``x`` (B, S, ...) into rows [i, i+S) of cache ``c``
    (B, Smax, ...) in place; ``i`` (B,) int32. The start is clamped to
    [0, Smax - S] as ``dynamic_update_slice`` clamps it, so a slot whose
    index ran past ``max_len`` overwrites its last rows and never writes out
    of bounds."""
    s = x.shape[1]
    start = torch.clamp(i.to(torch.int64), 0, c.shape[1] - s)
    rows = start[:, None] + torch.arange(s, device=c.device)
    batch = torch.arange(c.shape[0], device=c.device)[:, None].expand_as(rows)
    c[batch, rows] = x.to(c.dtype)
    return c


def attention(p, x, cfg: ModelConfig, ctx: EngineContext, *, positions, name, cache=None):
    """Returns (out, new_cache); ``cache`` = dict(k, v, index) of one layer.
    The k/v rows are written in place; the new index is returned."""
    if cache is None:
        raise NotImplementedError("the cache-free (training/forward) attention path "
                                  "is not yet ported")
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = _proj(ctx, x, p["wq"], p.get("bq"), f"{name}.q")
    k = _proj(ctx, x, p["wk"], p.get("bk"), f"{name}.k")
    v = _proj(ctx, x, p["wv"], p.get("bv"), f"{name}.v")
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    idx = cache["index"]
    ck = cache_row_write(cache["k"], k, idx)
    cv = cache_row_write(cache["v"], v, idx)
    scale = 1.0 / math.sqrt(hd)
    if ctx.attn_impl == "decode_kernel":
        out = gqa_decode_attention(q, ck, cv, positions, scale=scale)
    else:
        out = gqa_decode_attention_ref(q, ck, cv, positions, scale=scale)
    new_cache = {"k": ck, "v": cv, "index": idx + s}

    out = out.reshape(b, s, cfg.num_heads * hd)
    wo = p["wo"].reshape(cfg.num_heads * hd, cfg.d_model)
    return ctx.linear(out, wo, name=f"{name}.o"), new_cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
                    device=None):
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_len, kvh, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kvh, hd), dtype=dtype, device=device),
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    specs = {
        "up": ParamSpec((d, f), ("embed", "mlp")),
        "down": ParamSpec((f, d), ("mlp", "embed")),
    }
    if cfg.glu:
        specs["gate"] = ParamSpec((d, f), ("embed", "mlp"))
    return specs


def mlp(p, x, cfg: ModelConfig, ctx: EngineContext, *, name):
    # linear_af fuses the dot and the activation epilogue into one kernel pass
    if cfg.glu:
        up = ctx.linear(x, p["up"], name=f"{name}.up")
        h = ctx.linear_af(x, p["gate"], af=cfg.act, name=f"{name}.gate") * up
    else:
        h = ctx.linear_af(x, p["up"], af=cfg.act, name=f"{name}.up")
    return ctx.linear(h, p["down"], name=f"{name}.down")
