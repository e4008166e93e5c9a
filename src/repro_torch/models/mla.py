"""Multi-head Latent Attention (port of ``repro.models.mla``; DeepSeek-V3,
arXiv:2412.19437 §2.1).

Queries go through a low-rank down/up projection (``q_lora_rank``); keys and
values through a compressed latent ``c_kv`` (``kv_lora_rank``) plus a
decoupled RoPE key of ``qk_rope_head_dim`` shared across heads. The decode
cache stores only ``(c_kv, k_rope)``. Attention runs in the absorbed form:
``q_nope`` is mapped into latent space once (``q_lat = q_nope · wk_b``), the
scores contract over the latent rank, and the latent output is up-projected
by ``wv_b``. ``wk_b`` and ``wv_b`` are plain f32 einsums, not engine dots, as
in the reference. The cache rows are written in place. The cache path runs
the MLA cache-decode kernel (``attn_impl="decode_kernel"``) or the plain
chain; the cache-free path (``forward``) the MLA flash kernel (``"flash"``)
or the reference's query-chunked chain (``"xla"``).

Under tensor parallelism a rank holds its q heads (``wq_b``, ``wk_b``,
``wv_b`` and ``wo`` over heads) and the whole latent: the absorption and the
attention run on the local heads (the decode kernel plans its key splits
from the global head count) and ``wo`` is a row-parallel product.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import EngineContext
from repro_torch.core.normalization import rmsnorm
from repro_torch.kernels.decode_attention import mla_decode_attention, mla_decode_attention_ref
from repro_torch.kernels.mla_flash import mla_flash_attention

from .blocks import Q_CHUNK, batch_grouped, cache_row_write, rope, rows_einsum
from .params import ParamSpec


def mla_specs(cfg: ModelConfig):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": ParamSpec((d, m.q_lora_rank), ("embed", "q_lora")),
        "q_a_norm": ParamSpec((m.q_lora_rank,), ("q_lora",), "ones"),
        "wq_b": ParamSpec((m.q_lora_rank, h, qk_head), ("q_lora", "heads", "head_dim")),
        "wkv_a": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", "kv_lora")),
        "kv_a_norm": ParamSpec((m.kv_lora_rank,), ("kv_lora",), "ones"),
        "wk_b": ParamSpec((m.kv_lora_rank, h, m.qk_nope_head_dim),
                          ("kv_lora", "heads", "head_dim")),
        "wv_b": ParamSpec((m.kv_lora_rank, h, m.v_head_dim), ("kv_lora", "heads", "head_dim")),
        "wo": ParamSpec((h, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


def _q_proj(p, x, cfg, ctx, name):
    m = cfg.mla
    q_lat = ctx.linear(x, p["wq_a"], name=f"{name}.q_a")
    q_lat = rmsnorm(q_lat, p["q_a_norm"])
    q = ctx.linear(q_lat, p["wq_b"].reshape(m.q_lora_rank, -1), name=f"{name}.q_b")
    return q.reshape(*x.shape[:-1], -1, m.qk_nope_head_dim + m.qk_rope_head_dim)


def _kv_latent(p, x, cfg, ctx, name):
    m = cfg.mla
    kv_a = ctx.linear(x, p["wkv_a"], name=f"{name}.kv_a")
    c_kv, k_rope = kv_a[..., : m.kv_lora_rank], kv_a[..., m.kv_lora_rank:]
    return rmsnorm(c_kv, p["kv_a_norm"]), k_rope


def _chunked_block(q_lat, q_rope, c_kv, k_rope, positions, scale):
    """The reference's cache-free XLA branch: ``_block`` over ``Q_CHUNK``
    query chunks when S is past and divides into them, else one block. A
    block is the plain absorbed chain with every key at or before its
    query's position visible (``positions`` (S,) from ``forward``)."""
    b, s = q_lat.shape[:2]
    pos = positions.to(torch.int32).expand(b, s)
    n = s // Q_CHUNK if s > Q_CHUNK and s % Q_CHUNK == 0 else 1
    c = s // n
    return torch.cat([
        mla_decode_attention_ref(q_lat[:, i * c:(i + 1) * c], q_rope[:, i * c:(i + 1) * c],
                                 c_kv, k_rope, pos[:, i * c:(i + 1) * c], scale=scale)
        for i in range(n)], dim=1)


def _head_einsum(eq: str, x, w):
    """The absorption ``rows_einsum(eq, x, w)`` over x (B, S, H, .) and w
    (R, H, .), its heads in groups on CUDA (``blocks.batch_grouped``)."""
    return batch_grouped(lambda a, b: rows_einsum(eq, a, b), x, w, 2, 1, 2)


def mla_attention(p, x, cfg: ModelConfig, ctx: EngineContext, *, positions, name, cache=None):
    """Returns (out, new_cache); ``cache`` = dict(c_kv, k_rope, index) of one
    layer. The latent rows are written in place; the new index is returned.
    Without a cache (``forward``: ``positions`` is ``arange(S)``, so the
    flash kernel's index mask is the positions' mask) the new cache is None."""
    m = cfg.mla
    b, s, _ = x.shape
    h = p["wo"].shape[0]  # this rank's heads
    nope, rdim, vdim = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    q = _q_proj(p, x, cfg, ctx, name)  # (B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    c_kv, k_rope = _kv_latent(p, x, cfg, ctx, name)  # (B, S, R), (B, S, rdim)
    k_rope = rope(k_rope[..., None, :], positions, cfg.rope_theta)[..., 0, :]

    q_lat = _head_einsum("bshn,rhn->bshr", q_nope.to(torch.float32),
                         p["wk_b"].to(torch.float32))
    q_rope = q_rope.to(torch.float32)
    scale = 1.0 / math.sqrt(nope + rdim)
    if cache is None:
        new_cache = None
        c_kv, k_rope = c_kv.to(torch.float32), k_rope.to(torch.float32)
        if ctx.attn_impl == "flash":
            o_lat = mla_flash_attention(q_lat, q_rope, c_kv, k_rope, scale=scale)
        else:
            o_lat = _chunked_block(q_lat, q_rope, c_kv, k_rope, positions, scale)
    else:
        idx = cache["index"]
        c_kv = cache_row_write(cache["c_kv"], c_kv, idx)
        k_rope = cache_row_write(cache["k_rope"], k_rope, idx)
        new_cache = {"c_kv": c_kv, "k_rope": k_rope, "index": idx + s}
        attend = mla_decode_attention if ctx.attn_impl == "decode_kernel" else \
            mla_decode_attention_ref
        plan = {"plan_dims": ctx.attention_plan(b, cfg.num_heads)} \
            if ctx.attn_impl == "decode_kernel" else {}
        o_lat = attend(q_lat, q_rope, c_kv, k_rope, positions, scale=scale, **plan)

    out = _head_einsum("bshr,rhv->bshv", o_lat, p["wv_b"].to(torch.float32)).to(x.dtype)
    wo = p["wo"].reshape(h * vdim, cfg.d_model)
    return ctx.linear(out.reshape(b, s, h * vdim), wo, name=f"{name}.o",
                      k_sharded=ctx.model_split(cfg.num_heads) > 1), new_cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
                   device=None):
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
