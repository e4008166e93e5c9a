"""Transformer building blocks (port of ``repro.models.blocks``): RoPE, norms,
GQA attention, the gated MLP and the token-choice MoE.

Every projection goes through ``EngineContext``. The cache path writes the KV
cache in place (the reference returns a new one); the attention itself is
the GQA cache-decode kernel (``attn_impl="decode_kernel"``) or the plain
chain (``"xla"``). The cache-free path (``forward``) runs the flash kernel
(``"flash"``) or the reference's query-chunked chain (``"xla"``). The MoE's
router and expert products are plain f32 einsums, as in the reference; its
gate activation is the engine's standalone multi-AF block.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import EngineContext
from repro_torch.core.normalization import layernorm, nonparametric_ln, rmsnorm
from repro_torch.kernels.decode_attention import gqa_decode_attention, gqa_decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention

from .params import ParamSpec

Q_CHUNK = 1024  # query block of the cache-free XLA chain
NEG_INF = -1e30


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


def _sdpa_chunked(q, k, v, q_positions, k_positions, causal: bool):
    """The reference's cache-free XLA chain. q (B, Sq, H, hd); k, v
    (B, Sk, H, hd), KV repeated to H. Queries run in ``Q_CHUNK`` blocks when
    Sq divides into them (else one block): f32 scores, the causal mask on
    positions at -1e30, softmax, P cast to v's dtype, P·V."""
    sq, hd = q.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    n_chunks = max(1, sq // Q_CHUNK) if sq % Q_CHUNK == 0 else 1
    qc = sq // n_chunks
    outs = []
    for c in range(n_chunks):
        q_i, qp_i = q[:, c * qc:(c + 1) * qc], q_positions[c * qc:(c + 1) * qc]
        scores = torch.einsum("bqhd,bshd->bhqs", q_i.to(torch.float32), k.to(torch.float32))
        scores = scores * scale
        if causal:
            mask = qp_i[:, None] >= k_positions[None, :]
            scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype), v))
    return torch.cat(outs, dim=1)


def attention(p, x, cfg: ModelConfig, ctx: EngineContext, *, positions, name, cache=None,
              causal: bool = True):
    """Returns (out, new_cache); ``cache`` = dict(k, v, index) of one layer.
    The k/v rows are written in place; the new index is returned. Without a
    cache (``forward``: ``positions`` is ``arange(S)``, so the flash kernel's
    index mask is the positions' mask) the new cache is None."""
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

    if cache is None:
        if ctx.attn_impl == "flash":
            # the kernel resolves kv head = h // groups itself: K/V unrepeated
            out = flash_attention(q, k, v, causal=causal)
        else:
            g = cfg.kv_groups
            kr = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
            vr = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
            out = _sdpa_chunked(q, kr, vr, positions, positions, causal)
        new_cache = None
    else:
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


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, capacity-based, sort/gather dispatch)
# ---------------------------------------------------------------------------


def moe_specs(cfg: ModelConfig):
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    specs = {
        "router": ParamSpec((d, e), ("embed", "experts"), scale=0.02),
        "up": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "gate": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "down": ParamSpec((e, f, d), ("experts", "mlp", "embed")),
    }
    if m.num_shared_experts:
        fs = m.d_ff_shared * m.num_shared_experts
        specs["shared"] = {
            "up": ParamSpec((d, fs), ("embed", "mlp")),
            "gate": ParamSpec((d, fs), ("embed", "mlp")),
            "down": ParamSpec((fs, d), ("mlp", "embed")),
        }
    return specs


def top_k_stable(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis and their indices, ties
    to the lower index, as ``lax.top_k`` breaks them (``torch.topk`` promises
    no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_indices(expert_idx: torch.Tensor, num_experts: int, capacity: int):
    """Per-row sort/gather dispatch plan.

    ``expert_idx``: (B, S, K) chosen experts of S tokens in each of B rows.
    Returns int32 ``gather_idx`` (B, E, C) into each row's S*K flat choices,
    bool ``valid`` (B, E, C) and int32 ``rank`` (B, S, K), each choice's
    position in its expert's queue; row by row, bitwise the reference's plan
    (stable sort, a running max for ``associative_scan(max)``).
    """
    b, s, k = expert_idx.shape
    n, dev = s * k, expert_idx.device
    flat = expert_idx.reshape(b, n).to(torch.int64)
    order = torch.sort(flat, dim=1, stable=True).indices
    sorted_e = torch.gather(flat, 1, order)
    pos = torch.arange(n, device=dev).expand(b, n)
    is_start = torch.ones((b, n), dtype=torch.bool, device=dev)
    is_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, pos, -1), dim=1).values
    rank = torch.empty_like(order).scatter_(1, order, pos - seg_start)
    counts = torch.zeros((b, num_experts), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=1) - counts
    slot = torch.arange(capacity, device=dev)
    gather_pos = starts[:, :, None] + slot  # (B, E, C) index into the sorted order
    valid = slot < torch.clamp(counts, max=capacity)[:, :, None]
    gather_idx = torch.gather(order, 1, gather_pos.clamp(0, n - 1).reshape(b, -1))
    return (gather_idx.reshape(b, num_experts, capacity).to(torch.int32), valid,
            rank.reshape(b, s, k).to(torch.int32))


def _combine(y, top_i, rank, kept, capacity: int):
    """Each token's weighted sum of its kept expert-slot outputs.

    The reference scatter-adds the (E, C) slot outputs into a zero (B, S, D)
    buffer; a token's slots are visited in ascending expert order. Here each
    token gathers its K slots and sums them from zero in that same order, so
    the sums are the same and, unlike a scatter-add through atomics,
    deterministic on the card.
    """
    b, e, c, d = y.shape
    s, k = top_i.shape[1:]
    by_expert = torch.argsort(top_i, dim=-1)  # a token's K experts are distinct
    e_k = torch.gather(top_i, -1, by_expert).to(torch.int64)
    r_k = torch.gather(rank, -1, by_expert).to(torch.int64)
    w_k = torch.gather(kept, -1, by_expert)
    keep = r_k < capacity
    slot = e_k * capacity + torch.clamp(r_k, max=capacity - 1)
    g = torch.gather(y.reshape(b, e * c, d), 1, slot.reshape(b, s * k, 1).expand(-1, -1, d))
    g = g.reshape(b, s, k, d) * w_k[..., None].to(y.dtype)
    out = torch.zeros((b, s, d), dtype=y.dtype, device=y.device)
    for j in range(k):
        out = torch.where(keep[..., j, None], out + g[:, :, j], out)
    return out


def moe_ffn(p, x, cfg: ModelConfig, ctx: EngineContext, *, name, dropless: bool = False):
    """Batched-per-row MoE, single device. ``dropless`` (the cached-decode
    path) widens short blocks' capacity so no routed token is dropped.
    Returns (out, aux) with aux's load-balancing loss (zero when dropless)."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    capacity = max(k, int(math.ceil(s * k / e * m.capacity_factor)))
    if dropless and s <= 64:
        # a token's top-k experts are distinct, so per-expert load is at most s
        capacity = max(capacity, s)

    router_logits = torch.einsum("bsd,de->bse", x.to(torch.float32),
                                 p["router"].to(torch.float32))
    probs = torch.softmax(router_logits, dim=-1)
    top_p, top_i = top_k_stable(probs, k)  # (B, S, K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    gather_idx, valid, rank = _dispatch_indices(top_i, e, capacity)
    token_of_choice = (gather_idx // k).to(torch.int64)  # (B, E, C) source token
    x_disp = torch.gather(x, 1, token_of_choice.reshape(b, e * capacity, 1).expand(-1, -1, d))
    x_disp = x_disp.reshape(b, e, capacity, d) * valid[..., None].to(x.dtype)

    cd = cfg.compute_dtype

    def expert_mm(hh, w):
        return torch.einsum("becd,edf->becf", hh.to(cd), w.to(cd))

    up = expert_mm(x_disp, p["up"])
    gate = expert_mm(x_disp, p["gate"])
    hidden = ctx.activate(gate, cfg.act) * up
    y = torch.einsum("becf,efd->becd", hidden.to(cd), p["down"].to(cd))

    kept = (rank < capacity).to(torch.float32) * top_p  # (B, S, K); drops -> 0
    out = _combine(y.to(cd), top_i, rank, kept, capacity).to(x.dtype)

    if m.num_shared_experts:
        out = out + mlp(p["shared"], x, cfg, ctx, name=f"{name}.shared")

    if dropless:
        aux = {"lb_loss": torch.zeros((), dtype=torch.float32, device=x.device)}
    else:
        me = torch.mean(probs, dim=(0, 1))
        counts = torch.bincount(top_i.reshape(-1), minlength=e).to(torch.float32)
        aux = {"lb_loss": e * torch.sum(me * counts / (b * s * k))}
    return out, aux
