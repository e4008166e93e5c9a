"""Transformer building blocks (port of ``repro.models.blocks``): RoPE, norms,
GQA attention, the gated MLP and the token-choice MoE.

Every projection goes through ``EngineContext``. The cache path writes the KV
cache in place (the reference returns a new one); the attention itself is
the GQA cache-decode kernel (``attn_impl="decode_kernel"``) or the plain
chain (``"xla"``). The cache-free path (``forward``) runs the flash kernel
(``"flash"``) or the reference's query-chunked chain (``"xla"``). The MoE's
router and expert products are plain f32 einsums, as in the reference; its
gate activation is the engine's standalone multi-AF block.

Under tensor parallelism (``ctx.mesh``) a rank holds its shard of every
weight: attention runs on its local q and kv heads (the cache-attention
kernels plan their key splits from the global counts,
``ctx.attention_plan``), ``wo`` and ``down`` are row-parallel products
(``k_sharded``), and the MoE keeps the experts the rank holds (EP): the
router runs whole on every rank (its expert columns all-gathered first), the
dispatch is the same on every rank, each rank runs its experts' products,
and the per-choice outputs are exchanged with one exact sum (each choice has
one non-zero term) before the same ascending-expert combine.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch._device import on_card
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import EngineContext
from repro_torch.core.normalization import layernorm, nonparametric_ln, rmsnorm
from repro_torch.kernels.decode_attention import gqa_decode_attention, gqa_decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention

from repro_torch.sharding.collectives import all_gather, all_reduce

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
    h_loc, kv_loc = p["wq"].shape[-2], p["wk"].shape[-2]  # this rank's heads
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
            g = h_loc // kv_loc
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
            out = gqa_decode_attention(
                q, ck, cv, positions, scale=scale,
                plan_dims=ctx.attention_plan(b, cfg.num_heads, cfg.num_kv_heads))
        else:
            out = gqa_decode_attention_ref(q, ck, cv, positions, scale=scale)
        new_cache = {"k": ck, "v": cv, "index": idx + s}

    out = out.reshape(b, s, h_loc * hd)
    wo = p["wo"].reshape(h_loc * hd, cfg.d_model)
    return ctx.linear(out, wo, name=f"{name}.o",
                      k_sharded=ctx.model_split(cfg.num_heads) > 1), new_cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
                    device=None, kv_heads: Optional[int] = None):
    """One layer's KV cache; ``kv_heads``: the heads a rank holds (default all)."""
    kvh, hd = kv_heads or cfg.num_kv_heads, cfg.head_dim
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


def mlp(p, x, cfg: ModelConfig, ctx: EngineContext, *, name, d_ff: Optional[int] = None):
    """The (gated) MLP; ``d_ff`` is its global width (default ``cfg.d_ff``),
    which says whether ``down`` is row-parallel under a mesh."""
    # linear_af fuses the dot and the activation epilogue into one kernel pass
    if cfg.glu:
        up = ctx.linear(x, p["up"], name=f"{name}.up")
        h = ctx.linear_af(x, p["gate"], af=cfg.act, name=f"{name}.gate") * up
    else:
        h = ctx.linear_af(x, p["up"], af=cfg.act, name=f"{name}.up")
    return ctx.linear(h, p["down"], name=f"{name}.down",
                      k_sharded=ctx.model_split(d_ff or cfg.d_ff) > 1)


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


def _choice_outputs(y, top_i, rank, kept, capacity: int, first_expert: Optional[int] = None):
    """Each token's K weighted expert-slot outputs (B, S, K, D), its choices
    in ascending expert order, and which of them were kept.

    ``y`` holds the slot outputs (B, E, C, D) of every expert, or, with
    ``first_expert``, (B, E', C, D) of experts ``first_expert ..
    first_expert + E' - 1`` (a rank's shard): a choice of another expert
    then gives zeros, which a sum over the ranks that hold the others fills
    in exactly."""
    b, e, c, d = y.shape
    s, k = top_i.shape[1:]
    by_expert = torch.argsort(top_i, dim=-1)  # a token's K experts are distinct
    e_k = torch.gather(top_i, -1, by_expert).to(torch.int64) - (first_expert or 0)
    r_k = torch.gather(rank, -1, by_expert).to(torch.int64)
    w_k = torch.gather(kept, -1, by_expert)
    keep = r_k < capacity
    slot = e_k.clamp(0, e - 1) * capacity + torch.clamp(r_k, max=capacity - 1)
    g = torch.gather(y.reshape(b, e * c, d), 1, slot.reshape(b, s * k, 1).expand(-1, -1, d))
    g = g.reshape(b, s, k, d) * w_k[..., None].to(y.dtype)
    if first_expert is not None:
        here = (e_k >= 0) & (e_k < e)
        g = torch.where(here[..., None], g, torch.zeros_like(g))
    return g, keep


def _sum_choices(g, keep):
    """Each token's sum of its kept choice outputs, from zero in ascending
    expert order."""
    b, s, k, d = g.shape
    out = torch.zeros((b, s, d), dtype=g.dtype, device=g.device)
    for j in range(k):
        out = torch.where(keep[..., j, None], out + g[:, :, j], out)
    return out


def _combine(y, top_i, rank, kept, capacity: int):
    """Each token's weighted sum of its kept expert-slot outputs.

    The reference scatter-adds the (E, C) slot outputs into a zero (B, S, D)
    buffer; a token's slots are visited in ascending expert order. Here each
    token gathers its K slots and sums them from zero in that same order, so
    the sums are the same and, unlike a scatter-add through atomics,
    deterministic on the card.
    """
    return _sum_choices(*_choice_outputs(y, top_i, rank, kept, capacity))


# cuBLAS picks its kernel by a product's shape, so on the card an f32
# product's row would take other bits beside other rows. The per-token f32
# products (the MoE router and experts, the MLA absorption) therefore run
# one shape for every short call: a product of fewer than STABLE_ROWS rows
# pads them to STABLE_ROWS; an expert product whose capacity is below
# STABLE_CAPACITY runs one call per capacity slot (its rows the batch rows),
# so top-1 routing's capacity 1 at decode and k + 1 at a verify of up to 7
# drafts run the same shape (a top-8 router's capacity is 8 at both). A
# decode step's rows and a speculative verify's rows then get the same bits,
# and greedy speculation stays bit-identical to token-by-token decoding.
# The CPU runs them as one product.
STABLE_ROWS = 32
STABLE_CAPACITY = 8


def rows_einsum(eq: str, x, w, lead: int = 2):
    """``torch.einsum(eq, x, w)`` whose ``lead`` leading axes of ``x`` are
    rows (their product M); on CUDA an M below ``STABLE_ROWS`` runs padded
    with zero rows to ``STABLE_ROWS``, as a (1, STABLE_ROWS) batch."""
    m = math.prod(x.shape[:lead])
    if not on_card(x) or m >= STABLE_ROWS:
        return torch.einsum(eq, x, w)
    flat = x.reshape(m, *x.shape[lead:])
    padded = torch.cat([flat, flat.new_zeros((STABLE_ROWS - m, *flat.shape[1:]))])
    out = torch.einsum(eq, padded.reshape(1, STABLE_ROWS, *padded.shape[1:]), w)
    return out[0, :m].reshape(*x.shape[:lead], *out.shape[2:])


# cuBLAS also picks a batched product's kernel by its batch count, and a
# rank of a tensor-parallel mesh holds a shard of the experts (and of MLA's
# heads): on CUDA the per-expert and per-head products therefore run in
# groups of BATCH_GROUP along that axis, on every mesh and without one, so
# a group's bits do not depend on how many experts or heads a rank holds
# (the dry run's meta tensors keep one product).
BATCH_GROUP = 8


def batch_grouped(fn, x, w, x_axis: int, w_axis: int, out_axis: int):
    """``fn(x, w)``, on CUDA in groups of ``BATCH_GROUP`` along the batch axis
    that ``x`` and ``w`` share (``x_axis``, ``w_axis``), concatenated along
    ``out_axis``; one call where that axis does not divide into groups."""
    n = w.shape[w_axis]
    if not x.is_cuda or n % BATCH_GROUP or n == BATCH_GROUP:
        return fn(x, w)
    return torch.cat([fn(x.narrow(x_axis, i, BATCH_GROUP), w.narrow(w_axis, i, BATCH_GROUP))
                      for i in range(0, n, BATCH_GROUP)], dim=out_axis)


def expert_einsum(eq: str, hh, w):
    """``torch.einsum(eq, hh, w)`` over an expert dispatch ``hh`` (B, E, C,
    ...) and expert weights ``w`` (E, ...); on CUDA a capacity C below
    ``STABLE_CAPACITY`` runs one product per capacity slot, each over the B
    batch rows, and the experts run in groups (:func:`batch_grouped`)."""
    c = hh.shape[2]

    def one(h, ww):
        if not on_card(h) or c >= STABLE_CAPACITY:
            return torch.einsum(eq, h, ww)
        return torch.cat([torch.einsum(eq, h[:, :, j:j + 1], ww) for j in range(c)], dim=2)

    return batch_grouped(one, hh, w, 1, 0, 1)


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

    ep = ctx.model_split(e) > 1  # experts over the model axis
    router = p["router"]
    if ep:  # the whole router on every rank: the same routing everywhere
        router = all_gather(router, ctx.mesh, "model", dim=1)
    router_logits = rows_einsum("bsd,de->bse", x.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(router_logits, dim=-1)
    top_p, top_i = top_k_stable(probs, k)  # (B, S, K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    gather_idx, valid, rank = _dispatch_indices(top_i, e, capacity)
    token_of_choice = (gather_idx // k).to(torch.int64)  # (B, E, C) source token
    x_disp = torch.gather(x, 1, token_of_choice.reshape(b, e * capacity, 1).expand(-1, -1, d))
    x_disp = x_disp.reshape(b, e, capacity, d) * valid[..., None].to(x.dtype)
    e0 = 0
    if ep:  # this rank's experts
        e_loc = p["up"].shape[0]
        e0 = ctx.mesh.coord("model") * e_loc
        x_disp = x_disp[:, e0:e0 + e_loc]

    cd = cfg.compute_dtype

    def expert_mm(hh, w):
        return expert_einsum("becd,edf->becf", hh.to(cd), w.to(cd))

    up = expert_mm(x_disp, p["up"])
    gate = expert_mm(x_disp, p["gate"])
    hidden = ctx.activate(gate, cfg.act) * up
    y = expert_einsum("becf,efd->becd", hidden.to(cd), p["down"].to(cd))
    if not ep and ctx.model_split(m.d_ff_expert) > 1:  # the expert width over model
        y = all_reduce(y, ctx.mesh)

    kept = (rank < capacity).to(torch.float32) * top_p  # (B, S, K); drops -> 0
    if ep:
        g, keep = _choice_outputs(y.to(cd), top_i, rank, kept, capacity, first_expert=e0)
        out = _sum_choices(all_reduce(g, ctx.mesh), keep).to(x.dtype)
    else:
        out = _combine(y.to(cd), top_i, rank, kept, capacity).to(x.dtype)

    if m.num_shared_experts:
        out = out + mlp(p["shared"], x, cfg, ctx, name=f"{name}.shared",
                        d_ff=m.d_ff_shared * m.num_shared_experts)

    if dropless:
        aux = {"lb_loss": torch.zeros((), dtype=torch.float32, device=x.device)}
    else:
        me = torch.mean(probs, dim=(0, 1))
        # the routed count of each expert (a scatter-add, where bincount has
        # no meta kernel for the dry run)
        flat = top_i.reshape(-1).to(torch.int64)
        counts = torch.zeros((e,), dtype=torch.int64, device=x.device).scatter_add_(
            0, flat, torch.ones_like(flat)).to(torch.float32)
        aux = {"lb_loss": e * torch.sum(me * counts / (b * s * k))}
    return out, aux
