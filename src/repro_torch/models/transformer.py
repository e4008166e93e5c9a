"""Decoder-only LM: the dense, MoE, vision-stub, SSM and hybrid families
(port of ``repro.models.transformer``).

The reference's ``lax.scan`` over stacked layer parameters becomes a Python
loop over layer views of the same stacked tensors, segment by segment: a
deepseek-style MoE model is a dense prefix and an MoE segment, a
llama4-style one a segment of interleaved (dense, MoE) pairs, each pair one
stacked entry with a ``dense`` and a ``moe`` sublayer. Attention is GQA, or
MLA when the config carries one. An SSM model (mamba2) is one segment of
Mamba2 layers; a hybrid one (zamba2) a segment of groups, each ``attn_every``
Mamba2 layers (a nested ``(groups, attn_every, ...)`` stack) followed by the
weight-shared attention block and MLP (``params["shared_attn"]``).
``forward`` is the cache-free pass (training, the calibration scan; a vision
model prepends its stub frontend embeddings); ``decode_step`` the cached
one, on text tokens. The cache is updated in place: ``decode_step`` writes
each layer's KV rows, index and recurrent state into the cache it was given
and returns that cache.

Under tensor parallelism (``ctx.mesh``; the attention families) the
embedding table and the lm_head are vocab-sharded: a token's row is the
masked local lookup summed over the model axis (one non-zero term: exact),
and the local logits are all-gathered along the vocab before any argmax or
sample. A weight stored FSDP-sharded over ``data`` is all-gathered where it
is used, one layer at a time (:func:`_fsdp`). ``make_cache(mesh=)`` makes
the rank's cache: its kv heads (an MLA latent is whole on every rank).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends.base import PreparedWeight
from repro_torch.core.engine import EngineContext

from repro_torch.sharding.collectives import all_gather, all_reduce, gather_data

from . import blocks, mamba2, mla
from .params import ParamSpec, stack_layers


def _segments(cfg: ModelConfig):
    """(kind, layer_count) segments; layer params stack within a segment."""
    if cfg.family in ("dense", "vlm"):
        return [("dense", cfg.num_layers)]
    if cfg.family == "moe":
        m = cfg.moe
        segs = []
        if m.first_dense_layers:
            segs.append(("dense_prefix", m.first_dense_layers))
        rest = cfg.num_layers - m.first_dense_layers
        if m.moe_every == 1:
            segs.append(("moe", rest))
        else:
            if rest % m.moe_every:
                raise ValueError(f"{cfg.name}: {rest} layers after the dense prefix do not "
                                 f"split into groups of moe_every={m.moe_every}")
            segs.append(("pair", rest // m.moe_every))
        return segs
    if cfg.family == "ssm":
        return [("mamba", cfg.num_layers)]
    if cfg.family == "hybrid":
        per = cfg.hybrid.attn_every
        if cfg.num_layers % per:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split into groups of "
                             f"attn_every={per}")
        return [("hybrid", cfg.num_layers // per)]  # groups of (per mamba + shared attn)
    raise ValueError(cfg.family)


def _attn_specs(cfg: ModelConfig):
    return mla.mla_specs(cfg) if cfg.mla else blocks.attention_specs(cfg)


def _dense_layer_specs(cfg: ModelConfig, d_ff: Optional[int] = None):
    return {
        "attn_norm": blocks.norm_spec(cfg),
        "attn": _attn_specs(cfg),
        "mlp_norm": blocks.norm_spec(cfg),
        "mlp": blocks.mlp_specs(cfg, d_ff),
    }


def _moe_layer_specs(cfg: ModelConfig):
    return {
        "attn_norm": blocks.norm_spec(cfg),
        "attn": _attn_specs(cfg),
        "mlp_norm": blocks.norm_spec(cfg),
        "moe": blocks.moe_specs(cfg),
    }


def _mamba_layer_specs(cfg: ModelConfig):
    return {"norm": blocks.norm_spec(cfg), "mixer": mamba2.mamba2_specs(cfg)}


def decoder_specs(cfg: ModelConfig):
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "final_norm": blocks.norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    for i, (kind, n) in enumerate(_segments(cfg)):
        if kind == "dense":
            layer = lambda: _dense_layer_specs(cfg)  # noqa: E731
        elif kind == "dense_prefix":
            layer = lambda: _dense_layer_specs(cfg, cfg.moe.d_ff_dense)  # noqa: E731
        elif kind == "pair":
            layer = lambda: {"dense": _dense_layer_specs(cfg, cfg.moe.d_ff_dense),  # noqa: E731
                             "moe": _moe_layer_specs(cfg)}
        elif kind == "mamba":
            layer = lambda: _mamba_layer_specs(cfg)  # noqa: E731
        elif kind == "hybrid":
            per = cfg.hybrid.attn_every
            layer = lambda: stack_layers(lambda: _mamba_layer_specs(cfg), per)  # noqa: E731
            specs["shared_attn"] = {
                "attn_norm": blocks.norm_spec(cfg),
                "attn": blocks.attention_specs(cfg),
                "mlp_norm": blocks.norm_spec(cfg),
                "mlp": blocks.mlp_specs(cfg),
            }
        else:
            layer = lambda: _moe_layer_specs(cfg)  # noqa: E731
        specs[f"seg{i}_{kind}"] = stack_layers(layer, n)
    return specs


def layer_view(tree, i: int):
    """Layer ``i`` of a stacked parameter or cache tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    if isinstance(tree, PreparedWeight):
        return tree.layer(i)
    return tree[i]


def layer_trees(tree, n: int):
    """Layers ``0..n-1`` of a stacked parameter tree as ``n`` trees of views,
    each tensor split once by ``unbind``: under autograd the gradients of the
    ``n`` layers are stacked back in one pass, where ``n`` separate
    :func:`layer_view` indexings would each scatter into a zero tensor of the
    whole stack."""
    if isinstance(tree, dict):
        parts = {k: layer_trees(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    return [layer_view(tree, i) for i in range(n)]


def remat_call(fn, remat: bool, *args):
    """``fn(*args)``, with activation checkpointing when ``remat`` and autograd
    is recording: the reference's ``jax.checkpoint`` around a scanned layer,
    as ``torch.utils.checkpoint`` (non-reentrant). The layer's forward is run
    again in the backward pass on the same inputs, so the loss and the
    gradients are bitwise those without it."""
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _attn_block(p, h, cfg, ctx, positions, cache, name):
    x = blocks.apply_norm(p["attn_norm"], h, cfg)
    attend = mla.mla_attention if cfg.mla else blocks.attention
    out, new_cache = attend(p["attn"], x, cfg, ctx, positions=positions, name=name, cache=cache)
    return h + out, new_cache


def _dense_layer(p, h, cfg, ctx, positions, cache, name="layer"):
    h, new_cache = _attn_block(p, h, cfg, ctx, positions, cache, f"{name}.attn")
    x = blocks.apply_norm(p["mlp_norm"], h, cfg)
    d_ff = (cfg.moe.d_ff_dense if cfg.moe else 0) or cfg.d_ff  # as decoder_specs sizes it
    h = h + blocks.mlp(p["mlp"], x, cfg, ctx, name=f"{name}.mlp", d_ff=d_ff)
    return h, new_cache, {}


def _moe_layer(p, h, cfg, ctx, positions, cache, name="layer"):
    h, new_cache = _attn_block(p, h, cfg, ctx, positions, cache, f"{name}.attn")
    x = blocks.apply_norm(p["mlp_norm"], h, cfg)
    # cached decode gets the dropless short-block capacity; the cache-free
    # forward the capacity-dropping form and its load-balancing loss
    out, aux = blocks.moe_ffn(p["moe"], x, cfg, ctx, name=f"{name}.moe",
                              dropless=cache is not None)
    return h + out, new_cache, aux


def _pair_layer(p, h, cfg, ctx, positions, cache):
    """A dense layer then an MoE layer. Both run under the reference's default
    name ``"layer"``, as its ``pair_fn`` calls them: their dots are looked up
    in a policy as ``layer.attn.q``, ``layer.moe.shared.up``..., not under
    their parameter paths (``layer.dense.attn.q``)."""
    c = cache or {}
    h, c_dense, _ = _dense_layer(p["dense"], h, cfg, ctx, positions, c.get("dense"))
    h, c_moe, aux = _moe_layer(p["moe"], h, cfg, ctx, positions, c.get("moe"))
    return h, {"dense": c_dense, "moe": c_moe}, aux


def _mamba_layer(p, h, cfg, ctx, state, name="layer"):
    x = blocks.apply_norm(p["norm"], h, cfg)
    out, new_state = mamba2.mamba2_forward(p["mixer"], x, cfg, ctx, name=f"{name}.mixer",
                                           state=state)
    return h + out, new_state


def _mamba_segment_layer(p, h, cfg, ctx, positions, cache):
    h, new_state = _mamba_layer(p, h, cfg, ctx, cache)
    return h, new_state, {}


def _hybrid_group(p, h, cfg, ctx, positions, cache, shared):
    """One hybrid group: ``attn_every`` Mamba2 layers (``p`` stacks them),
    then the shared attention block and MLP. Those run under the
    reference's runtime names ``shared.attn`` and ``shared.mlp``, while
    their prepared banks take their names from the ``shared_attn.*``
    parameter paths."""
    c = cache or {}
    c_ssm = c.get("ssm")
    for j in range(cfg.hybrid.attn_every):
        h, _ = _mamba_layer(layer_view(p, j), h, cfg, ctx,
                            layer_view(c_ssm, j) if c_ssm is not None else None)
    h, new_attn = _attn_block(shared, h, cfg, ctx, positions, c.get("attn"), "shared.attn")
    x = blocks.apply_norm(shared["mlp_norm"], h, cfg)
    h = h + blocks.mlp(shared["mlp"], x, cfg, ctx, name="shared.mlp")
    return h, {"ssm": c_ssm, "attn": new_attn}, {}


_LAYERS = {"dense": _dense_layer, "dense_prefix": _dense_layer, "moe": _moe_layer,
           "pair": _pair_layer, "mamba": _mamba_segment_layer}


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32, device=None,
               mesh=None):
    """Per-segment caches stacked over layers: k, v (L, B, T, KV, hd), or
    MLA's c_kv (L, B, T, R) and k_rope (L, B, T, r), and the per-row write
    index (L, B) int32; a pair segment holds one such cache per sublayer,
    ``{"dense": ..., "moe": ...}``. A Mamba2 layer's state is its conv
    window (L, B, W-1, C) and SSM state (L, B, H, N, P); a hybrid segment
    holds, per group, its layers' states ``ssm`` (G, per, B, ...) and the
    shared attention's KV cache ``attn`` (G, B, T, KV, hd). With ``mesh``
    (tensor parallelism) a GQA cache holds the rank's kv heads."""
    if cfg.mla:
        init = mla.init_mla_cache
    else:
        m = mesh.size("model") if mesh is not None else 1
        kv = cfg.num_kv_heads // m if m > 1 and cfg.num_kv_heads % m == 0 else None

        def init(*a):
            return blocks.init_attn_cache(*a, kv_heads=kv)

    def stack(tree, n):
        if isinstance(tree, dict):
            return {k: stack(v, n) for k, v in tree.items()}
        return tree.unsqueeze(0).repeat((n,) + (1,) * tree.ndim)

    def mamba_c():
        return mamba2.init_mamba_state(cfg, batch, dtype, device)

    out = {}
    for i, (kind, n) in enumerate(_segments(cfg)):
        if kind == "pair":
            one = {"dense": init(cfg, batch, max_len, dtype, device),
                   "moe": init(cfg, batch, max_len, dtype, device)}
        elif kind == "mamba":
            one = mamba_c()
        elif kind == "hybrid":
            one = {"ssm": stack(mamba_c(), cfg.hybrid.attn_every),
                   "attn": blocks.init_attn_cache(cfg, batch, max_len, dtype, device)}
        else:
            one = init(cfg, batch, max_len, dtype, device)
        out[f"seg{i}_{kind}"] = stack(one, n)
    return out


def _embed(params, tokens, cfg, ctx):
    """The token rows of the embedding table. Vocab-sharded under a mesh:
    the rank's rows where it holds them, zeros elsewhere, summed over the
    model axis. Where d_model is an FSDP shard (the table not gathered), the
    data ranks look up every data rank's tokens in their own columns and
    all-gather the rows' columns: the rows, not the table, cross the data
    group."""
    table = params["embed"]
    sharded_d = table.shape[1] != cfg.d_model
    if sharded_d:
        b = tokens.shape[0]
        tokens = all_gather(tokens, ctx.mesh, "data", dim=0)
    if ctx.model_split(cfg.vocab_size) == 1:
        rows = table[tokens]
    else:
        v_loc = table.shape[0]
        local = tokens.to(torch.int64) - ctx.mesh.coord("model") * v_loc
        here = (local >= 0) & (local < v_loc)
        rows = table[local.clamp(0, v_loc - 1)]
        rows = all_reduce(torch.where(here[..., None], rows, torch.zeros_like(rows)), ctx.mesh)
    if sharded_d:
        c = ctx.mesh.coord("data")
        rows = all_gather(rows, ctx.mesh, "data", dim=-1)[c * b:(c + 1) * b]
    return rows


def _lm_head(params, h, cfg, ctx):
    if cfg.tie_embeddings and "lm_head" not in params:
        w = params["embed"].T
    else:
        w = params["lm_head"]
    logits = ctx.linear(h, w, name="lm_head").to(torch.float32)
    if ctx.model_split(cfg.vocab_size) > 1:  # the vocab's shards, in order
        logits = all_gather(logits, ctx.mesh, "model", dim=-1)
    return logits


def _fsdp(tree, ctx, key=None):
    """Under a mesh, ``tree`` with its FSDP shards all-gathered over the data
    group (``collectives.gather_data``): layer trees of segment ``key``
    (their stacked axis indexed away), or, without a key, the leaves outside
    the stacked segments (the final norm, the lm_head, and the embedding
    where it is the tied lm_head; its lookup gathers rows, :func:`_embed`)."""
    if ctx.param_specs is None:
        return tree
    if key is not None:
        return gather_data(tree, ctx.param_specs[key], ctx.mesh, lead=1)
    top = {k: v for k, v in tree.items()
           if not k.startswith("seg") and not (k == "embed" and "lm_head" in tree)}
    return dict(tree, **gather_data(top, {k: ctx.param_specs[k] for k in top}, ctx.mesh))


def _run_segments(params, h, cfg, ctx, positions, cache=None, *, remat: bool = False):
    """Every layer, segment by segment, over layer views of the stacked
    parameters (and of ``cache``, whose write indices and recurrent state it
    advances in place). ``remat`` checkpoints each layer (a hybrid group) of
    a cache-free pass (:func:`remat_call`).
    Returns ``(h, lb_loss)``: the load-balancing loss summed over the MoE
    layers of a cache-free pass (None with a cache)."""
    lb_loss = torch.zeros((), dtype=torch.float32, device=h.device) if cache is None else None
    for i, (kind, n) in enumerate(_segments(cfg)):
        key = f"seg{i}_{kind}"
        run = _LAYERS.get(kind)
        if kind == "hybrid":
            run = lambda *a: _hybrid_group(*a, params["shared_attn"])  # noqa: E731
        if cache is None:
            for p in layer_trees(params[key], n):
                p = _fsdp(p, ctx, key)
                h, _, aux = remat_call(run, remat, p, h, cfg, ctx, positions, None)
                if "lb_loss" in aux:
                    lb_loss = lb_loss + aux["lb_loss"]
            continue
        for layer in range(n):
            c = layer_view(cache[key], layer)
            h, new_c, aux = run(_fsdp(layer_view(params[key], layer), ctx, key), h, cfg, ctx,
                                positions, c)
            _store_index(cache[key], layer, new_c)
    return h, lb_loss


def _store_index(stacked, layer: int, new):
    """Write a layer's new cache indices into layer ``layer`` of the stacked
    cache, sublayer by sublayer (its k/v rows were written in place)."""
    for k, v in stacked.items():
        if isinstance(v, dict):
            _store_index(v, layer, new[k])
        elif k == "index":
            v[layer] = new[k]


def forward(params, batch, cfg: ModelConfig, ctx: EngineContext, *, remat: bool = False):
    """Cache-free forward: ``batch["tokens"]`` (B, S) -> (logits (B, S', V)
    f32, ``{"lb_loss": ...}``), the load-balancing loss summed over the MoE
    layers (zero for a dense model).

    A vision model (``cfg.frontend == "vision"``) prepends the stub
    frontend's ``batch["frontend_embeds"]`` (B, P, D) to the token
    embeddings, so S' = P + S and the logits cover both; without them it
    raises ``KeyError``. Positions are ``arange(S')``; attention runs causal
    over the sequence itself (``ctx.attn_impl``: ``"flash"`` the flash
    kernels, ``"xla"`` the reference's chunked chains; training runs
    ``"xla"``, since neither flash kernel has a backward). ``remat``
    checkpoints each layer when autograd records (:func:`remat_call`).
    """
    tokens = batch["tokens"]
    params = _fsdp(params, ctx)
    h = _embed(params, tokens, cfg, ctx).to(cfg.compute_dtype)
    if cfg.frontend == "vision":
        h = torch.cat([batch["frontend_embeds"].to(cfg.compute_dtype), h], dim=1)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=tokens.device)
    h, lb_loss = _run_segments(params, h, cfg, ctx, positions, remat=remat)
    h = blocks.apply_norm(params["final_norm"], h, cfg)
    return _lm_head(params, h, cfg, ctx), {"lb_loss": lb_loss}


def _leaves(cache):
    for v in cache.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _cache_index(cache) -> torch.Tensor:
    """Per-row decode positions (B,): layer 0 of the first stacked index (all
    layers advance in lockstep). An SSM-only cache has no index (the mixer
    reads no positions): zeros, as in the reference."""
    for v in _leaves(cache):
        if v.dtype == torch.int32 and v.ndim >= 2:
            return v[0]
    some = next(_leaves(cache))
    return torch.zeros((some.shape[1],), dtype=torch.int32, device=some.device)


def decode_step(params, tokens, cache, cfg: ModelConfig, ctx: EngineContext):
    """Cached decode: tokens (B, S) + cache -> (logits (B, S, V), cache).

    S = 1 is the one-token decode step; S > 1 writes a whole block (bucketed
    prefill). The cache is updated in place and returned. A vision model
    decodes text tokens only, as the reference serves it.
    """
    params = _fsdp(params, ctx)
    h = _embed(params, tokens, cfg, ctx).to(cfg.compute_dtype)
    index = _cache_index(cache)
    positions = index[:, None] + torch.arange(tokens.shape[1], dtype=torch.int32,
                                              device=tokens.device)[None, :]
    h, _ = _run_segments(params, h, cfg, ctx, positions, cache)
    h = blocks.apply_norm(params["final_norm"], h, cfg)
    return _lm_head(params, h, cfg, ctx), cache
