"""Decoder-only LM, dense and MoE families (port of ``repro.models.transformer``).

The reference's ``lax.scan`` over stacked layer parameters becomes a Python
loop over layer views of the same stacked tensors, segment by segment (a
deepseek-style MoE model is a dense prefix and an MoE segment). Attention is
GQA, or MLA when the config carries one. ``forward`` is the cache-free
pass (training, the calibration scan); ``decode_step`` the cached one. The
KV cache is updated in place: ``decode_step`` writes each layer's rows and
index into the cache it was given and returns that cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends.base import PreparedWeight
from repro_torch.core.engine import EngineContext

from . import blocks, mla
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
        if m.moe_every != 1:
            raise NotImplementedError("interleaved dense/MoE ('pair') segments are not yet "
                                      "ported")
        segs.append(("moe", cfg.num_layers - m.first_dense_layers))
        return segs
    raise NotImplementedError(f"the {cfg.family!r} family is not yet ported")


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
        else:
            layer = lambda: _moe_layer_specs(cfg)  # noqa: E731
        specs[f"seg{i}_{kind}"] = stack_layers(layer, n)
    return specs


def layer_view(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    if isinstance(tree, PreparedWeight):
        return tree.layer(i)
    return tree[i]


def _attn_block(p, h, cfg, ctx, positions, cache, name):
    x = blocks.apply_norm(p["attn_norm"], h, cfg)
    attend = mla.mla_attention if cfg.mla else blocks.attention
    out, new_cache = attend(p["attn"], x, cfg, ctx, positions=positions, name=name, cache=cache)
    return h + out, new_cache


def _dense_layer(p, h, cfg, ctx, positions, cache, name="layer"):
    h, new_cache = _attn_block(p, h, cfg, ctx, positions, cache, f"{name}.attn")
    x = blocks.apply_norm(p["mlp_norm"], h, cfg)
    h = h + blocks.mlp(p["mlp"], x, cfg, ctx, name=f"{name}.mlp")
    return h, new_cache, {}


def _moe_layer(p, h, cfg, ctx, positions, cache, name="layer"):
    h, new_cache = _attn_block(p, h, cfg, ctx, positions, cache, f"{name}.attn")
    x = blocks.apply_norm(p["mlp_norm"], h, cfg)
    # cached decode gets the dropless short-block capacity; the cache-free
    # forward the capacity-dropping form and its load-balancing loss
    out, aux = blocks.moe_ffn(p["moe"], x, cfg, ctx, name=f"{name}.moe",
                              dropless=cache is not None)
    return h + out, new_cache, aux


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32, device=None):
    """Per-segment KV caches stacked over layers: k, v (L, B, T, KV, hd), or
    MLA's c_kv (L, B, T, R) and k_rope (L, B, T, r), and the per-row write
    index (L, B) int32."""
    init = mla.init_mla_cache if cfg.mla else blocks.init_attn_cache
    out = {}
    for i, (kind, n) in enumerate(_segments(cfg)):
        one = init(cfg, batch, max_len, dtype, device)
        out[f"seg{i}_{kind}"] = {k: v.unsqueeze(0).repeat((n,) + (1,) * v.ndim)
                                 for k, v in one.items()}
    return out


def _lm_head(params, h, cfg, ctx):
    if cfg.tie_embeddings and "lm_head" not in params:
        w = params["embed"].T
    else:
        w = params["lm_head"]
    return ctx.linear(h, w, name="lm_head").to(torch.float32)


def forward(params, batch, cfg: ModelConfig, ctx: EngineContext, *, remat: bool = False):
    """Cache-free forward: ``batch["tokens"]`` (B, S) -> (logits (B, S, V)
    f32, ``{"lb_loss": ...}``), the load-balancing loss summed over the MoE
    layers (zero for a dense model).

    Positions are ``arange(S)``; attention runs causal over the sequence
    itself (``ctx.attn_impl``: ``"flash"`` the flash kernels, ``"xla"`` the
    reference's chunked chains). ``remat`` (activation checkpointing) is
    accepted for the reference's signature; it takes effect only with
    autograd, which this pass does not record yet.
    """
    del remat
    if cfg.frontend == "vision":
        raise NotImplementedError("the vision frontend's embeddings are not yet ported")
    tokens = batch["tokens"]
    h = params["embed"][tokens].to(cfg.compute_dtype)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
    lb_loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i, (kind, n) in enumerate(_segments(cfg)):
        seg_p = params[f"seg{i}_{kind}"]
        layer_fn = _moe_layer if kind == "moe" else _dense_layer
        for layer in range(n):
            h, _, aux = layer_fn(layer_view(seg_p, layer), h, cfg, ctx, positions, None)
            if "lb_loss" in aux:
                lb_loss = lb_loss + aux["lb_loss"]
    h = blocks.apply_norm(params["final_norm"], h, cfg)
    return _lm_head(params, h, cfg, ctx), {"lb_loss": lb_loss}


def _cache_index(cache) -> torch.Tensor:
    """Per-row decode positions (B,): layer 0 of the first stacked index."""
    for seg in cache.values():
        for v in seg.values():
            if v.dtype == torch.int32 and v.ndim >= 2:
                return v[0]
    raise ValueError("cache carries no write index")


def decode_step(params, tokens, cache, cfg: ModelConfig, ctx: EngineContext):
    """Cached decode: tokens (B, S) + cache -> (logits (B, S, V), cache).

    S = 1 is the one-token decode step; S > 1 writes a whole block (bucketed
    prefill). The cache is updated in place and returned.
    """
    h = params["embed"][tokens].to(cfg.compute_dtype)
    index = _cache_index(cache)
    positions = index[:, None] + torch.arange(tokens.shape[1], dtype=torch.int32,
                                              device=tokens.device)[None, :]
    for i, (kind, n) in enumerate(_segments(cfg)):
        key = f"seg{i}_{kind}"
        seg_p, seg_c = params[key], cache[key]
        layer_fn = _moe_layer if kind == "moe" else _dense_layer
        for layer in range(n):
            p = layer_view(seg_p, layer)
            c = {name: v[layer] for name, v in seg_c.items()}
            h, new_c, _ = layer_fn(p, h, cfg, ctx, positions, c)
            seg_c["index"][layer] = new_c["index"]
    h = blocks.apply_norm(params["final_norm"], h, cfg)
    return _lm_head(params, h, cfg, ctx), cache
