"""Encoder-decoder model, seamless-m4t-large-v2 (port of ``repro.models.encdec``).

A speech encoder (bidirectional layers over stub frame embeddings: the
conformer frontend is a stub, ``batch["frontend_embeds"]``) and a text
decoder (causal layers with cross-attention). The frames are 2x downsampled
with the AAD pooling unit (``core/pooling.py:aad_pool_1d``) before the
encoder.

The encoder's self-attention runs ``blocks.attention(..., causal=False)``:
under ``attn_impl="flash"`` the flash kernel without a mask. Cross-attention
has no kernel in the reference (``blocks._sdpa_chunked``, non-causal), and
none here. Decode keeps a self-attention KV cache per decoder layer and a
cross K/V cache per layer; ``make_cache`` zeroes both, and the server never
fills the cross cache (``prefill_cross_kv`` is the reference's, unused by
its server): decoding attends to the zero cross K/V, as the reference does.
The self-attention cache is updated in place.

Under tensor parallelism (``ctx.mesh``) the dense families' rules apply:
self- and cross-attention run on the rank's q and kv heads (``wo`` a
row-parallel product), the ReLU MLP's ``up`` is column- and ``down``
row-parallel, the embedding and the lm_head are vocab-sharded
(``transformer._embed``, ``transformer._lm_head``), a weight stored
FSDP-sharded over ``data`` is all-gathered a layer at a time, and
``make_cache(mesh=)`` holds the rank's kv heads of both caches.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import EngineContext
from repro_torch.core.pooling import aad_pool_1d

from repro_torch.sharding.collectives import enter_model, gather_data

from . import blocks
from .params import ParamSpec, stack_layers
from .transformer import _embed, _fsdp, _lm_head, layer_trees, layer_view, remat_call


def _enc_layer_specs(cfg: ModelConfig):
    return {
        "attn_norm": blocks.norm_spec(cfg),
        "attn": blocks.attention_specs(cfg),
        "mlp_norm": blocks.norm_spec(cfg),
        "mlp": blocks.mlp_specs(cfg),
    }


def _dec_layer_specs(cfg: ModelConfig):
    return {
        "self_norm": blocks.norm_spec(cfg),
        "self_attn": blocks.attention_specs(cfg),
        "cross_norm": blocks.norm_spec(cfg),
        "cross_attn": blocks.attention_specs(cfg),
        "mlp_norm": blocks.norm_spec(cfg),
        "mlp": blocks.mlp_specs(cfg),
    }


def encdec_specs(cfg: ModelConfig):
    e = cfg.encdec
    return {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "enc_layers": stack_layers(lambda: _enc_layer_specs(cfg), e.encoder_layers),
        "enc_norm": blocks.norm_spec(cfg),
        "dec_layers": stack_layers(lambda: _dec_layer_specs(cfg), cfg.num_layers),
        "final_norm": blocks.norm_spec(cfg),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
    }


def _cross_attention(p, x, enc_k, enc_v, cfg, ctx, name):
    """Queries from decoder states against encoder K/V (B, T, KV, hd),
    non-causal."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h_loc = p["wq"].shape[-2]  # this rank's heads
    g = h_loc // enc_k.shape[2]
    if h_loc < cfg.num_heads:  # the decoder states enter the rank's heads
        x = enter_model(x, ctx.mesh)
    q = blocks._proj(ctx, x, p["wq"], p.get("bq"), f"{name}.q")  # (B,S,H,hd)
    ek = torch.repeat_interleave(enc_k, g, dim=2) if g > 1 else enc_k
    ev = torch.repeat_interleave(enc_v, g, dim=2) if g > 1 else enc_v
    t = enc_k.shape[1]
    out = blocks._sdpa_chunked(q, ek, ev, torch.arange(s, device=x.device),
                               torch.arange(t, device=x.device), causal=False)
    out = out.reshape(b, s, h_loc * hd)
    wo = p["wo"].reshape(h_loc * hd, cfg.d_model)
    return ctx.linear(out, wo, name=f"{name}.o", k_sharded=ctx.model_split(cfg.num_heads) > 1)


def _gather_top(params, ctx):
    """``params`` with the FSDP shards of the leaves outside the layer stacks
    all-gathered (``transformer._fsdp``; the stacks are gathered a layer at
    a time by :func:`_layers`)."""
    stacks = ("enc_layers", "dec_layers")
    top = _fsdp({k: v for k, v in params.items() if k not in stacks}, ctx)
    return dict(params, **top)


def _layers(params, key: str, n: int, ctx):
    """The ``n`` stacked layers of ``params[key]`` as trees of views, each
    with its FSDP shards all-gathered under a mesh."""
    for p in layer_trees(params[key], n):
        yield p if ctx.param_specs is None else gather_data(p, ctx.param_specs[key], ctx.mesh,
                                                             lead=1)


def _project_enc_kv(p, enc_out, cfg, ctx, name):
    if p["wk"].shape[-2] < cfg.num_kv_heads:  # the encoder states enter the rank's kv heads
        enc_out = enter_model(enc_out, ctx.mesh)
    k = blocks._proj(ctx, enc_out, p["wk"], p.get("bk"), f"{name}.k")
    v = blocks._proj(ctx, enc_out, p["wv"], p.get("bv"), f"{name}.v")
    return k, v


def encode(params, frames, cfg: ModelConfig, ctx: EngineContext, *, remat: bool = False):
    """frames: (B, T, D) stub embeddings -> (B, T/2, D) encoder states.
    ``remat`` checkpoints each layer when autograd records."""
    h = aad_pool_1d(frames.to(torch.float32), 2).to(cfg.compute_dtype)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)

    def layer(p, h):
        x = blocks.apply_norm(p["attn_norm"], h, cfg)
        out, _ = blocks.attention(p["attn"], x, cfg, ctx, positions=positions, name="enc.attn",
                                  causal=False)
        h = h + out
        x = blocks.apply_norm(p["mlp_norm"], h, cfg)
        return h + blocks.mlp(p["mlp"], x, cfg, ctx, name="enc.mlp")

    for p in _layers(params, "enc_layers", cfg.encdec.encoder_layers, ctx):
        h = remat_call(layer, remat, p, h)
    return blocks.apply_norm(params["enc_norm"], h, cfg)


def forward(params, batch, cfg: ModelConfig, ctx: EngineContext, *, remat: bool = False):
    """Teacher-forced pass: ``batch["frontend_embeds"]`` (B, T, D) frames and
    ``batch["tokens"]`` (B, S) decoder tokens -> (logits (B, S, V) f32, {}).
    ``remat`` checkpoints each encoder and decoder layer when autograd
    records."""
    params = _gather_top(params, ctx)
    enc_out = encode(params, batch["frontend_embeds"], cfg, ctx, remat=remat)
    tokens = batch["tokens"]
    h = _embed(params, tokens, cfg, ctx).to(cfg.compute_dtype)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)

    def layer(p, h, enc_out):
        x = blocks.apply_norm(p["self_norm"], h, cfg)
        out, _ = blocks.attention(p["self_attn"], x, cfg, ctx, positions=positions,
                                  name="dec.self", causal=True)
        h = h + out
        x = blocks.apply_norm(p["cross_norm"], h, cfg)
        ek, ev = _project_enc_kv(p["cross_attn"], enc_out, cfg, ctx, "dec.cross")
        h = h + _cross_attention(p["cross_attn"], x, ek, ev, cfg, ctx, "dec.cross")
        x = blocks.apply_norm(p["mlp_norm"], h, cfg)
        return h + blocks.mlp(p["mlp"], x, cfg, ctx, name="dec.mlp")

    for p in _layers(params, "dec_layers", cfg.num_layers, ctx):
        h = remat_call(layer, remat, p, h, enc_out)
    h = blocks.apply_norm(params["final_norm"], h, cfg)
    return _lm_head(params, h, cfg, ctx), {}


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32, device=None,
               mesh=None):
    """Self-attention caches per decoder layer (k, v (L, B, T, KV, hd), index
    (L, B) int32) and a cross K/V cache per layer (L, B, T/2, KV, hd): the
    stub's encoder length tracks the decoder budget. All zeros. With
    ``mesh`` both hold the rank's kv heads."""
    kvh, hd, n = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    m = mesh.size("model") if mesh is not None else 1
    if m > 1 and kvh % m == 0:
        kvh //= m

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "self": {
            "k": zeros((n, batch, max_len, kvh, hd)),
            "v": zeros((n, batch, max_len, kvh, hd)),
            "index": zeros((n, batch), torch.int32),
        },
        "cross": {
            "k": zeros((n, batch, max_len // 2, kvh, hd)),
            "v": zeros((n, batch, max_len // 2, kvh, hd)),
        },
    }


def prefill_cross_kv(params, enc_out, cfg, ctx):
    """Per-layer cross K/V from encoder states, stacked (L, B, T, KV, hd)."""
    ks, vs = [], []
    for i in range(cfg.num_layers):
        p = layer_view(params["dec_layers"], i)
        k, v = _project_enc_kv(p["cross_attn"], enc_out, cfg, ctx, "dec.cross")
        ks.append(k)
        vs.append(v)
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params, tokens, cache, cfg: ModelConfig, ctx: EngineContext):
    """Decoder tokens (B, S) against the cached self and cross attention ->
    (logits (B, S, V) f32, cache); the self-attention rows and index are
    written into ``cache`` in place."""
    params = _gather_top(params, ctx)
    h = _embed(params, tokens, cfg, ctx).to(cfg.compute_dtype)
    index = cache["self"]["index"][0]  # (B,)
    positions = index[:, None] + torch.arange(tokens.shape[1], dtype=torch.int32,
                                              device=tokens.device)[None, :]
    self_c, cross_c = cache["self"], cache["cross"]
    for i, p in enumerate(_layers(params, "dec_layers", cfg.num_layers, ctx)):
        x = blocks.apply_norm(p["self_norm"], h, cfg)
        out, nc = blocks.attention(p["self_attn"], x, cfg, ctx, positions=positions,
                                   name="dec.self", cache=layer_view(self_c, i))
        self_c["index"][i] = nc["index"]
        h = h + out
        x = blocks.apply_norm(p["cross_norm"], h, cfg)
        h = h + _cross_attention(p["cross_attn"], x, cross_c["k"][i], cross_c["v"][i], cfg, ctx,
                                 "dec.cross")
        x = blocks.apply_norm(p["mlp_norm"], h, cfg)
        h = h + blocks.mlp(p["mlp"], x, cfg, ctx, name="dec.mlp")
    h = blocks.apply_norm(params["final_norm"], h, cfg)
    return _lm_head(params, h, cfg, ctx), cache
