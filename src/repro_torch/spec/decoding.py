"""The draft loop, the verify step and the acceptance rule (port of
``repro.spec.decoding``).

Distributions are temperature-adjusted targets: ``temp <= 0`` slots use the
one-hot argmax (acceptance is greedy exact-match, and the emitted stream is
bit-identical to accurate-only decoding), ``temp > 0`` slots use
``softmax(logits / temp)`` with the standard speculative-sampling
correction.

PRNG discipline, the reference's: each slot's base key is folded with the
round counter, then with a lane for draft sampling (0), acceptance uniforms
(1) and the correction/bonus sample (2), and inside a lane with the token
index. The threefry arithmetic is ``serve/threefry.py``, so the integer bits
and the uniforms are JAX's; the Gumbel noise and the softmax differ from
JAX's in their last f32 bits.

Both functions update the cache in place (the reference donates it) and read
the round counter from a device tensor, so each can be captured as one CUDA
graph and replayed with new host inputs.
"""
from __future__ import annotations

import torch

from repro_torch.models import ModelApi
from repro_torch.core import EngineContext
from repro_torch.serve import threefry
from repro_torch.serve.engine import top2_margin
from repro_torch.serve.kvcache import with_cache_positions

__all__ = ["make_draft_loop", "make_verify_step"]

_DRAFT_LANE, _ACCEPT_LANE, _CORRECT_LANE = 0, 1, 2


def _round_keys(base_keys, round_idx):
    """(B, 2) per-request keys -> per-round keys; ``round_idx`` a () integer
    tensor (fresh randomness per round)."""
    return threefry.fold_in(base_keys, round_idx.expand(base_keys.shape[:-1]))


def _lane(keys, lane: int):
    return threefry.fold_in(keys, torch.full(keys.shape[:-1], lane, dtype=torch.int64,
                                             device=keys.device))


def _temp_dist(logits, temps):
    """logits (B, ..., V) f32 + temps (B,) -> target/draft distribution: the
    one-hot first-occurrence argmax where ``temp <= 0``, else
    ``softmax(logits / temp)`` written as ``jax.nn.softmax`` computes it."""
    t = temps.reshape(temps.shape + (1,) * (logits.ndim - 1))
    greedy = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1),
                                         logits.shape[-1]).to(torch.float32)
    scaled = logits / torch.clamp(t, min=1e-6)
    e = torch.exp(scaled - scaled.amax(dim=-1, keepdim=True))
    soft = e / e.sum(dim=-1, keepdim=True)
    return torch.where(t > 0.0, soft, greedy)


def make_draft_loop(model: ModelApi, ctx: EngineContext, k: int, sampled: bool = True):
    """k chained single-token decode steps at the draft point.

    ``(tree, tokens (B, 1), cache, base_keys (B, 2), counts (B,), temps (B,),
    round_idx ()) -> (draft_tokens (B, k) int32, draft_probs (B, k, V) f32)``.
    The cache gets k rows written past each slot's committed index (the
    scratch region) and its index advanced by k; the verify step rewinds it.

    ``sampled=False`` is the all-greedy variant, for rounds in which no slot
    samples: each draft is the argmax, with no threefry, no softmax and
    ``draft_probs`` None (the greedy verify reads none). Its drafts are the
    sampled variant's at ``temp <= 0``.
    """

    def draft_loop(tree, tokens, cache, base_keys, counts, temps, round_idx):
        if sampled:
            draft_keys = _lane(_round_keys(base_keys, round_idx), _DRAFT_LANE)
            scale = torch.clamp(temps, min=1e-6)[:, None]
        tok, toks, probs = tokens, [], []
        for i in range(k):
            logits, cache = model.decode_step(tree, tok, cache, ctx)
            last = logits[:, -1, :].to(torch.float32)
            nxt = torch.argmax(last, dim=-1)
            if sampled:
                probs.append(_temp_dist(last, temps))
                draws = threefry.categorical(threefry.fold_in(draft_keys, counts + i),
                                             last / scale)
                nxt = torch.where(temps > 0.0, draws, nxt)
            tok = nxt.to(torch.int32)[:, None]
            toks.append(tok[:, 0])
        return torch.stack(toks, dim=1), torch.stack(probs, dim=1) if sampled else None

    return draft_loop


def make_verify_step(model: ModelApi, ctx: EngineContext, k: int, sampled: bool = True):
    """One multi-token forward at the verify point over the pending token and
    the k drafts.

    ``(tree, tokens (B, 1), draft_tokens (B, k), draft_probs (B, k, V), cache,
    start (B,), base_keys, counts, temps, round_idx) -> (emitted (B, k+1)
    int32, accepted (B,) int32, margins (B, k+1) f32, draft_fault (B,) bool,
    verify_fault (B,) bool)``.

    ``start`` is each slot's committed row count before drafting: the cache
    index is rewound to it, so the decode step writes accurate KV over the
    drafted rows. ``emitted[b, :accepted[b] + 1]`` is the committed
    extension: the accepted draft prefix plus one corrected (resampled from
    ``norm(max(p - q, 0))`` at the first rejection) or bonus token. On exit
    the cache index is ``start + accepted + 1``.

    A slot whose draft distributions are non-finite (``draft_fault``) has its
    whole draft rejected and its token drawn from the position-0
    distribution: the lane degrades to plain decode at the verify point for
    the round. ``verify_fault`` flags non-finite verify logits. Both ride the
    round's one transfer; with finite inputs both are False and change no
    arithmetic.

    ``sampled=False`` is the all-greedy variant (``draft_probs`` unread, may
    be None): a draft is accepted where it is the verify logits' argmax, and
    the next token is the argmax at the first rejection (or at position k).
    It is the sampled variant's arithmetic where every ``temp <= 0``: one-hot
    targets accept exactly the argmax, their residual is the one-hot of the
    verify's argmax, and a greedy round's draft distributions are one-hot
    and so never fault.
    """

    def verify(tree, tokens, draft_tokens, draft_probs, cache, start,
               base_keys, counts, temps, round_idx):
        b, dev = tokens.shape[0], tokens.device
        with_cache_positions(cache, start)
        tok_in = torch.cat([tokens, draft_tokens], dim=1)  # (B, k+1)
        logits, cache = model.decode_step(tree, tok_in, cache, ctx)
        logits = logits.to(torch.float32)  # (B, k+1, V)
        verify_fault = (~torch.isfinite(logits)).flatten(1).any(dim=1)
        if not sampled:
            target = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, k+1)
            accepted = torch.cumprod((draft_tokens == target[:, :k]).to(torch.int32),
                                     dim=1).sum(dim=1).to(torch.int32)
            pos = torch.arange(k + 1, device=dev)[None, :]
            acc = accepted[:, None]
            emitted = torch.where(pos <= acc, target, torch.zeros_like(target))
            with_cache_positions(cache, start + accepted + 1)
            return (emitted, accepted, top2_margin(logits), torch.zeros_like(verify_fault),
                    verify_fault)
        p = _temp_dist(logits, temps)

        # leading-prefix acceptance: accept d_i iff u_i * q(d_i) < p(d_i)
        idx = draft_tokens.to(torch.int64)[..., None]
        q_at = draft_probs.gather(-1, idx)[..., 0]  # (B, k)
        p_at = p[:, :k].gather(-1, idx)[..., 0]     # (B, k)
        draft_fault = (~torch.isfinite(draft_probs)).flatten(1).any(dim=1)
        rkeys = _round_keys(base_keys, round_idx)
        u = threefry.uniform(_lane(rkeys, _ACCEPT_LANE), (k,))  # (B, k)
        accept = (u * q_at < p_at) & ~draft_fault[:, None]
        accepted = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)

        # correction token: the residual at the first rejection, or the bonus
        # distribution (position k) when every draft survived
        resid = torch.clamp(p[:, :k] - draft_probs, min=0.0)
        at = torch.clamp(accepted, max=k - 1).to(torch.int64)
        rows = torch.arange(b, device=dev)
        resid_at = resid[rows, at]
        p_reject = p[rows, at]
        rsum = resid_at.sum(dim=-1, keepdim=True)
        # q == p makes the residual vanish: fall back to p
        resid_at = torch.where(rsum > 0.0, resid_at / torch.clamp(rsum, min=1e-30), p_reject)
        dist = torch.where((accepted == k)[:, None], p[:, k], resid_at)
        # draft fault: the residual subtracted non-finite draft probs, so the
        # lane samples from the position-0 distribution instead
        dist = torch.where(draft_fault[:, None], p[:, 0], dist)
        ckeys = threefry.fold_in(_lane(rkeys, _CORRECT_LANE), counts + accepted)
        draws = threefry.categorical(ckeys, torch.log(dist + 1e-30))
        correction = torch.where(temps > 0.0, draws, torch.argmax(dist, dim=-1))
        correction = correction.to(torch.int32)

        pos = torch.arange(k + 1, device=dev)[None, :]
        drafts_pad = torch.cat([draft_tokens, torch.zeros_like(draft_tokens[:, :1])], dim=1)
        acc = accepted[:, None]
        emitted = torch.where(pos < acc, drafts_pad,
                              torch.where(pos == acc, correction[:, None],
                                          torch.zeros_like(drafts_pad)))
        with_cache_positions(cache, start + accepted + 1)
        return emitted, accepted, top2_margin(logits), draft_fault, verify_fault

    return verify
