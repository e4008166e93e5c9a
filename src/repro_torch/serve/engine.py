"""Serving engine: decode bursts, bucketed prefill, per-slot sampling, batched
scheduler (port of ``repro.serve.engine``).

Continuous batching over a fixed slot count, with the reference's hot
paths, each a device program:

* **bucketed prefill** (:func:`make_bucketed_prefill`), for the families
  whose caches are pure KV rows (``_BATCHED_PREFILL_FAMILIES``): an admitted
  prompt is padded to a power-of-two bucket and run through the model in one
  multi-token decode step into a fresh f32 row cache; token 0 is sampled
  from the logits at the true prompt length, the row is scattered into the
  slot, its write index rewound to the prompt length and the slot's serving
  state admitted (:func:`_finish_prefill`). One program per bucket;
* **scan prefill** (:func:`make_scan_prefill`), for the recurrent-state
  families (ssm, hybrid, audio): one single-token decode step per prompt
  token into a static row cache, then the same finish. The reference scans
  the whole padded bucket and masks the state updates past the prompt
  length; a masked step leaves the row and the last logits exactly as they
  were, so running only the prompt's steps gives the same row and logits,
  bit for bit. Two programs for every prompt length: the step (replayed
  once per prompt token; it reads its token at a device-side counter and
  has no output) and the finish (the prefill's one transfer);
* **decode bursts** (:func:`make_decode_burst`): ``burst`` single-token steps
  keep the pending tokens, counts, budgets, PRNG keys and temperatures on the
  device; one host transfer per burst brings tokens and top-2 margins back,
  and the host clips each slot's run to its remaining budget. Two variants:
  sampled and all-greedy, picked per burst from the active requests.

Sampling is the reference's (:func:`_sample_slots`): each request's PRNG key
(``Request.seed``, default its ``rid``) is folded with the index of the token
being generated, so a stream does not depend on batch composition,
scheduling or burst size; ``temperature <= 0`` is greedy. The threefry
arithmetic is ``threefry.py``.

The functions run the same on any device and update the cache and slot state
in place, which stands in for JAX's donation. ``BatchedServer`` runs them
through ``capture.GraphRunner``: on the card each prefill bucket, the scan
prefill's step and finish, and each burst variant is one captured CUDA
graph, replayed once per prefill (the scan step once per prompt token) and
per burst; on the CPU they run eagerly.

Slots that are free or drained keep decoding every burst, as in the
reference; their cache index runs on and the KV write clamps at ``max_len``.
Adaptive precision, speculative decoding, resilience (and with it the slot
state's fault flag), observability and mesh serving are not yet ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import EngineContext, prepare_params
from repro_torch.models import ModelApi

from . import threefry
from .capture import GraphRunner, Staged
from .kvcache import bucket_length, scatter_rows, with_cache_positions

# families whose decode caches are pure attention/MLA KV rows (scatterable,
# index-rewindable); recurrent-state families prefill through the scan
_BATCHED_PREFILL_FAMILIES = ("dense", "vlm", "moe")


def prefills_batched(cfg) -> bool:
    """Whether a server of ``cfg`` prefills a prompt as one forward over its
    bucket; every other family prefills through the scan, one single-token
    step a prompt token."""
    return cfg.family in _BATCHED_PREFILL_FAMILIES


def sample(logits, key, *, temperature: float = 0.0):
    """logits (B, 1, V) -> tokens (B, 1), with one key ``(2,)`` for the batch."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    # a divisor held on the device: torch divides by a host scalar as a
    # product with its reciprocal, which is not the reference's quotient
    t = torch.full((), temperature, dtype=torch.float32, device=logits.device)
    scaled = logits.to(torch.float32) / t
    return torch.argmax(scaled + threefry.gumbel(key, scaled.shape), dim=-1).to(torch.int32)


def _sample_slots(last, base_keys, counts, temps):
    """Per-slot sampling: last (B, V) f32 logits -> (B, 1) int32 tokens.

    ``base_keys`` (B, 2) per-request PRNG keys, ``counts`` (B,) the index of
    the token each slot generates (folded in), ``temps`` (B,) temperatures;
    ``temp <= 0`` is greedy, the first-occurrence argmax.
    """
    greedy = torch.argmax(last, dim=-1)
    keys = threefry.fold_in(base_keys, counts)
    scaled = last / torch.clamp(temps, min=1e-6)[:, None]
    sampled = threefry.categorical(keys, scaled)
    return torch.where(temps > 0.0, sampled, greedy).to(torch.int32)[:, None]


def top2_margin(logits):
    """Top-2 logit margin along the last axis (values only: ``torch.topk``
    promises no order among ties, so no token is taken from it)."""
    vals = torch.topk(logits, 2, dim=-1).values
    return vals[..., 0] - vals[..., 1]


# Per-slot serving state, on the device between programs:
#   tok   (slots, 1) int32   pending token (last generated)
#   count (slots,)   int32   generated-token index (PRNG fold position)
#   rem   (slots,)   int32   remaining token budget; 0 = slot inactive
#   key   (slots, 2) int64   per-request PRNG base key (two uint32 words)
#   temp  (slots,)   float32 per-request temperature (<= 0: greedy)


def _init_slot_state(slots: int, device=None):
    return {
        "tok": torch.zeros((slots, 1), dtype=torch.int32, device=device),
        "count": torch.zeros((slots,), dtype=torch.int32, device=device),
        "rem": torch.zeros((slots,), dtype=torch.int32, device=device),
        # distinct placeholder keys, PRNGKey(slot); every admission overwrites
        "key": torch.stack([torch.zeros((slots,), dtype=torch.int64, device=device),
                            torch.arange(slots, dtype=torch.int64, device=device)], dim=-1),
        "temp": torch.zeros((slots,), dtype=torch.float32, device=device),
    }


def _admit_state(state, slot, tok, base_key, temp, max_new):
    """Write one admitted request's serving state into slot ``slot`` (a
    one-element integer tensor), in place."""
    s = slot.reshape(1).to(torch.int64)
    state["tok"].index_copy_(0, s, tok.reshape(1, 1).to(torch.int32))
    state["count"].index_fill_(0, s, 1)  # prefill emitted token 0
    state["rem"].index_copy_(0, s, (max_new.reshape(1) - 1).to(torch.int32))
    state["key"].index_copy_(0, s, base_key.reshape(1, 2).to(torch.int64))
    state["temp"].index_copy_(0, s, temp.reshape(1).to(torch.float32))
    return state


def _finish_prefill(cache, state, row, last, slot, base_key, temp, max_new):
    """Shared prefill tail: sample token 0, scatter the row, admit the slot.
    Returns ``(tok (1, 1), margin (1,))``; cache and state change in place."""
    tok = _sample_slots(last, base_key.reshape(1, 2),
                        torch.zeros((1,), dtype=torch.int32, device=last.device),
                        temp.reshape(1))
    scatter_rows(cache, row, slot)
    _admit_state(state, slot, tok, base_key, temp, max_new)
    return tok, top2_margin(last)


def make_decode_burst(model: ModelApi, ctx: EngineContext, burst: int, sampled: bool = True):
    """The decode hot loop: ``burst`` single-token steps.

    ``(tree, cache, state) -> (tokens (B, burst) int32, margins (B, burst)
    f32)``; the cache and ``state``'s tok, count and rem are updated in place.
    Slots keep computing after their budget drains; the caller clips each
    slot's run to ``state['rem']`` on entry.

    ``sampled=False`` is the all-greedy variant: no threefry fold or
    categorical per step, bit-identical to the sampled variant at
    ``temp <= 0``. Its token is the first-occurrence argmax and its margin
    one ``topk``, where the reference takes both from one ``top_k``: the
    same values, since ``top_k`` breaks ties to the lower index as argmax does.
    """

    def decode_burst(tree, cache, state):
        keys, temps = state["key"], state["temp"]
        tok, count, rem = state["tok"], state["count"], state["rem"]
        toks, margins = [], []
        for _ in range(burst):
            logits, cache = model.decode_step(tree, tok, cache, ctx)
            last = logits[:, -1, :].to(torch.float32)
            if sampled:
                nxt = _sample_slots(last, keys, count, temps)
            else:
                nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
            margins.append(top2_margin(last))
            active = (rem > 0).to(torch.int32)
            count, rem = count + active, rem - active
            toks.append(nxt[:, 0])
            tok = nxt
        state["tok"].copy_(tok)
        state["count"].copy_(count)
        state["rem"].copy_(rem)
        return torch.stack(toks, dim=1), torch.stack(margins, dim=1)

    return decode_burst


def make_bucketed_prefill(model: ModelApi, ctx: EngineContext, max_len: int):
    """Whole-prompt prefill, scatter included.

    ``(tree, cache, state, tokens (1, Pb), plen, slot, base_key, temp,
    max_new) -> (tok (1, 1), margin (1,))``, the scalars as tensors on the
    cache's device. ``tokens`` is the prompt padded to a power-of-two bucket
    ``Pb`` (suffix padding); token 0 comes from the logits at ``plen - 1``
    and the fresh row cache is written into slot ``slot`` with its index
    rewound to ``plen``: the padded tail's rows are invisible, overwritten
    by decode. One program per bucket shape.
    """

    def prefill(tree, cache, state, tokens, plen, slot, base_key, temp, max_new):
        row = model.make_cache(1, max_len, dtype=torch.float32, device=tokens.device)
        logits, row = model.decode_step(tree, tokens, row, ctx)
        plen = plen.reshape(1)
        last = logits.index_select(1, (plen - 1).to(torch.int64))[:, 0, :].to(torch.float32)
        with_cache_positions(row, plen)
        return _finish_prefill(cache, state, row, last, slot, base_key, temp, max_new)

    return prefill


def _zero(tree) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _zero(v)
    else:
        tree.zero_()


def make_scan_prefill(model: ModelApi, ctx: EngineContext):
    """The recurrent-state families' prefill, as two programs over a static
    row cache ``row`` (a fresh ``make_cache(1, max_len)``) and a scan state
    ``scan = {"i": (1,) int64 counter, "last": (1, V) f32 logits}``.

    ``step(tree, row, scan, prompt)``: one decode step of token
    ``prompt[0, i]`` (``prompt`` (1, max_len) int32) into ``row``; writes its
    logits to ``last`` and advances ``i``. Run once per prompt token.

    ``finish(cache, state, row, scan, slot, base_key, temp, max_new) -> (tok
    (1, 1), margin (1,))``: sample token 0 from ``last``, scatter the row into
    slot ``slot``, admit the slot (:func:`_finish_prefill`); then zero the
    row, ``last`` and ``i`` for the next prefill, as the reference starts
    each from a fresh cache (the hybrid attention index and the
    encoder-decoder's cross K/V too).
    """

    def step(tree, row, scan, prompt):
        tok = prompt.index_select(1, scan["i"])
        logits, _ = model.decode_step(tree, tok, row, ctx)
        scan["last"].copy_(logits[:, -1, :])
        scan["i"].add_(1)

    def finish(cache, state, row, scan, slot, base_key, temp, max_new):
        out = _finish_prefill(cache, state, row, scan["last"], slot, base_key, temp, max_new)
        _zero(row)
        _zero(scan)
        return out

    return step, finish


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32, P >= 1
    max_new: int
    temperature: float = 0.0      # <= 0: greedy
    seed: Optional[int] = None    # PRNG stream seed; defaults to rid
    generated: Optional[List[int]] = None
    margins: Optional[List[float]] = None  # top-2 logit margin per generated token


def _checked_prompt(req: Request) -> np.ndarray:
    prompt = np.asarray(req.prompt, np.int32)
    if prompt.size == 0:
        raise ValueError(
            f"request {req.rid}: empty prompt — prompts must carry at least "
            "one token (seed with BOS)"
        )
    return prompt


class BatchedServer:
    """Continuous batching over ``slots`` concurrent sequences.

    ``device`` defaults to ``cuda`` (and raises without a card); pass
    ``"cpu"`` to serve with the kernels' plain versions.
    ``prepare_weights=True`` (default) prepares the weight bank once, at
    construction; ``False`` serves the raw tree through the per-call path,
    which re-rounds every weight at every dot (the reference's A/B against
    the prepared path).

    Counters of the last ``run``: ``host_transfers`` (device-to-host round
    trips, one per prefill and per burst), ``prefill_calls`` (prefills: one
    model forward each when bucketed), ``prefill_steps`` (the scan
    prefill's single-token forwards, one per prompt token) and
    ``decode_steps`` (decode forwards), ``prefill_seconds`` /
    ``decode_seconds`` (their wall time), ``graph_replays`` (CUDA-graph
    replays; 0 on the CPU) and ``emissions``: rid -> ``(seconds since run
    entry, tokens)`` each time tokens of the request reached the host.
    ``captured_launches`` holds each graph's kernel launches by
    instantiation, counted at its capture; ``programs`` (a
    ``capture.GraphRunner``) also its ``replays`` and capture time.
    ``capture=False`` runs the same programs eagerly on the card, every
    launch issued from the host (the uncaptured yardstick).
    """

    def __init__(self, model: ModelApi, ctx: EngineContext, params, slots: int = 4,
                 max_len: int = 256, burst: int = 8, device=None, prepare_weights: bool = True,
                 capture: bool = True):
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.model, self.ctx = model, ctx
        self.slots, self.max_len, self.burst = slots, max_len, burst
        self.device = resolve_device(device)
        params = _to_device(params, self.device)
        if prepare_weights:
            params = prepare_params(params, ctx.policy, ctx.mode, specs=model.specs())
        self.params = params
        self.cache = model.make_cache(slots, max_len, dtype=torch.float32, device=self.device)
        self._state = _init_slot_state(slots, self.device)
        self.programs = GraphRunner(self.device, capture)
        self.batched_prefill = prefills_batched(model.cfg)
        self._bursts = {s: make_decode_burst(model, ctx, burst, sampled=s) for s in (False, True)}
        staged = self.programs.staged
        # the prefill's host inputs; each bucket has its own prompt buffer
        self._prompts: Dict[int, Staged] = {}
        self._args = {"plen": staged((), torch.int32), "slot": staged((), torch.int32),
                      "key": staged((2,), torch.int64), "temp": staged((), torch.float32),
                      "max_new": staged((), torch.int32)}
        if self.batched_prefill:
            self._prefill = make_bucketed_prefill(model, ctx, max_len)
        else:
            # the scan prefill's static row cache, counter, last logits and
            # prompt buffer, made here, before any capture
            self._scan_step, self._scan_finish = make_scan_prefill(model, ctx)
            self._row = model.make_cache(1, max_len, dtype=torch.float32, device=self.device)
            self._scan = {"i": torch.zeros((1,), dtype=torch.int64, device=self.device),
                          "last": torch.zeros((1, model.cfg.vocab_size), dtype=torch.float32,
                                              device=self.device)}
            self._scan_prompt = staged((1, max_len), torch.int32)
        self.active: Dict[int, Request] = {}
        self._reset_counters()

    def _reset_counters(self):
        self.host_transfers = 0
        self.prefill_calls = 0
        self.prefill_steps = 0
        self.decode_steps = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.programs.replays.clear()
        self.emissions: Dict[int, List[Tuple[float, int]]] = {}
        self._t0 = time.perf_counter()

    @property
    def graph_replays(self) -> int:
        return sum(self.programs.replays.values())

    @property
    def captured_launches(self) -> Dict[str, Dict[str, int]]:
        """Each graph's kernel launches by instantiation, counted at its capture."""
        return self.programs.captured_launches

    def _admission_error(self, req: Request) -> None:
        prompt = _checked_prompt(req)
        if len(prompt) + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(prompt)}) + max_new ({req.max_new}) "
                f"exceeds max_len ({self.max_len}) — the KV cache would overflow mid-decode"
            )

    def _emit(self, req: Request, toks, margins) -> None:
        req.generated.extend(int(t) for t in toks)
        req.margins.extend(float(m) for m in margins)
        self.emissions.setdefault(req.rid, []).append(
            (time.perf_counter() - self._t0, len(toks)))

    @torch.no_grad()
    def _prefill_slot(self, slot: int, req: Request) -> None:
        """Bucketed: one program, in which the prompt (padded to its bucket)
        prefills a fresh row cache, the row is scattered into the slot and
        the slot's serving state admitted. Scan: the step program once per
        prompt token, then the finish program. Token 0 and its margin are
        the one transfer."""
        t0 = time.perf_counter()
        prompt = _checked_prompt(req)
        plen = len(prompt)
        args = self._args
        seed = req.seed if req.seed is not None else req.rid
        for name, value in (("plen", plen), ("slot", slot), ("key", threefry.prng_key(seed)),
                            ("temp", req.temperature), ("max_new", req.max_new)):
            args[name].fill(value)
        if self.batched_prefill:
            out = self._bucketed_prefill(prompt)
        else:
            out = self._scan_prefill(prompt)
        self.prefill_calls += 1
        self.host_transfers += 1
        req.generated, req.margins = [], []
        self._emit(req, out[0].tolist(), out[1].tolist())
        self.prefill_seconds += time.perf_counter() - t0

    def _bucketed_prefill(self, prompt: np.ndarray) -> torch.Tensor:
        plen = len(prompt)
        bucket = bucket_length(plen, self.max_len)
        if bucket not in self._prompts:
            self._prompts[bucket] = self.programs.staged((1, bucket), torch.int32)
        tokens, args = self._prompts[bucket], self._args
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :plen] = prompt
        tokens.fill(padded)

        def program(cache, state):
            a = {name: s.device_buf for name, s in args.items()}
            tok, margin = self._prefill(self.params, cache, state, tokens.device_buf, a["plen"],
                                        a["slot"], a["key"], a["temp"], a["max_new"])
            return torch.stack([tok.reshape(1).to(torch.float32), margin])

        return self.programs.run(f"prefill {bucket}", program, self.cache, self._state,
                                 inputs=[tokens, *args.values()])

    def _scan_prefill(self, prompt: np.ndarray) -> torch.Tensor:
        tokens, args = self._scan_prompt, self._args
        padded = np.zeros((1, self.max_len), np.int32)
        padded[0, :len(prompt)] = prompt
        tokens.fill(padded)

        def step(row, scan):
            self._scan_step(self.params, row, scan, tokens.device_buf)

        for j in range(len(prompt)):
            self.programs.run("prefill step", step, self._row, self._scan,
                              inputs=[tokens] if j == 0 else ())
            self.prefill_steps += 1

        def finish(cache, state):
            a = {name: s.device_buf for name, s in args.items()}
            tok, margin = self._scan_finish(cache["slots"], state["slots"], cache["row"],
                                            state["scan"], a["slot"], a["key"], a["temp"],
                                            a["max_new"])
            return torch.stack([tok.reshape(1).to(torch.float32), margin])

        # the row and the scan state go in with the slot cache and state, so
        # that a graph's warm-up runs on copies of all of them
        return self.programs.run("prefill finish", finish,
                                 {"slots": self.cache, "row": self._row},
                                 {"slots": self._state, "scan": self._scan},
                                 inputs=list(args.values()))

    @torch.no_grad()
    def _burst_round(self, slot_of: Dict[int, int]) -> None:
        """One decode burst over all slots, one program and one transfer;
        each active slot's run is clipped to its budget on the host."""
        t0 = time.perf_counter()
        sampled = any(r.temperature > 0.0 for r in self.active.values())
        burst_fn = self._bursts[sampled]

        def program(cache, state):
            toks, margins = burst_fn(self.params, cache, state)
            return torch.stack([toks.to(torch.float32), margins])

        out = self.programs.run(f"burst {'sampled' if sampled else 'greedy'}", program,
                                self.cache, self._state).numpy()
        self.decode_steps += self.burst
        self.host_transfers += 1
        for rid, req in self.active.items():
            s = slot_of[rid]
            n = min(self.burst, req.max_new - len(req.generated))
            self._emit(req, out[0, s, :n], out[1, s, :n])
        self.decode_seconds += time.perf_counter() - t0

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve requests to completion; returns rid -> generated tokens.
        Per-token top-2 margins land on each request's ``.margins``."""
        for req in requests:  # reject before any state mutates
            self._admission_error(req)
        self._reset_counters()
        self.active.clear()
        queue = list(requests)
        results: Dict[int, List[int]] = {}
        slot_of: Dict[int, int] = {}
        free = list(range(self.slots))
        while queue or self.active:
            while queue and free:
                req, slot = queue.pop(0), free.pop(0)
                self._prefill_slot(slot, req)
                if len(req.generated) >= req.max_new:
                    results[req.rid] = req.generated
                    free.append(slot)
                else:
                    self.active[req.rid] = req
                    slot_of[req.rid] = slot
            if not self.active:
                continue
            self._burst_round(slot_of)
            for rid in [r for r, q in self.active.items() if len(q.generated) >= q.max_new]:
                results[rid] = self.active.pop(rid).generated
                free.append(slot_of.pop(rid))
        return results


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
