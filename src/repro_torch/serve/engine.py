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
* **chunked prefill** (:func:`make_prefill_chunk`, :func:`make_scan_chunk`,
  :func:`make_chunk_admit`, :meth:`BatchedServer.chunk_fns`), the streaming
  frontend's (``serve/frontend.py``): a prompt advances through a static
  private row cache at most ``chunk_tokens`` rows a scheduler tick, one
  program a chunk bucket (the scan's step a chunk row), and an admit
  program finishes it with the prefill's one transfer;
* **decode bursts** (:func:`make_decode_burst`): ``burst`` single-token steps
  keep the pending tokens, counts, budgets, PRNG keys and temperatures on the
  device; one host transfer per burst brings tokens and top-2 margins back,
  and the host clips each slot's run to its remaining budget. Two variants:
  sampled and all-greedy, picked per burst from the active requests;
* **runtime-adaptive precision** (``repro_torch.runtime``): with a
  ``ModeController``, each prefill and burst runs at the controller's
  current execution point, a tree of its multi-point weight bank; after
  each burst the controller observes the burst's min top-2 margin, the
  queue depth and the free slots (they ride the burst's one transfer), and
  ``self.telemetry`` records occupancy, switches and estimated MAC cycles;
* **self-speculative decoding** (``repro_torch.spec``): with
  ``speculate=SpecConfig(...)`` the decode loop becomes draft-k-then-verify
  rounds over a bank (``bank=``, or the controller's), each round one
  draft program, one verify program and one transfer; prompts prefill at
  the verify point, and greedy output is bit-identical to serving every
  token at that point;
* **fault-tolerant serving** (``repro_torch.resilience``): with a
  ``ResilienceConfig`` oversized or empty prompts and queue overflow are
  shed with structured reasons instead of raising, deadlines evict at burst
  boundaries, and slots whose logits go non-finite (or past
  ``logit_limit``) are quarantined. The detection flag lives in the slot
  state and rides the burst's one transfer; every request ends in exactly
  one ``self.outcomes[rid]``. ``injector`` fires deterministic faults before
  chosen rounds;
* **observability** (``repro_torch.obs``): a ``ServingObserver`` records
  SLO metrics and a structured trace at the host sync points the loop
  already pays for, so the device programs are untouched and the streams
  are bit-identical with the observer on or off; ``snapshot()`` exports
  everything a run accumulated.

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
per burst; on the CPU they run eagerly. A graph replays the addresses it was
captured with, so under a bank each (program, execution point) is a graph
of its own, named ``"<program> @<point>"`` (:func:`program_name`) and
captured at its first visit: a switch to a point already visited replays
its graphs, with no re-capture and no copy of any bank.

Slots that are free or drained keep decoding every burst, as in the
reference; their cache index runs on and the KV write clamps at ``max_len``.

**Tensor-parallel serving** (``BatchedServer(mesh=...)``, a
``launch.mesh.Mesh`` over the process group's ranks; every family, every
engine mode, prepared or per-call weights): SPMD, every rank runs the same
host loop over the same requests. A rank keeps its shard of every weight
(``sharding.partition``: sliced from the raw tree, then prepared; in the
int8 mode prepared whole, then sliced, so a row shard keeps the whole K's
per-channel scales; a bank's points sharded once per leaf; a Mamba2 mixer's
conv and norm whole, ``partition.serving_specs``) and the model calls the
collectives itself (``sharding.collectives``). Slots shard over ``data``
(``slot_pspec``): a rank's cache and slot state hold its data group's slots,
its kv heads and its SSM heads; weights with an ``embed`` axis are stored
FSDP-sharded over ``data`` and all-gathered a layer at a time where they
are used. Every data group runs each prefill (its FSDP gathers span the
data group, so every data rank runs every program; the scan prefill's
single-token step too, once per prompt token) and the owning one scatters
the row into its slot; a burst runs on the local slots and its tokens,
margins and flags are all-gathered over ``data`` before the host reads
them, so every rank's scheduler stays in lockstep. ``gloo`` collectives
cannot be captured in a CUDA graph, so a meshed server runs uncaptured
(``capture=True`` with a mesh raises). Where the model axis splits the q
heads but not the kv heads, every rank holds the whole kv heads (their
weights and cache rows) and its q heads read them in place. Refused under a
mesh, naming its ROADMAP item: the streaming frontend.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import EngineContext, prepare_params
from repro_torch.kernels.decode_attention.ops import MLA_UNSPLIT_S, TC_MIN_S
from repro_torch.models import ModelApi

from . import threefry
from .capture import GraphRunner, Staged
from .kvcache import bucket_length, scatter_rows, with_cache_positions

# families whose decode caches are pure attention/MLA KV rows (scatterable,
# index-rewindable); recurrent-state families prefill through the scan
_BATCHED_PREFILL_FAMILIES = ("dense", "vlm", "moe")

# the fewest query rows a GQA or MLA cache-attention call runs on the tensor
# cores (fewer: split keys); the two paths give a row bits that differ by
# ulps, so a chunked prompt keeps each row on the path run()'s bucket takes
_TC_ROWS = max(TC_MIN_S, MLA_UNSPLIT_S)


# programs that read no weights: one graph serves every point
_WEIGHTLESS = ("prefill finish", "prefill admit")


def program_name(base: str, point: Optional[str] = None) -> str:
    """The graph name of program ``base`` run at bank execution point
    ``point`` (None: a server without a bank, or a program that reads no
    weights)."""
    return base if point is None else f"{base} @{point}"


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
#   fault (slots,)   bool    non-finite/saturated logits seen since admission


def _init_slot_state(slots: int, device=None):
    return {
        "tok": torch.zeros((slots, 1), dtype=torch.int32, device=device),
        "count": torch.zeros((slots,), dtype=torch.int32, device=device),
        "rem": torch.zeros((slots,), dtype=torch.int32, device=device),
        # distinct placeholder keys, PRNGKey(slot); every admission overwrites
        "key": torch.stack([torch.zeros((slots,), dtype=torch.int64, device=device),
                            torch.arange(slots, dtype=torch.int64, device=device)], dim=-1),
        "temp": torch.zeros((slots,), dtype=torch.float32, device=device),
        "fault": torch.zeros((slots,), dtype=torch.bool, device=device),
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
    state["fault"].index_fill_(0, s, False)
    return state


def _finish_prefill(cache, state, row, last, slot, base_key, temp, max_new, owned=True):
    """Shared prefill tail: sample token 0, scatter the row, admit the slot.
    Returns ``(tok (1, 1), margin (1,))``; cache and state change in place.
    ``owned=False`` (a data rank that does not hold the slot) only samples."""
    tok = _sample_slots(last, base_key.reshape(1, 2),
                        torch.zeros((1,), dtype=torch.int32, device=last.device),
                        temp.reshape(1))
    if owned:
        scatter_rows(cache, row, slot)
        _admit_state(state, slot, tok, base_key, temp, max_new)
    return tok, top2_margin(last)


def make_decode_burst(model: ModelApi, ctx: EngineContext, burst: int, sampled: bool = True,
                      logit_limit: Optional[float] = None):
    """The decode hot loop: ``burst`` single-token steps.

    ``(tree, cache, state) -> (tokens (B, burst) int32, margins (B, burst)
    f32, faults (B, burst) bool)``; the cache and ``state``'s tok, count, rem
    and fault are updated in place. Slots keep computing after their budget
    drains; the caller clips each slot's run to ``state['rem']`` on entry.

    ``faults`` is the per-slot numeric-fault flag, cumulative across the
    burst: step ``j`` is True iff some step ``<= j`` (or an earlier burst
    since the slot's admission, through ``state['fault']``) produced a
    non-finite logit, or with ``logit_limit`` a logit beyond
    ``±logit_limit``, in that slot's lane. Detection is always in the
    program and rides its one transfer; the host commits only the steps
    before the first flagged one. Token math is untouched.

    ``sampled=False`` is the all-greedy variant: no threefry fold or
    categorical per step, bit-identical to the sampled variant at
    ``temp <= 0``. Its token is the first-occurrence argmax and its margin
    one ``topk``, where the reference takes both from one ``top_k``: the
    same values, since ``top_k`` breaks ties to the lower index as argmax does.
    """

    def decode_burst(tree, cache, state):
        keys, temps = state["key"], state["temp"]
        tok, count, rem, fault = state["tok"], state["count"], state["rem"], state["fault"]
        toks, margins, faults = [], [], []
        for _ in range(burst):
            logits, cache = model.decode_step(tree, tok, cache, ctx)
            last = logits[:, -1, :].to(torch.float32)
            bad = ~torch.isfinite(last).all(dim=-1)
            if logit_limit is not None:
                bad = bad | (last.abs() > logit_limit).any(dim=-1)
            fault = fault | bad
            faults.append(fault)
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
        state["fault"].copy_(fault)
        return torch.stack(toks, dim=1), torch.stack(margins, dim=1), torch.stack(faults, dim=1)

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

    def prefill(tree, cache, state, tokens, plen, slot, base_key, temp, max_new, owned=True):
        row = model.make_cache(1, max_len, dtype=torch.float32, device=tokens.device,
                               mesh=ctx.mesh)
        logits, row = model.decode_step(tree, tokens, row, ctx)
        plen = plen.reshape(1)
        last = logits.index_select(1, (plen - 1).to(torch.int64))[:, 0, :].to(torch.float32)
        with_cache_positions(row, plen)
        return _finish_prefill(cache, state, row, last, slot, base_key, temp, max_new, owned)

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

    ``finish(cache, state, row, scan, slot, base_key, temp, max_new, owned)
    -> (tok (1, 1), margin (1,))``: sample token 0 from ``last``, scatter the
    row into slot ``slot`` and admit the slot where this rank holds it
    (``owned``; :func:`_finish_prefill`); then zero the
    row, ``last`` and ``i`` for the next prefill, as the reference starts
    each from a fresh cache (the hybrid attention index and the
    encoder-decoder's cross K/V too).
    """

    def step(tree, row, scan, prompt):
        tok = prompt.index_select(1, scan["i"])
        logits, _ = model.decode_step(tree, tok, row, ctx)
        scan["last"].copy_(logits[:, -1, :])
        scan["i"].add_(1)

    def finish(cache, state, row, scan, slot, base_key, temp, max_new, owned=True):
        out = _finish_prefill(cache, state, row, scan["last"], slot, base_key, temp, max_new,
                              owned)
        _zero(row)
        _zero(scan)
        return out

    return step, finish


def make_prefill_chunk(model: ModelApi, ctx: EngineContext):
    """One chunked-prefill step for the attention/MLA families.

    ``(tree, row, last, tokens (1, Cb), start, clen)``: ``row`` is the
    request's private single-row cache; ``tokens`` are ``clen`` prompt rows
    from row ``start`` on, padded to a power-of-two bucket ``Cb``. The write
    index is set to ``start`` (the rows committed by earlier chunks; a chunk
    that would pass ``max_len`` starts earlier and recomputes some of them,
    :meth:`BatchedServer.chunk_span`), then one S = Cb decode step: each
    query attends the committed rows and its own chunk prefix under the
    per-query-causal mask, the key set the monolithic prefill gives it; then
    the write index is rewound to ``start + clen``, so the padded tail is
    scratch the next chunk writes over. ``last`` (1, V) f32 takes the logits
    at the chunk's last real row: once the prompt is exhausted, the sampling
    input of token 0 (:func:`make_chunk_admit`). ``row`` and ``last`` change
    in place; ``start`` and ``clen`` are one-element tensors on the device.
    """

    def chunk(tree, row, last, tokens, start, clen):
        with_cache_positions(row, start.reshape(1))
        logits, _ = model.decode_step(tree, tokens, row, ctx)
        clen = clen.reshape(1)
        last.copy_(logits.index_select(1, (clen - 1).to(torch.int64))[:, 0, :])
        with_cache_positions(row, start.reshape(1) + clen)

    return chunk


def make_scan_chunk(model: ModelApi, ctx: EngineContext):
    """Chunked prefill for the recurrent-state families: the scan prefill's
    single-token step (:func:`make_scan_prefill`), run once per real row of
    the chunk, with the row cache and the last logits as the carry across
    chunks. The reference scans the padded chunk and masks the steps past
    ``clen``; a masked step changes nothing, so running only the real rows
    gives the same carry, bit for bit. It is the scan prefill's step, so one
    ``"prefill step"`` graph a point serves both."""
    return make_scan_prefill(model, ctx)[0]


def make_chunk_admit():
    """Finish a chunked prefill: sample token 0 from the last logits, scatter
    the finished row into its slot, admit the slot state (the shared
    :func:`_finish_prefill` tail). ``(cache, state, row, last, slot,
    base_key, temp, max_new) -> (tok (1, 1), margin (1,))``."""
    return _finish_prefill


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32, P >= 1
    max_new: int
    temperature: float = 0.0      # <= 0: greedy
    seed: Optional[int] = None    # PRNG stream seed; defaults to rid
    # deadline in seconds from run entry, checked at burst boundaries (after
    # the burst's transfer); None: no deadline (ResilienceConfig's
    # default_deadline_s may fill it in, run-locally)
    deadline_s: Optional[float] = None
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

    ``mesh`` (a ``launch.mesh.Mesh``) serves tensor-parallel, SPMD: every
    rank constructs the server with the same arguments and runs the same
    requests (the module's docstring). ``params`` (or the bank) may be the
    whole tree: a rank keeps its shard. ``self.shardings`` holds the
    placement (``sharding.partition.ServingShardings``);
    :meth:`collective_snapshot` the collective bytes of one greedy burst.

    ``controller`` (a ``runtime.ModeController``, or a
    ``resilience.DegradationPolicy`` around one) serves runtime-adaptive
    precision from its bank; ``params`` may then stay raw (they are not
    prepared), and ``telemetry`` accumulates the run's record.
    ``speculate`` (a ``spec.SpecConfig``) serves self-speculative rounds
    from ``bank`` (default: the controller's bank), which must hold trees on
    ``device``; with a controller, it picks the draft point a round.
    ``spec_rounds`` counts the rounds of the last run (one verify forward
    and one transfer each; ``decode_steps`` then counts the draft steps).

    ``resilience`` (a ``resilience.ResilienceConfig``) switches the server
    from fail-stop to shed/quarantine/degrade, as the reference's does:
    oversized or empty prompts and queue overflow are shed with structured
    reasons, deadlines are enforced at burst boundaries, and slots whose
    logits are flagged are quarantined; ``run()`` then returns partial
    streams for expired and faulted requests and omits shed ones. Outcomes
    (``self.outcomes``) are recorded with or without it. ``injector`` (a
    ``resilience.FaultInjector``) fires deterministic faults before chosen
    rounds. ``observer`` (an ``obs.ServingObserver``) records metrics and a
    trace; ``snapshot()`` exports the last run.
    """

    def __init__(self, model: ModelApi, ctx: EngineContext, params, slots: int = 4,
                 max_len: int = 256, burst: int = 8, device=None, prepare_weights: bool = True,
                 capture: bool = True, controller=None, bank=None, speculate=None,
                 observer=None, resilience=None, injector=None, mesh=None):
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.model, self.ctx = model, ctx
        self.slots, self.max_len, self.burst = slots, max_len, burst
        self.device = resolve_device(device)
        self.controller, self.speculate = controller, speculate
        self.observer, self.resilience, self.injector = observer, resilience, injector
        self._bank = bank if bank is not None or controller is None else controller.bank
        self.mesh, self.shardings = mesh, None
        self._local_slots, self._data_shards = slots, 1
        self._slot_ctx = ctx  # the bursts' and speculative rounds' context
        # the int8 mode's per-channel weight scales span the whole K: its
        # tree is prepared whole, then sharded
        whole_first = (ctx.mode == "int8" and prepare_weights and self._bank is None
                       and speculate is None)
        if mesh is not None:
            _check_mesh(model.cfg, mesh, self.device, capture)
            specs = model.serving_specs()
            if slots % mesh.size("data") == 0:
                self._data_shards = mesh.size("data")
                self._local_slots = slots // self._data_shards
            if self._bank is not None:
                from repro_torch.runtime.bank import place_bank

                place_bank(self._bank, mesh, specs)
            elif whole_first:
                from repro_torch.sharding.partition import require_whole

                require_whole(params, specs, "the int8 mode on a mesh: its weight scales span K")
            else:
                from repro_torch.sharding.partition import shard_params

                params = shard_params(params, specs, mesh)
        params = _to_device(params, self.device)
        self.telemetry = None
        if controller is not None:
            from repro_torch.runtime import TelemetryRecorder

            self.telemetry = TelemetryRecorder.for_bank(controller.bank)
        elif prepare_weights and speculate is None:
            params = prepare_params(params, ctx.policy, ctx.mode, specs=model.specs())
            if mesh is not None and whole_first:
                from repro_torch.sharding.partition import shard_params

                params = shard_params(params, specs, mesh)
        self.params = params
        self.batched_prefill = prefills_batched(model.cfg)
        if speculate is not None:
            if self._bank is None:
                raise ValueError(
                    "speculate= needs a multi-point weight bank: pass bank= "
                    "or a controller that carries one"
                )
            if not self.batched_prefill:
                raise ValueError(
                    f"speculative serving needs a scatterable KV cache; the "
                    f"{model.cfg.family!r} family carries recurrent "
                    "state that cannot roll back past rejected drafts"
                )
        self.cache = model.make_cache(self._local_slots, max_len, dtype=torch.float32,
                                      device=self.device, mesh=mesh)
        self._state = _init_slot_state(self._local_slots, self.device)
        if mesh is not None:
            self.shardings = _serving_shardings(self, mesh)
            # the model reads the mesh and, for its FSDP gathers, the served
            # tree's specs; a prefill's single row is the same on every data
            # rank, while the bursts and speculative rounds run on the local
            # slots
            self.ctx = ctx = dataclasses.replace(ctx, mesh=mesh,
                                                 param_specs=self.shardings.params)
            self._slot_ctx = dataclasses.replace(ctx, batch_shards=self._data_shards)
        self.programs = GraphRunner(self.device, capture)
        self.spec = self.spec_telemetry = None
        if speculate is not None:
            from repro_torch.spec import SpeculativeDecoder

            self.spec = SpeculativeDecoder(model, self._slot_ctx, self._bank, speculate,
                                           programs=self.programs, mesh=mesh,
                                           data_shards=self._data_shards)
            self.spec_telemetry = self.spec.telemetry
        # host views of each slot's committed KV rows and, for the
        # speculative rounds, its pending token and generated count (uploaded)
        # and its temperature (which picks a round's variant)
        self._slot_start = np.zeros((slots,), np.int32)
        self._slot_tok = np.zeros((slots,), np.int32)
        self._slot_count = np.zeros((slots,), np.int32)
        self._slot_temp = np.zeros((slots,), np.float32)
        # the fault flag's logit limit is fixed per server: a constant of
        # the burst programs (and of their graphs)
        limit = resilience.logit_limit if resilience is not None else None
        self._bursts = {s: make_decode_burst(model, self._slot_ctx, burst, sampled=s,
                                             logit_limit=limit)
                        for s in (False, True)}
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
            self._row = model.make_cache(1, max_len, dtype=torch.float32, device=self.device,
                                         mesh=mesh)
            self._scan = {"i": torch.zeros((1,), dtype=torch.int64, device=self.device),
                          "last": torch.zeros((1, model.cfg.vocab_size), dtype=torch.float32,
                                              device=self.device)}
            self._scan_prompt = staged((1, max_len), torch.int32)
        self._chunk_fns = None  # (chunk, admit), built by the streaming frontend
        self._frontend_meta = None  # set by the streaming frontend
        self.active: Dict[int, Request] = {}
        self._visited = set()  # programs built on this server (uncaptured)
        self._run_complete: Optional[bool] = None  # None: never ran
        self.outcomes: Dict[int, object] = {}  # rid -> RequestOutcome
        self._fault_counts = {"shed": 0, "expired": 0, "faulted": 0, "deadline_misses": 0}
        self._deadlines: Dict[int, Optional[float]] = {}
        self._round_idx = 0
        self._reset_counters()

    def _reset_counters(self):
        self.host_transfers = 0
        self.prefill_calls = 0
        self.prefill_steps = 0
        self.prefill_chunks = 0
        self.decode_steps = 0
        self.spec_rounds = 0
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

    def _serving_tree(self):
        """The tree prefill and non-speculative decode run at: the verify
        point's when speculating (the committed prompt KV is accurate), the
        controller's current point's, else the prepared tree."""
        if self.spec is not None:
            return self._bank.tree(self.spec.verify_point)
        return self.controller.tree() if self.controller is not None else self.params

    def _serving_point(self) -> Optional[str]:
        """Name of the execution point prefill and non-speculative decode run
        at (None when serving a plain prepared tree)."""
        if self.spec is not None:
            return self.spec.verify_point
        return self.controller.point if self.controller is not None else None

    def _builds(self, name: str, key) -> bool:
        """Whether running program ``name`` first builds a device program:
        on the card, whether its graph is about to be captured (a first
        visit, or a re-capture after :meth:`weights_replaced`); uncaptured,
        the reference's rule, the first visit of ``key`` (a prefill bucket,
        a burst variant) on this server."""
        if self.programs.capture:
            return name not in self.programs.graphs
        if key in self._visited:
            return False
        self._visited.add(key)
        return True

    def weights_replaced(self, point: Optional[str]) -> None:
        """The tree of bank point ``point`` (None: the static tree) was
        replaced: drop the graphs that read it, to be captured again at
        their next call; every other graph replays untouched."""
        if point is None:
            self.programs.drop(lambda name: " @" in name or name in _WEIGHTLESS)
        else:
            self.programs.drop(lambda name: not name.endswith(f" @{point}"))

    # -- admission: validation + run-local deadline resolution ----------------

    def _admission_error(self, req: Request) -> Optional[str]:
        """Validate one request at admission. A resilient server gets a
        structured shed reason (or None when admissible); without
        ``resilience`` the fail-stop contract raises instead."""
        scratch = self.spec.draft_len if self.spec is not None else 0
        prompt = np.asarray(req.prompt, np.int32)
        too_long = len(prompt) + req.max_new + scratch > self.max_len
        if self.resilience is None:
            _checked_prompt(req)
            if too_long:
                extra = f" + draft_len ({scratch})" if self.spec is not None else ""
                why = (" — the verify forward needs draft_len rows of scratch headroom"
                       if self.spec is not None else " — the KV cache would overflow mid-decode")
                raise ValueError(
                    f"request {req.rid}: prompt ({len(prompt)}) + max_new ({req.max_new}){extra} "
                    f"exceeds max_len ({self.max_len}){why}"
                )
            return None
        if prompt.size == 0:
            return "empty_prompt"
        if too_long:
            return "too_long"
        return None

    def _resolve_deadline(self, req: Request) -> Optional[float]:
        """The deadline this run enforces for ``req``: its own, else the
        resilience default. The Request is never written."""
        if req.deadline_s is not None:
            return req.deadline_s
        res = self.resilience
        return res.default_deadline_s if res is not None else None

    def _deadline(self, req: Request) -> Optional[float]:
        """Run-local resolved deadline (run-relative seconds); the request's
        own field for rids this run never registered."""
        return self._deadlines.get(req.rid, req.deadline_s)

    def _emit(self, req: Request, toks, margins) -> None:
        req.generated.extend(int(t) for t in toks)
        req.margins.extend(float(m) for m in margins)
        if len(toks):
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
        owned, local = self._slot_home(slot)
        for name, value in (("plen", plen), ("slot", local), ("key", threefry.prng_key(seed)),
                            ("temp", req.temperature), ("max_new", req.max_new)):
            args[name].fill(value)
        tree, point = self._serving_tree(), self._serving_point()
        bucket = bucket_length(plen, self.max_len)
        graph = program_name(f"prefill {bucket}" if self.batched_prefill else "prefill step",
                             point)
        obs = self.observer
        if self._builds(graph, ("prefill", bucket)) and obs is not None:
            obs.compile_event("prefill", bucket=bucket)
        if obs is not None:
            obs.prefill_begin(req.rid, bucket, point)
        if self.batched_prefill:
            out = self._bucketed_prefill(prompt, tree, point, owned)
        else:
            out = self._scan_prefill(prompt, tree, point, owned)
        self.prefill_calls += 1
        self.host_transfers += 1
        req.generated, req.margins = [], []
        self._emit(req, out[0].tolist(), out[1].tolist())
        self._slot_start[slot] = plen
        self._slot_tok[slot], self._slot_count[slot] = req.generated[0], 1
        self._slot_temp[slot] = req.temperature
        if obs is not None:
            obs.prefill_end(req.rid, plen, point)
        if self.telemetry is not None:
            self.telemetry.record_prefill(point, plen)
        self.prefill_seconds += time.perf_counter() - t0

    def _slot_home(self, slot: int) -> Tuple[bool, int]:
        """(whether this rank holds global slot ``slot``, its local index)."""
        if self._data_shards == 1:
            return True, slot
        owner, local = divmod(slot, self._local_slots)
        return owner == self.mesh.coord("data"), local

    def _bucketed_prefill(self, prompt: np.ndarray, tree, point,
                          owned: bool = True) -> torch.Tensor:
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
            tok, margin = self._prefill(tree, cache, state, tokens.device_buf, a["plen"],
                                        a["slot"], a["key"], a["temp"], a["max_new"], owned)
            return torch.stack([tok.reshape(1).to(torch.float32), margin])

        return self.programs.run(program_name(f"prefill {bucket}", point), program, self.cache,
                                 self._state, inputs=[tokens, *args.values()])

    def _scan_prefill(self, prompt: np.ndarray, tree, point, owned: bool = True) -> torch.Tensor:
        tokens, args = self._scan_prompt, self._args
        padded = np.zeros((1, self.max_len), np.int32)
        padded[0, :len(prompt)] = prompt
        tokens.fill(padded)

        def step(row, scan):
            self._scan_step(tree, row, scan, tokens.device_buf)

        for j in range(len(prompt)):
            self.programs.run(program_name("prefill step", point), step, self._row, self._scan,
                              inputs=[tokens] if j == 0 else ())
            self.prefill_steps += 1
        return self._run_scan_finish(owned)

    def _run_scan_finish(self, owned: bool = True) -> torch.Tensor:
        args = self._args

        def finish(cache, state):
            a = {name: s.device_buf for name, s in args.items()}
            tok, margin = self._scan_finish(cache["slots"], state["slots"], cache["row"],
                                            state["scan"], a["slot"], a["key"], a["temp"],
                                            a["max_new"], owned)
            return torch.stack([tok.reshape(1).to(torch.float32), margin])

        # the row and the scan state go in with the slot cache and state, so
        # that a graph's warm-up runs on copies of all of them; the finish
        # reads no weights, so one graph serves every point
        return self.programs.run("prefill finish", finish,
                                 {"slots": self.cache, "row": self._row},
                                 {"slots": self._state, "scan": self._scan},
                                 inputs=list(args.values()))

    # -- chunked prefill: the streaming frontend's prefill programs -------------

    def chunk_fns(self):
        """The chunked-prefill programs ``(chunk, admit)``, the streaming
        frontend's prefill hot path; ``run()`` never calls them.

        ``chunk(prompt, start, n)`` advances the prefill carry by rows
        ``[start, start + n)`` of ``prompt`` (an int32 array), at the serving
        point: for the attention/MLA families one captured graph a chunk
        bucket and point, ``"prefill_chunk <Cb> @<point>"``
        (:func:`make_prefill_chunk`, rows and bucket by :meth:`chunk_span`);
        for the recurrent families the scan prefill's step graph, replayed
        once per row. ``admit(slot, req) ->
        (tok, margin)`` finishes the prefill (:func:`make_chunk_admit`; the
        recurrent families' scan finish): the chunked prefill's one
        transfer, a graph that reads no weights.

        The frontend prefills one request at a time, so one static carry
        serves every job: a private ``(1, max_len)`` row cache and a ``(1,
        V)`` last-logits buffer (the scan prefill's own for the recurrent
        families), made here, before any capture, and zeroed in place by
        :meth:`fresh_row`. A chunk's tokens, start and length go in
        through ``Staged`` buffers."""
        if self._chunk_fns is None:
            if getattr(self, "mesh", None) is not None:
                raise ValueError("chunked prefill is single-device for now: the streaming "
                                 "frontend rejects mesh= (ROADMAP: sharded streaming)")
            if self.batched_prefill:
                self._prefill_chunk = make_prefill_chunk(self.model, self.ctx)
                self._chunk_admit = make_chunk_admit()
                self._chunk_row = self.model.make_cache(1, self.max_len, dtype=torch.float32,
                                                        device=self.device)
                self._chunk_last = torch.zeros((1, self.model.cfg.vocab_size),
                                               dtype=torch.float32, device=self.device)
                self._args["start"] = self.programs.staged((), torch.int32)
                self._chunk_fns = (self._attn_chunk, self._attn_admit)
            else:
                self._scan_chunk_step = make_scan_chunk(self.model, self.ctx)
                # the job's prompt rows so far, the scan prompt buffer's host image
                self._scan_tokens = np.zeros((1, self.max_len), np.int32)
                self._chunk_fns = (self._scan_chunk, self._scan_admit)
        return self._chunk_fns

    def chunk_span(self, plen: int, start: int, n: int) -> Tuple[int, int]:
        """Where prompt rows ``[start, start + n)`` of a ``plen``-row prompt
        run as one chunk: ``(first, bucket)``, the chunk program's first row
        and its power-of-two row count. Two rules keep each row the one the
        monolithic prefill computes:

        * a prompt whose own bucket reaches the cache attention's
          tensor-core rows (``_TC_ROWS``) runs every chunk at least that
          wide, so each of its rows is computed on the tensor cores, as
          run()'s bucket computes it; on split keys its bits would differ
          by ulps, and in kernel mode an ulp can move an FxP8 activation a
          grid step and so the stream;
        * the chunk ends within the row cache: where ``start + bucket``
          would pass ``max_len``, it starts at ``max_len - bucket`` and
          recomputes committed rows (the KV write would otherwise clamp its
          start and shift every row of the chunk onto its neighbour's).

        The recurrent families step once a row: ``(start, bucket_length(n))``."""
        bucket = bucket_length(n, self.max_len)
        if not self.batched_prefill:
            return start, bucket
        if bucket_length(plen, self.max_len) >= _TC_ROWS:
            bucket = max(bucket, _TC_ROWS)
        return min(start, self.max_len - bucket), bucket

    def fresh_row(self):
        """Zero the prefill carry in place for a new job and return it, ``(row
        cache, last logits)``: the reference starts each prefill from a fresh
        cache (a job cancelled mid-prefill leaves its rows behind)."""
        self.chunk_fns()
        if self.batched_prefill:
            row, carry = self._chunk_row, {"last": self._chunk_last}
        else:
            row, carry = self._row, self._scan
        self.programs.eager(lambda: (_zero(row), _zero(carry)))
        return row, (self._chunk_last if self.batched_prefill else self._scan["last"])

    def _fill_admit_args(self, slot: int, req: Request) -> None:
        seed = req.seed if req.seed is not None else req.rid
        for name, value in (("slot", slot), ("key", threefry.prng_key(seed)),
                            ("temp", req.temperature), ("max_new", req.max_new)):
            self._args[name].fill(value)

    @torch.no_grad()
    def _attn_chunk(self, prompt: np.ndarray, start: int, n: int) -> None:
        first, bucket = self.chunk_span(len(prompt), start, n)
        rows = prompt[first:start + n]
        tree, point = self._serving_tree(), self._serving_point()
        if bucket not in self._prompts:
            self._prompts[bucket] = self.programs.staged((1, bucket), torch.int32)
        buf, args = self._prompts[bucket], self._args
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(rows)] = rows
        buf.fill(padded)
        args["start"].fill(first)
        args["plen"].fill(len(rows))  # the chunk's real rows

        def program(row, carry):
            self._prefill_chunk(tree, row, carry["last"], buf.device_buf,
                                args["start"].device_buf, args["plen"].device_buf)

        self.programs.run(program_name(f"prefill_chunk {bucket}", point), program,
                          self._chunk_row, {"last": self._chunk_last},
                          inputs=[buf, args["start"], args["plen"]])
        self.prefill_chunks += 1

    @torch.no_grad()
    def _attn_admit(self, slot: int, req: Request):
        self._fill_admit_args(slot, req)
        args = self._args

        def admit(cache, state):
            a = {name: s.device_buf for name, s in args.items()}
            tok, margin = self._chunk_admit(cache["slots"], state["slots"], cache["row"],
                                            state["last"], a["slot"], a["key"], a["temp"],
                                            a["max_new"])
            return torch.stack([tok.reshape(1).to(torch.float32), margin])

        out = self.programs.run("prefill admit", admit,
                                {"slots": self.cache, "row": self._chunk_row},
                                {"slots": self._state, "last": self._chunk_last},
                                inputs=[args[k] for k in ("slot", "key", "temp", "max_new")])
        return self._admitted(slot, req, out)

    @torch.no_grad()
    def _scan_chunk(self, prompt: np.ndarray, start: int, n: int) -> None:
        tree, point = self._serving_tree(), self._serving_point()
        self._scan_tokens[0, start:start + n] = prompt[start:start + n]
        buf = self._scan_prompt
        buf.fill(self._scan_tokens)

        def step(row, scan):
            self._scan_chunk_step(tree, row, scan, buf.device_buf)

        for j in range(n):
            self.programs.run(program_name("prefill step", point), step, self._row, self._scan,
                              inputs=[buf] if j == 0 else ())
            self.prefill_steps += 1

    @torch.no_grad()
    def _scan_admit(self, slot: int, req: Request):
        self._fill_admit_args(slot, req)
        return self._admitted(slot, req, self._run_scan_finish())

    def _admitted(self, slot: int, req: Request, out: torch.Tensor):
        self._slot_start[slot] = len(req.prompt)
        self._slot_tok[slot], self._slot_count[slot] = int(out[0, 0]), 1
        self._slot_temp[slot] = req.temperature
        return int(out[0, 0]), float(out[1, 0])

    @torch.no_grad()
    def _burst_round(self, slot_of: Dict[int, int]) -> Dict:
        """One decode burst over all slots, one program and one transfer;
        each active slot's run is clipped to its budget on the host, and a
        flagged lane's (with fault isolation) to the steps before its first
        flagged logit. Returns the round summary the scheduler acts on: the
        point it ran at, the tokens emitted, the engine steps, the min top-2
        margin over the clean committed tokens and the rids whose lanes
        faulted."""
        t0 = time.perf_counter()
        obs = self.observer
        if self.injector is not None:
            self.injector.before_round(self, self._round_idx, slot_of)
        self._round_idx += 1
        sampled = any(r.temperature > 0.0 for r in self.active.values())
        burst_fn = self._bursts[sampled]
        tree, point = self._serving_tree(), self._serving_point()
        name = program_name(f"burst {'sampled' if sampled else 'greedy'}", point)
        if self._builds(name, ("burst", sampled)) and obs is not None:
            obs.compile_event("burst", sampled=sampled)
        if obs is not None:
            obs.burst_begin(point)

        def program(cache, state):
            toks, margins, faults = burst_fn(tree, cache, state)
            out = torch.stack([toks.to(torch.float32), margins, faults.to(torch.float32)])
            return self._gather_slots(out, dim=1)

        out = self.programs.run(name, program, self.cache, self._state).numpy()
        self.decode_steps += self.burst
        self.host_transfers += 1
        toks, margins, faults = out[0], out[1], out[2] > 0
        isolate = self.resilience is not None and self.resilience.fault_isolation
        emitted, burst_margins = 0, []
        by_rid: Dict[int, List[int]] = {}
        faulted: List[int] = []
        for rid, req in self.active.items():
            s = slot_of[rid]
            n = min(self.burst, req.max_new - len(req.generated))
            if isolate and faults[s].any():
                # the flag is cumulative: the clean steps are its leading
                # False run; everything from the first flagged logit on is
                # discarded
                n = min(n, int((~faults[s]).sum()))
                faulted.append(rid)
            by_rid[rid] = [int(t) for t in toks[s, :n]]
            self._emit(req, toks[s, :n], margins[s, :n])
            self._slot_start[s] += n
            emitted += n
            if rid not in faulted:
                burst_margins.append(float(margins[s, :n].min()))
        if obs is not None:
            obs.burst_end(point, self.burst, by_rid)
        self.decode_seconds += time.perf_counter() - t0
        return {"point": point, "emitted": emitted, "steps": self.burst,
                "min_margin": min(burst_margins) if burst_margins else None,
                "faulted": faulted, "fault_reason": "decode_nonfinite"}

    def _gather_slots(self, out: torch.Tensor, dim: int) -> torch.Tensor:
        """Per-slot outputs of the local slots -> of every slot, in global
        slot order (an all-gather over ``data``; the input where the slots
        are not split)."""
        if self._data_shards == 1:
            return out
        from repro_torch.sharding.collectives import all_gather

        return all_gather(out, self.mesh, "data", dim=dim)

    @torch.no_grad()
    def collective_snapshot(self) -> Optional[Dict]:
        """Collective traffic of one greedy decode burst at the serving tree,
        the mesh-serving cost block a trace header carries
        (``{"collective_bytes", "collective_by_kind"}``, result bytes by the
        reference's kinds); None without a mesh. The burst runs on copies of
        the cache and slot state, so serving state is untouched; every rank
        must call it (the burst's collectives span them all)."""
        if self.mesh is None:
            return None
        from repro_torch.sharding import collectives

        cache = _clone(self.cache)
        state = _clone(self._state)
        collectives.reset_counts()
        out = self._bursts[False](self._serving_tree(), cache, state)
        self._gather_slots(torch.stack([out[0].to(torch.float32), out[1],
                                        out[2].to(torch.float32)]), dim=1)
        snap = collectives.counts()
        collectives.reset_counts()
        return snap

    @torch.no_grad()
    def _spec_round(self, slot_of: Dict[int, int]) -> Dict:
        """One draft-k-then-verify round over the active slots, one transfer.

        Each active request gains between 1 and ``draft_len + 1`` tokens,
        clipped to its ``max_new``; the cache comes back rolled back to the
        committed length a slot, and each slot's pending token and count are
        set on the host, to go in with the next round's uploads.

        With fault isolation, from the flags of the round's one transfer: a
        *draft*-faulted lane already fell back to the verify point's
        position-0 distribution inside the verify (no draft accepted, the
        accurate rows written over the drafted ones): it commits normally
        and stays admitted. A *verify*-faulted lane commits nothing and the
        scheduler quarantines it."""
        t0 = time.perf_counter()
        obs = self.observer
        if self.injector is not None:
            self.injector.before_round(self, self._round_idx, slot_of)
        self._round_idx += 1
        draft_point = self.controller.point if self.controller is not None else None
        if obs is not None:
            obs.burst_begin(draft_point or self.spec.default_draft_point, kind="spec")
        # the all-greedy variants only where no slot, active or not, samples:
        # a drained slot still drafts, as in the reference's round
        emitted, accepted, margins, draft_fault, verify_fault, point = self.spec.round(
            self._slot_tok, self.cache, self._state, self._slot_count, self._slot_start,
            draft_point=draft_point, sampled=bool((self._slot_temp > 0.0).any()))
        self.host_transfers += 1
        self.spec_rounds += 1
        self.decode_steps += self.spec.draft_len
        isolate = self.resilience is not None and self.resilience.fault_isolation
        accs, emits, round_margins = [], [], []
        by_rid: Dict[int, List[int]] = {}
        faulted: List[int] = []
        draft_faults: List[int] = []
        for rid, req in self.active.items():
            s = slot_of[rid]
            if isolate and bool(verify_fault[s]):
                by_rid[rid] = []
                faulted.append(rid)
                continue
            if isolate and bool(draft_fault[s]):
                draft_faults.append(rid)
            n = min(int(accepted[s]) + 1, req.max_new - len(req.generated))
            by_rid[rid] = [int(t) for t in emitted[s, :n]]
            self._emit(req, emitted[s, :n], margins[s, :n])
            self._slot_start[s] += int(accepted[s]) + 1
            accs.append(int(accepted[s]))
            emits.append(n)
            round_margins.append(float(margins[s, :n].min()))
            self._slot_tok[s], self._slot_count[s] = emitted[s, n - 1], len(req.generated)
        if obs is not None:
            extra = {"draft_faults": draft_faults} if draft_faults else {}
            obs.burst_end(point, self.spec.draft_len + 1, by_rid, kind="spec",
                          accepted=accs, **extra)
        self.spec.telemetry.record_round(point, self.spec.verify_point, accs, emits)
        self.decode_seconds += time.perf_counter() - t0
        # a round is draft_len single-token steps and one multi-token verify:
        # that is what the budget EMA and decode_steps cover
        return {"point": point, "emitted": sum(emits), "steps": self.spec.draft_len + 1,
                "min_margin": min(round_margins) if round_margins else None,
                "faulted": faulted, "fault_reason": "verify_nonfinite"}

    def _observe(self, point, tokens, steps, queue_depth, free_slots, min_margin,
                 deadline_misses=0, shed=0):
        from repro_torch.runtime import StepSignals

        self.telemetry.record_burst(point, tokens=tokens, steps=steps, min_margin=min_margin)
        self.controller.observe(StepSignals(
            active=len(self.active),
            queue_depth=queue_depth,
            free_slots=free_slots,
            min_margin=min_margin,
            steps=steps,
            deadline_misses=deadline_misses,
            shed=shed,
        ))

    def _telemetry_records(self) -> List[Dict]:
        """The unified telemetry records (``to_dict`` shape) this run holds."""
        recs = []
        if self.telemetry is not None:
            recs.append(self.telemetry.to_dict())
        if self.spec_telemetry is not None:
            recs.append(self.spec_telemetry.to_dict())
        return recs

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve requests to completion; returns rid -> generated tokens.

        Per-token top-2 margins land on each request's ``.margins``. The
        counters, the telemetry, the controller, the speculative round
        counter, the outcomes and the observer all start fresh on every call
        (``_begin_run``), and ``snapshot()`` exports what one run
        accumulated, whether it completed or died mid-flight. With
        ``resilience`` the returned dict carries partial streams for expired
        and faulted requests and omits shed ones.
        """
        res = self.resilience
        shed_pre: List[Tuple[Request, str]] = []
        admitted: List[Request] = []
        # deadlines resolve into run-local state, never onto the caller's
        # Request objects
        deadlines = {req.rid: self._resolve_deadline(req) for req in requests}
        for req in requests:  # reject or shed before any state mutates
            reason = self._admission_error(req)
            if reason is not None:
                shed_pre.append((req, reason))
                continue
            admitted.append(req)
        if res is not None and res.queue_limit is not None:
            from repro_torch.resilience.outcome import shed_overflow

            admitted, dropped = shed_overflow(admitted, res.queue_limit, res.shed_policy,
                                              deadline_of=lambda r: deadlines[r.rid])
            shed_pre.extend((r, "queue_full") for r in dropped)
        self._begin_run(requests)
        self._deadlines = deadlines
        obs = self.observer
        for req, reason in shed_pre:
            self._shed(req, reason)
        aborted = True
        try:
            queue = list(admitted)
            results: Dict[int, List[int]] = {}
            slot_of: Dict[int, int] = {}
            free = list(range(self.slots))
            shed_since = len(shed_pre)  # sheds since the last controller observation
            while queue or self.active:
                if res is not None:  # shed queued work that can no longer win
                    queue, n_shed = self._expire_queue(queue)
                    shed_since += n_shed
                while queue and free:
                    req, slot = queue.pop(0), free.pop(0)
                    if obs is not None:
                        obs.request_admitted(req.rid, slot)
                    self._prefill_slot(slot, req)
                    self._after_prefill(slot, req, results, slot_of, free)
                if not self.active:
                    continue
                queue_depth, free_slots = len(queue), len(free)
                if self.spec is not None:
                    summary = self._spec_round(slot_of)
                else:
                    summary = self._burst_round(slot_of)
                misses = self._settle_round(summary, results, slot_of, free)
                if self.controller is not None:
                    self._observe(summary["point"], summary["emitted"], summary["steps"],
                                  queue_depth, free_slots, summary["min_margin"],
                                  deadline_misses=misses, shed=shed_since)
                    shed_since = 0
            aborted = False
        finally:
            self._end_run(aborted)
        return results

    # -- per-round bookkeeping --------------------------------------------------

    def _after_prefill(self, slot: int, req: Request, results: Dict,
                       slot_of: Dict[int, int], free: List[int]) -> None:
        """Post-prefill triage: quarantine a non-finite prefill, retire a
        request whose budget the prefill token already satisfied, otherwise
        activate the slot."""
        res = self.resilience
        if res is not None and res.fault_isolation and not math.isfinite(req.margins[0]):
            # non-finite prefill logits: the sampled token is garbage;
            # quarantine before anything is committed (the slot's rows are
            # written over at its next admission)
            req.generated, req.margins = [], []
            results[req.rid] = req.generated
            self._finish(req, "faulted", reason="prefill_nonfinite")
            free.append(slot)
            return
        if len(req.generated) >= req.max_new:  # prefill already done
            results[req.rid] = req.generated
            self._finish(req, "ok")
            free.append(slot)
            return
        self.active[req.rid] = req
        slot_of[req.rid] = slot

    def _settle_round(self, summary: Dict, results: Dict, slot_of: Dict[int, int],
                      free: List[int]) -> int:
        """After one burst or speculative round: quarantine faulted lanes,
        evict deadline misses (on host time, after the round's transfer),
        retire finished requests. Returns the number of deadline misses (the
        controller's signal)."""
        for rid in summary["faulted"]:
            req = self.active.pop(rid)
            results[rid] = req.generated
            self._finish(req, "faulted", reason=summary["fault_reason"])
            free.append(slot_of.pop(rid))
        misses = 0
        if self.resilience is not None:
            now = time.perf_counter() - self._t0
            for rid, req in list(self.active.items()):
                d = self._deadline(req)
                if d is not None and now >= d:
                    self.active.pop(rid)
                    results[rid] = req.generated
                    self._finish(req, "expired", reason="deadline")
                    free.append(slot_of.pop(rid))
                    misses += 1
        for rid in [r for r, q in self.active.items() if len(q.generated) >= q.max_new]:
            req = self.active.pop(rid)
            results[rid] = req.generated
            self._finish(req, "ok")
            free.append(slot_of.pop(rid))
        return misses

    # -- resilience: outcome bookkeeping ----------------------------------------

    def _finish(self, req: Request, status: str, reason: Optional[str] = None) -> None:
        """Record the terminal outcome of an admitted request."""
        from repro_torch.resilience.outcome import RequestOutcome

        tokens = len(req.generated or [])
        self.outcomes[req.rid] = RequestOutcome(
            rid=req.rid, status=status, reason=reason, tokens=tokens,
            deadline_s=self._deadline(req), wall_s=time.perf_counter() - self._t0)
        obs = self.observer
        if status == "ok":
            if obs is not None:
                obs.request_completed(req.rid)
        elif status == "expired":
            self._fault_counts["expired"] += 1
            self._fault_counts["deadline_misses"] += 1
            if obs is not None:
                obs.request_expired(req.rid, tokens)
        elif status == "aborted":
            # a streaming-frontend cancellation or shutdown; run() itself
            # never produces this status
            self._fault_counts["aborted"] = self._fault_counts.get("aborted", 0) + 1
            if obs is not None:
                obs.request_cancelled(req.rid, tokens)
        else:
            self._fault_counts["faulted"] += 1
            if obs is not None:
                obs.request_faulted(req.rid, tokens, reason)

    def _shed(self, req: Request, reason: str) -> None:
        """Record a request rejected at admission (it never held a slot)."""
        from repro_torch.resilience.outcome import RequestOutcome

        self.outcomes[req.rid] = RequestOutcome(
            rid=req.rid, status="shed", reason=reason, tokens=0,
            deadline_s=self._deadline(req), wall_s=time.perf_counter() - self._t0)
        self._fault_counts["shed"] += 1
        if self.observer is not None:
            self.observer.request_shed(req.rid, reason)

    def _expire_queue(self, queue: List[Request]):
        """Shed queued requests whose deadline already passed: admitting them
        would spend a prefill on work that cannot finish in time."""
        now = time.perf_counter() - self._t0
        kept, n_shed = [], 0
        for req in queue:
            d = self._deadline(req)
            if d is not None and now >= d:
                self._shed(req, "deadline_expired")
                n_shed += 1
            else:
                kept.append(req)
        return kept, n_shed

    # -- run lifecycle: symmetric reset / export --------------------------------

    def _begin_run(self, requests: List[Request]) -> None:
        """Reset every per-run accumulator ``snapshot()`` exports. Slots
        stranded by an aborted earlier run are dropped here (their rows are
        written over at the next admission)."""
        self._reset_counters()
        self.active.clear()
        self.outcomes = {}
        self._round_idx = 0
        self._fault_counts = {"shed": 0, "expired": 0, "faulted": 0, "deadline_misses": 0}
        self._deadlines = {}
        self._run_requests = list(requests)
        if self.telemetry is not None:
            self.telemetry.reset()
        if self.controller is not None:
            self.controller.reset()
            self.controller.on_switch = (self.observer.controller_switch
                                         if self.observer is not None else None)
        if self.spec is not None:
            self.spec.reset()
            self.spec.observer = self.observer
        self._run_complete = False
        if self.observer is not None:
            self.observer.run_begin(self._run_meta(), requests)

    def _end_run(self, aborted: bool) -> None:
        self._run_complete = not aborted
        if aborted:
            # every request the run touched but never resolved gets an
            # ``aborted`` outcome with its partial token count
            from repro_torch.resilience.outcome import RequestOutcome

            wall = time.perf_counter() - self._t0
            for req in self._run_requests:
                if req.rid not in self.outcomes:
                    self.outcomes[req.rid] = RequestOutcome(
                        rid=req.rid, status="aborted", tokens=len(req.generated or []),
                        deadline_s=self._deadline(req), wall_s=wall)
        if self.observer is not None:
            self.observer.run_end(aborted, self.host_transfers, self._telemetry_records())

    def _run_meta(self) -> Dict:
        """The trace header's metadata for one run."""
        meta = {
            "family": self.model.cfg.family,
            "mode": self.ctx.mode,
            "slots": self.slots,
            "burst": self.burst,
            "max_len": self.max_len,
            "adaptive": self.controller is not None,
            "speculative": self.spec is not None,
        }
        if self.spec is not None:
            meta["draft_len"] = self.spec.draft_len
            meta["verify_point"] = self.spec.verify_point
        if self.resilience is not None:
            meta["resilience"] = {
                "queue_limit": self.resilience.queue_limit,
                "shed_policy": self.resilience.shed_policy,
                "fault_isolation": self.resilience.fault_isolation,
                "default_deadline_s": self.resilience.default_deadline_s,
            }
        if self._frontend_meta is not None:
            meta["frontend"] = dict(self._frontend_meta)
        if self.shardings is not None:
            meta["sharding"] = self.shardings.snapshot()
        engine = self._engine_cost_meta()
        if engine is not None:
            meta["engine"] = engine
        return meta

    def _engine_cost_meta(self) -> Optional[Dict]:
        """The trace header's ``engine`` block: per-point cycle estimates and
        the per-weight (shape, depth, bits) table, what the reference's
        PE-array simulator replays a trace with. Computed once per server."""
        if not hasattr(self, "_engine_meta_cache"):
            from repro_torch.runtime.telemetry import estimate_point_cycles, layer_cost_table

            specs = self.model.specs()
            if self._bank is not None:
                bank = self._bank
                policies = {p.name: p.policy for p in bank.points}
                self._engine_meta_cache = {
                    "points": {n: bank.cycles_per_token[n] for n in bank.names},
                    "reference": bank.reference,
                    "cycle_model": bank.cycle_model,
                    "layers": layer_cost_table(bank.tree(bank.reference), policies, specs=specs),
                }
            elif self.ctx.mode != "exact" and self.ctx.policy is not None:
                # static prepared serving: a single-point "bank"
                self._engine_meta_cache = {
                    "points": {"static": estimate_point_cycles(self.params, self.ctx.policy,
                                                               specs=specs)},
                    "reference": "static",
                    "cycle_model": "analytic",
                    "layers": layer_cost_table(self.params, {"static": self.ctx.policy},
                                               specs=specs),
                }
            else:
                self._engine_meta_cache = None
        return self._engine_meta_cache

    def snapshot(self) -> Dict:
        """Everything one ``run()`` accumulated, as one JSON-able record:
        ``completed`` is False for a run that died mid-flight and None if the
        server never ran."""
        return {
            "completed": self._run_complete,
            "host_transfers": self.host_transfers,
            "telemetry": self._telemetry_records(),
            "observability": (self.observer.snapshot()
                              if self.observer is not None else None),
            "resilience": {
                "outcomes": {rid: o.to_dict() for rid, o in self.outcomes.items()},
                "counters": dict(self._fault_counts),
            },
        }


def _check_mesh(cfg, mesh, device, capture: bool) -> None:
    """Refuse, naming its ROADMAP item, what mesh serving does not cover."""
    del cfg, mesh
    if capture and device.type == "cuda":
        raise ValueError(
            "capture=True with a mesh: gloo collectives cannot be captured in a CUDA graph; "
            "pass capture=False (captured NCCL collectives need a machine with more than "
            "one card, ROADMAP Queue 1)")


def _serving_shardings(server, mesh):
    """The placement the server keeps: the reference's rules
    (``serving_shardings`` on the whole cache's shapes) over the port's
    serving specs (``partition.serving_specs``), but an MLA latent cache
    whole on every rank of the model axis (the port's MLA runs its local
    heads against the whole latent), and so a GQA cache whose kv heads do
    not divide the model axis: the reference's rules put its head_dim over
    ``model`` there (the earliest other dim that divides); the port keeps
    the whole kv heads on every model rank, with the slots over ``data``, a
    port choice that moves no bits (each rank's q heads read their kv heads
    in place) and saves a gather of the cache rows a step. The scan
    families' caches are described as the port stores them, from their
    shapes: a dim is over ``data`` where a rank holds fewer slots, over
    ``model`` where it holds fewer heads (the SSM state's and the attention
    caches' heads; a conv window is whole on every rank)."""
    from repro_torch.sharding import partition

    cfg, model = server.model.cfg, server.model
    tree = server._bank.tree(server._bank.names[0]) if server._bank is not None else \
        server.params
    full_cache = model.make_cache(server.slots, server.max_len, device="meta")
    full_state = _init_slot_state(server.slots, "meta")
    sh = partition.serving_shardings(mesh, params=tree, cache=full_cache, state=full_state,
                                     specs=model.serving_specs(), cfg=cfg,
                                     max_len=server.max_len)

    whole_kv = cfg.mla or cfg.num_kv_heads % mesh.size("model") != 0

    def cache_entry(spec):
        if isinstance(spec, dict):
            return {k: cache_entry(v) for k, v in spec.items()}
        if whole_kv:
            spec = tuple(None if e == "model" else e for e in spec)
            while spec and spec[-1] is None:
                spec = spec[:-1]
        return spec

    def stored(whole, heads, local):
        if isinstance(whole, dict):
            return {k: stored(whole[k], heads[k], local[k]) for k in whole}
        spec = [None] * whole.ndim
        for i, (a, b, c) in enumerate(zip(whole.shape, heads.shape, local.shape)):
            if c < b:
                spec[i] = "data"
            elif b < a:
                spec[i] = "model"
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    if server.batched_prefill:
        sh.cache = cache_entry(sh.cache)
    else:
        heads = model.make_cache(server.slots, server.max_len, device="meta", mesh=mesh)
        local = model.make_cache(server._local_slots, server.max_len, device="meta", mesh=mesh)
        sh.cache = stored(full_cache, heads, local)
    return sh


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
