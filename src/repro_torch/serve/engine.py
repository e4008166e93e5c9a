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
  token at that point.

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
Resilience (and with it the slot state's fault flag), observability and mesh
serving are not yet ported: the speculative round's fault flags are computed
and transferred, and nothing acts on them, as in the reference without
``resilience``.
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

    ``controller`` (a ``runtime.ModeController``) serves runtime-adaptive
    precision from its bank; ``params`` may then stay raw (they are not
    prepared), and ``telemetry`` accumulates the run's record.
    ``speculate`` (a ``spec.SpecConfig``) serves self-speculative rounds
    from ``bank`` (default: the controller's bank), which must hold trees on
    ``device``; with a controller, it picks the draft point a round.
    ``spec_rounds`` counts the rounds of the last run (one verify forward
    and one transfer each; ``decode_steps`` then counts the draft steps).
    """

    def __init__(self, model: ModelApi, ctx: EngineContext, params, slots: int = 4,
                 max_len: int = 256, burst: int = 8, device=None, prepare_weights: bool = True,
                 capture: bool = True, controller=None, bank=None, speculate=None):
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.model, self.ctx = model, ctx
        self.slots, self.max_len, self.burst = slots, max_len, burst
        self.device = resolve_device(device)
        self.controller, self.speculate = controller, speculate
        self._bank = bank if bank is not None or controller is None else controller.bank
        params = _to_device(params, self.device)
        self.telemetry = None
        if controller is not None:
            from repro_torch.runtime import TelemetryRecorder

            self.telemetry = TelemetryRecorder.for_bank(controller.bank)
        elif prepare_weights and speculate is None:
            params = prepare_params(params, ctx.policy, ctx.mode, specs=model.specs())
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
        self.cache = model.make_cache(slots, max_len, dtype=torch.float32, device=self.device)
        self._state = _init_slot_state(slots, self.device)
        self.programs = GraphRunner(self.device, capture)
        self.spec = self.spec_telemetry = None
        if speculate is not None:
            from repro_torch.spec import SpeculativeDecoder

            self.spec = SpeculativeDecoder(model, ctx, self._bank, speculate,
                                           programs=self.programs)
            self.spec_telemetry = self.spec.telemetry
        # host views of each slot's committed KV rows and, for the
        # speculative rounds, its pending token and generated count (uploaded)
        # and its temperature (which picks a round's variant)
        self._slot_start = np.zeros((slots,), np.int32)
        self._slot_tok = np.zeros((slots,), np.int32)
        self._slot_count = np.zeros((slots,), np.int32)
        self._slot_temp = np.zeros((slots,), np.float32)
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

    def _admission_error(self, req: Request) -> None:
        prompt = _checked_prompt(req)
        scratch = self.spec.draft_len if self.spec is not None else 0
        if len(prompt) + req.max_new + scratch > self.max_len:
            extra = f" + draft_len ({scratch})" if self.spec is not None else ""
            why = (" — the verify forward needs draft_len rows of scratch headroom"
                   if self.spec is not None else " — the KV cache would overflow mid-decode")
            raise ValueError(
                f"request {req.rid}: prompt ({len(prompt)}) + max_new ({req.max_new}){extra} "
                f"exceeds max_len ({self.max_len}){why}"
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
        tree, point = self._serving_tree(), self._serving_point()
        if self.batched_prefill:
            out = self._bucketed_prefill(prompt, tree, point)
        else:
            out = self._scan_prefill(prompt, tree, point)
        self.prefill_calls += 1
        self.host_transfers += 1
        req.generated, req.margins = [], []
        self._emit(req, out[0].tolist(), out[1].tolist())
        self._slot_start[slot] = plen
        self._slot_tok[slot], self._slot_count[slot] = req.generated[0], 1
        self._slot_temp[slot] = req.temperature
        if self.telemetry is not None:
            self.telemetry.record_prefill(point, plen)
        self.prefill_seconds += time.perf_counter() - t0

    def _bucketed_prefill(self, prompt: np.ndarray, tree, point) -> torch.Tensor:
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
                                        a["slot"], a["key"], a["temp"], a["max_new"])
            return torch.stack([tok.reshape(1).to(torch.float32), margin])

        return self.programs.run(program_name(f"prefill {bucket}", point), program, self.cache,
                                 self._state, inputs=[tokens, *args.values()])

    def _scan_prefill(self, prompt: np.ndarray, tree, point) -> torch.Tensor:
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

        def finish(cache, state):
            a = {name: s.device_buf for name, s in args.items()}
            tok, margin = self._scan_finish(cache["slots"], state["slots"], cache["row"],
                                            state["scan"], a["slot"], a["key"], a["temp"],
                                            a["max_new"])
            return torch.stack([tok.reshape(1).to(torch.float32), margin])

        # the row and the scan state go in with the slot cache and state, so
        # that a graph's warm-up runs on copies of all of them; the finish
        # reads no weights, so one graph serves every point
        return self.programs.run("prefill finish", finish,
                                 {"slots": self.cache, "row": self._row},
                                 {"slots": self._state, "scan": self._scan},
                                 inputs=list(args.values()))

    @torch.no_grad()
    def _burst_round(self, slot_of: Dict[int, int]) -> Dict:
        """One decode burst over all slots, one program and one transfer;
        each active slot's run is clipped to its budget on the host. Returns
        the round summary the controller observes: the point it ran at, the
        tokens emitted, the engine steps and the min top-2 margin over the
        committed tokens."""
        t0 = time.perf_counter()
        sampled = any(r.temperature > 0.0 for r in self.active.values())
        burst_fn = self._bursts[sampled]
        tree, point = self._serving_tree(), self._serving_point()

        def program(cache, state):
            toks, margins = burst_fn(tree, cache, state)
            return torch.stack([toks.to(torch.float32), margins])

        name = program_name(f"burst {'sampled' if sampled else 'greedy'}", point)
        out = self.programs.run(name, program, self.cache, self._state).numpy()
        self.decode_steps += self.burst
        self.host_transfers += 1
        emitted, burst_margins = 0, []
        for rid, req in self.active.items():
            s = slot_of[rid]
            n = min(self.burst, req.max_new - len(req.generated))
            self._emit(req, out[0, s, :n], out[1, s, :n])
            emitted += n
            burst_margins.append(float(out[1, s, :n].min()))
        self.decode_seconds += time.perf_counter() - t0
        return {"point": point, "emitted": emitted, "steps": self.burst,
                "min_margin": min(burst_margins) if burst_margins else None}

    @torch.no_grad()
    def _spec_round(self, slot_of: Dict[int, int]) -> Dict:
        """One draft-k-then-verify round over the active slots, one transfer.

        Each active request gains between 1 and ``draft_len + 1`` tokens,
        clipped to its ``max_new``; the cache comes back rolled back to the
        committed length a slot, and each slot's pending token and count are
        set on the host, to go in with the next round's uploads."""
        t0 = time.perf_counter()
        draft_point = self.controller.point if self.controller is not None else None
        # the all-greedy variants only where no slot, active or not, samples:
        # a drained slot still drafts, as in the reference's round
        emitted, accepted, margins, _, _, point = self.spec.round(
            self._slot_tok, self.cache, self._state, self._slot_count, self._slot_start,
            draft_point=draft_point, sampled=bool((self._slot_temp > 0.0).any()))
        self.host_transfers += 1
        self.spec_rounds += 1
        self.decode_steps += self.spec.draft_len
        accs, emits, round_margins = [], [], []
        for rid, req in self.active.items():
            s = slot_of[rid]
            n = min(int(accepted[s]) + 1, req.max_new - len(req.generated))
            self._emit(req, emitted[s, :n], margins[s, :n])
            self._slot_start[s] += int(accepted[s]) + 1
            accs.append(int(accepted[s]))
            emits.append(n)
            round_margins.append(float(margins[s, :n].min()))
            self._slot_tok[s], self._slot_count[s] = emitted[s, n - 1], len(req.generated)
        self.spec.telemetry.record_round(point, self.spec.verify_point, accs, emits)
        self.decode_seconds += time.perf_counter() - t0
        # a round is draft_len single-token steps and one multi-token verify:
        # that is what the budget EMA and decode_steps cover
        return {"point": point, "emitted": sum(emits), "steps": self.spec.draft_len + 1,
                "min_margin": min(round_margins) if round_margins else None}

    def _observe(self, point, tokens, steps, queue_depth, free_slots, min_margin):
        from repro_torch.runtime import StepSignals

        self.telemetry.record_burst(point, tokens=tokens, steps=steps, min_margin=min_margin)
        self.controller.observe(StepSignals(
            active=len(self.active),
            queue_depth=queue_depth,
            free_slots=free_slots,
            min_margin=min_margin,
            steps=steps,
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
        counters, the telemetry, the controller and the speculative round
        counter all start fresh on every call."""
        for req in requests:  # reject before any state mutates
            self._admission_error(req)
        self._reset_counters()
        self.active.clear()
        if self.telemetry is not None:
            self.telemetry.reset()
        if self.controller is not None:
            self.controller.reset()
        if self.spec is not None:
            self.spec.reset()
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
            queue_depth, free_slots = len(queue), len(free)
            if self.spec is not None:
                summary = self._spec_round(slot_of)
            else:
                summary = self._burst_round(slot_of)
            for rid in [r for r, q in self.active.items() if len(q.generated) >= q.max_new]:
                results[rid] = self.active.pop(rid).generated
                free.append(slot_of.pop(rid))
            if self.controller is not None:
                self._observe(summary["point"], summary["emitted"], summary["steps"],
                              queue_depth, free_slots, summary["min_margin"])
        return results


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
