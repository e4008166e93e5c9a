"""Continuous-batching streaming frontend with chunked prefill (port of
``repro.serve.frontend``).

:class:`~repro_torch.serve.engine.BatchedServer.run` consumes a *fixed* request
list: admission happens only while that list drains, and every prefill runs
the whole prompt in one jitted call — a long prompt admitted next to a
decoding slot stalls that slot's token emission for the full prompt's wall
time. This module turns the same server into a streaming service:

* :class:`ContinuousScheduler` owns a live request queue. ``submit()`` is
  thread-safe and returns a :class:`StreamHandle` immediately; every
  ``step()`` (one *admission tick*) drains new arrivals and cancellations,
  re-runs the resilience sweeps (queued-deadline expiry and queue-limit
  shedding fire on EVERY tick, not just at run entry), runs at most one
  chunk budget of prefill, then one decode burst / speculative round over
  the active slots. Admission and eviction happen at every burst boundary —
  continuous batching in the vLLM sense, over the engine's existing slot
  discipline.

* **Chunked prefill** bounds how long any prompt can monopolize the device
  between bursts: instead of one whole-prompt forward, the prompt advances
  through the request's PRIVATE single-row cache at most
  ``chunk_tokens`` rows per tick (:func:`~repro_torch.serve.engine.
  make_prefill_chunk` — the per-query-causal mask plus the write-index
  rewind make a chunk attend exactly the rows the monolithic forward would
  give it; recurrent families chunk their scan with the state as the
  carry). Only the final chunk's admit program touches the shared slot cache
  and transfers anything to the host, so a 10-chunk prefill still costs one
  host round-trip. On the card each chunk bucket is a captured CUDA graph
  at each execution point and the admit one graph for all points
  (``BatchedServer.chunk_fns``). Greedy token streams are identical to the
  monolithic path (asserted per family in ``tests/test_torch_frontend.py``
  against the reference's frontend; on the card bit for bit, as each row
  runs on the attention kernel path run()'s bucket gives it); inter-token
  latency for slots decoding alongside is bounded by one chunk budget
  (asserted structurally: ``stats["max_prefill_rows_between_bursts"]``).

* Deadlines become *submit-relative*: the scheduler resolves each arrival's
  deadline (or the resilience default) against its submit timestamp into
  the server's run-local deadline table, so a request submitted late still
  gets its full allowance — and none of this ever writes to the caller's
  ``Request`` object.

* Cancellation: ``handle.cancel()`` (client disconnect) marks the request;
  the scheduler evicts it at the next tick boundary with outcome
  ``aborted`` / reason ``cancelled`` and its partial tokens. The slot is
  freed and reused with no telemetry leak — the same ``_begin_run`` /
  ``_end_run`` symmetry contract the batch path has.

:class:`AsyncFrontend` is the asyncio facade: the scheduler loops on a
daemon thread, ``await frontend.generate(req)`` / ``async for tok in
frontend.stream(req)`` bridge handles onto the event loop. The HTTP/stdin
drivers in ``launch/serve.py`` sit on top of it.

Sharded serving (``mesh=``) is not streamed yet — the scheduler rejects a
meshed server at construction (ROADMAP: sharded streaming). The scheduler is
host Python and the device work is the server's programs; the reference's
``jax.device_get`` of token 0 is the admit program's one ``.cpu()``
transfer.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .engine import BatchedServer, Request

__all__ = ["AsyncFrontend", "ContinuousScheduler", "FrontendConfig",
           "StreamHandle"]

_DONE = object()  # stream sentinel


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Streaming-frontend knobs.

    ``chunk_tokens`` is the prefill budget per admission tick: at most this
    many prompt rows run between consecutive decode bursts (each chunk is
    padded to a power-of-two bucket, at most the larger of the budget and
    the attention kernels' 16 tensor-core rows (``BatchedServer.chunk_span``),
    so chunked prefill
    compiles O(log chunk_tokens) extra programs). ``monolithic_prefill``
    disables chunking — each admission runs the whole prompt through the
    batch path's one-shot prefill (the contrast arm of the interleaving
    benchmark, and a fallback).
    """

    chunk_tokens: int = 32
    monolithic_prefill: bool = False

    def __post_init__(self):
        if self.chunk_tokens < 1:
            raise ValueError(
                f"chunk_tokens must be >= 1, got {self.chunk_tokens}")


class StreamHandle:
    """The caller's side of one streaming request.

    Tokens arrive incrementally: iterate the handle (blocking) or poll
    ``tokens``. ``result()`` blocks until the request settles and returns
    the full stream; ``outcome`` carries the structured
    :class:`~repro_torch.resilience.RequestOutcome` once settled. ``cancel()``
    requests eviction at the next tick boundary (client disconnect).
    All methods are safe to call from any thread.
    """

    def __init__(self, request: Request) -> None:
        self.request = request
        self.rid = request.rid
        self.tokens: List[int] = []
        self.outcome = None
        self._events: _queue.Queue = _queue.Queue()
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._sent = 0  # tokens already pushed (scheduler-side cursor)

    def cancel(self) -> None:
        """Ask the scheduler to evict this request at the next tick."""
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def status(self) -> Optional[str]:
        return self.outcome.status if self.outcome is not None else None

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until settled; returns the (possibly partial) stream."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not settled in {timeout}s")
        return list(self.tokens)

    def __iter__(self):
        """Yield tokens as they land; returns when the request settles."""
        while True:
            item = self._events.get()
            if item is _DONE:
                return
            yield item

    # -- scheduler side -------------------------------------------------------

    def _push(self, toks: List[int]) -> None:
        self.tokens.extend(toks)
        for t in toks:
            self._events.put(t)

    def _settle(self, outcome) -> None:
        self.outcome = outcome
        self._done.set()
        self._events.put(_DONE)


@dataclasses.dataclass
class _PrefillJob:
    """One in-flight chunked prefill: the request's private row cache and
    last-logits carry, plus the committed-row cursor."""

    req: Request
    slot: int
    prompt: np.ndarray
    row: object   # the server's static carry (BatchedServer.fresh_row)
    last: object
    done: int = 0


class ContinuousScheduler:
    """Continuous batching over one :class:`BatchedServer` (module docstring).

    Single-threaded engine discipline: every engine/observer call happens on
    the thread driving ``step()``; ``submit``/``cancel`` only touch a locked
    inbox and per-handle events, so any number of client threads can feed
    one scheduler. Use as a context manager (opens/closes the server's run
    lifecycle), or call ``open()`` / ``close()`` explicitly.
    """

    def __init__(self, server: BatchedServer,
                 config: Optional[FrontendConfig] = None) -> None:
        if getattr(server, "mesh", None) is not None:
            raise ValueError(
                "the streaming frontend is single-device for now — serve "
                "mesh= through run() (ROADMAP: sharded streaming)"
            )
        self.server = server
        self.config = config if config is not None else FrontendConfig()
        self._lock = threading.Lock()
        self._inbox: List = []          # (request, handle, wall_ts, reason)
        self._known: set = set()        # every rid ever submitted
        self.handles: Dict[int, StreamHandle] = {}
        self.queue: List[Request] = []
        self.results: Dict[int, List[int]] = {}
        self.slot_of: Dict[int, int] = {}
        self.free: List[int] = list(range(server.slots))
        self.job: Optional[_PrefillJob] = None
        self._open = False
        self._closed = False
        self._shed_since = 0            # sheds since last controller observe
        self._rows_since_burst = 0      # prefill rows stalling active slots
        self._chunk_buckets: set = set()
        self.stats = {
            "ticks": 0, "bursts": 0, "submitted": 0, "prefill_rows": 0,
            "max_prefill_rows_between_bursts": 0,
        }

    # -- lifecycle ------------------------------------------------------------

    def open(self) -> "ContinuousScheduler":
        """Begin the serving session (the server's run lifecycle: telemetry,
        observer, outcome state all reset — same contract as ``run()``)."""
        if self._open:
            return self
        if self._closed:
            raise RuntimeError("scheduler already closed; build a new one")
        cfg = self.config
        self.server._frontend_meta = {
            "chunk_tokens": cfg.chunk_tokens,
            "monolithic_prefill": cfg.monolithic_prefill,
        }
        self.server._begin_run([])
        self._open = True
        return self

    def close(self, aborted: bool = False) -> None:
        """End the session. A clean close resolves anything still in flight
        as ``aborted`` / ``shutdown`` (partial tokens kept) so every
        submitted request ends with exactly one outcome; ``aborted=True``
        lets ``_end_run``'s crashed-run attribution fill them instead."""
        if self._closed:
            return
        self._closed = True
        if not self._open:
            return
        server = self.server
        self._drain_inbox()
        if not aborted:
            for req in self.queue:
                server._finish(req, "aborted", reason="shutdown")
            self.queue = []
            if self.job is not None:
                server._finish(self.job.req, "aborted", reason="shutdown")
                self.free.append(self.job.slot)
                self.job = None
            for rid in list(server.active):
                req = server.active.pop(rid)
                self.results[rid] = req.generated
                server._finish(req, "aborted", reason="shutdown")
                self.free.append(self.slot_of.pop(rid))
        server._end_run(aborted)
        self._flush()
        for rid, handle in list(self.handles.items()):
            handle._settle(server.outcomes.get(rid))
            del self.handles[rid]
        self._open = False

    def __enter__(self) -> "ContinuousScheduler":
        return self.open()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(aborted=exc_type is not None)

    # -- client side ----------------------------------------------------------

    def submit(self, request: Request) -> StreamHandle:
        """Enqueue one request; returns its :class:`StreamHandle`.

        Thread-safe, non-blocking. With ``resilience=None`` invalid requests
        raise here, synchronously (the legacy fail-stop contract); with a
        :class:`ResilienceConfig` they are shed with a structured reason at
        the next tick. Deadlines are relative to this call.
        """
        if self._closed:
            raise RuntimeError("scheduler is closed")
        if not self._open:
            raise RuntimeError("scheduler is not open — use it as a context "
                               "manager or call open() first")
        reason = self.server._admission_error(request)  # raises when legacy
        handle = StreamHandle(request)
        with self._lock:
            if request.rid in self._known:
                raise ValueError(f"duplicate rid {request.rid}: streaming "
                                 "rids must be unique per session")
            self._known.add(request.rid)
            self._inbox.append((request, handle, time.perf_counter(), reason))
            self.stats["submitted"] += 1
        return handle

    @property
    def idle(self) -> bool:
        """No queued, in-prefill, or decoding work (new submissions may
        still arrive)."""
        with self._lock:
            inbox = bool(self._inbox)
        return not (inbox or self.queue or self.job is not None
                    or self.server.active)

    # -- scheduler loop -------------------------------------------------------

    def step(self) -> bool:
        """One admission tick. Returns False when there was nothing to do.

        Order: drain arrivals and cancellations, re-run the resilience
        sweeps over the queue, run at most ``chunk_tokens`` prefill rows,
        then one decode burst / speculative round, then stream the committed
        tokens out to their handles.
        """
        if not self._open or self._closed:
            raise RuntimeError("scheduler is not open")
        server = self.server
        did = self._drain_inbox()
        did = self._apply_cancellations() or did
        did = self._police_queue() or did
        if not (self.queue or self.job is not None or server.active):
            self._flush()
            return did
        obs = server.observer
        if obs is not None:
            obs.admission_tick(len(self.queue), len(server.active),
                               len(self.free))
        self.stats["ticks"] += 1
        active_before = bool(server.active)
        rows = self._prefill_tick()
        self.stats["prefill_rows"] += rows
        if active_before:
            # only rows run while a slot was already decoding can stall its
            # emission — that is what the interleaving bound measures
            self._rows_since_burst += rows
        if server.active:
            queue_depth, free_slots = len(self.queue), len(self.free)
            summary = (server._spec_round(self.slot_of)
                       if server.spec is not None
                       else server._burst_round(self.slot_of))
            misses = server._settle_round(summary, self.results, self.slot_of,
                                          self.free)
            if server.controller is not None:
                server._observe(summary["point"], summary["emitted"],
                                summary["steps"], queue_depth, free_slots,
                                summary["min_margin"],
                                deadline_misses=misses, shed=self._shed_since)
                self._shed_since = 0
            self.stats["bursts"] += 1
            self.stats["max_prefill_rows_between_bursts"] = max(
                self.stats["max_prefill_rows_between_bursts"],
                self._rows_since_burst)
            self._rows_since_burst = 0
        self._flush()
        return True

    def drain(self) -> Dict[int, List[int]]:
        """Tick until idle; returns rid -> tokens for everything resolved so
        far (the streaming analogue of ``run()``'s return value)."""
        while True:
            did = self.step()
            if not did and self.idle:
                return dict(self.results)

    def serve_forever(self, stop: threading.Event,
                      idle_sleep: float = 1e-3) -> None:
        """Drive ticks until ``stop`` is set (the daemon-thread loop
        :class:`AsyncFrontend` runs); sleeps briefly when idle."""
        while not stop.is_set():
            if not self.step():
                time.sleep(idle_sleep)

    # -- tick internals -------------------------------------------------------

    def _drain_inbox(self) -> bool:
        server = self.server
        with self._lock:
            batch, self._inbox = self._inbox, []
        for req, handle, wall, reason in batch:
            self.handles[req.rid] = handle
            server._run_requests.append(req)
            d = server._resolve_deadline(req)
            # submit-relative -> run-relative: the engine's sweeps compare
            # against (perf_counter() - _t0)
            server._deadlines[req.rid] = (
                None if d is None else (wall - server._t0) + d)
            if server.observer is not None:
                server.observer.request_submitted(
                    req.rid, len(np.asarray(req.prompt)), req.max_new,
                    wall_ts=wall)
            if reason is not None:
                server._shed(req, reason)
                self._shed_since += 1
                continue
            self.queue.append(req)
        return bool(batch)

    def _apply_cancellations(self) -> bool:
        server, did = self.server, False
        for rid, handle in list(self.handles.items()):
            if not handle.cancelled or rid in server.outcomes:
                continue
            req = handle.request
            if self.job is not None and self.job.req.rid == rid:
                # mid-prefill: nothing reached the shared cache yet — drop
                # the private row carry and return the slot
                self.free.append(self.job.slot)
                self.job = None
                req.generated, req.margins = [], []
                server._finish(req, "aborted", reason="cancelled")
            elif rid in server.active:
                # mid-decode: evict at this tick boundary, keep the partial
                # stream (it was committed and already pushed to the handle)
                server.active.pop(rid)
                self.results[rid] = req.generated
                server._finish(req, "aborted", reason="cancelled")
                self.free.append(self.slot_of.pop(rid))
            else:
                kept = [r for r in self.queue if r.rid != rid]
                if len(kept) == len(self.queue):
                    continue  # already settling this tick
                self.queue = kept
                server._finish(req, "aborted", reason="cancelled")
            did = True
        return did

    def _police_queue(self) -> bool:
        """The resilience sweeps, every tick: shed queued requests whose
        deadline already passed, then enforce the queue bound."""
        server, res = self.server, self.server.resilience
        if res is None or not self.queue:
            return False
        self.queue, n_shed = server._expire_queue(self.queue)
        if (res.queue_limit is not None
                and len(self.queue) > res.queue_limit):
            from repro_torch.resilience.outcome import shed_overflow

            self.queue, dropped = shed_overflow(
                self.queue, res.queue_limit, res.shed_policy,
                deadline_of=server._deadline)
            for r in dropped:
                server._shed(r, "queue_full")
            n_shed += len(dropped)
        self._shed_since += n_shed
        return n_shed > 0

    def _prefill_tick(self) -> int:
        """Run at most ``chunk_tokens`` prompt rows: continue the in-flight
        job, then admit from the queue while budget and slots remain.
        Returns the rows actually run (monolithic admissions charge their
        whole prompt, which is exactly their stall)."""
        server, cfg = self.server, self.config
        budget = cfg.chunk_tokens
        rows = 0
        while budget > 0:
            if self.job is None:
                if not (self.queue and self.free):
                    break
                req = self.queue.pop(0)
                slot = self.free.pop(0)
                if server.observer is not None:
                    server.observer.request_admitted(req.rid, slot)
                if cfg.monolithic_prefill:
                    server._prefill_slot(slot, req)
                    server._after_prefill(slot, req, self.results,
                                          self.slot_of, self.free)
                    plen = len(np.asarray(req.prompt))
                    rows += plen
                    budget -= plen
                    continue
                row, last = server.fresh_row()
                self.job = _PrefillJob(
                    req=req, slot=slot,
                    prompt=np.asarray(req.prompt, np.int32),
                    row=row, last=last)
            n = min(budget, len(self.job.prompt) - self.job.done)
            self._advance_job(self.job, n)
            rows += n
            budget -= n
            if self.job.done >= len(self.job.prompt):
                self.job = None
        return rows

    def _advance_job(self, job: _PrefillJob, n: int) -> None:
        """One chunk: ``n`` prompt rows through the job's private row cache;
        the final chunk also runs the admit program (sample token 0, scatter
        the row into the slot, admit the slot state) — the chunked prefill's
        single host transfer."""
        server = self.server
        obs = server.observer
        point = server._serving_point()
        bucket = server.chunk_span(len(job.prompt), job.done, n)[1]
        chunk_fn, admit_fn = server.chunk_fns()
        final = job.done + n >= len(job.prompt)
        if obs is not None:
            if bucket not in self._chunk_buckets:
                obs.compile_event("prefill_chunk", bucket=bucket)
            obs.prefill_chunk_begin(job.req.rid, job.done, n, bucket, point)
        self._chunk_buckets.add(bucket)
        chunk_fn(job.prompt, job.done, n)
        job.done += n
        if not final:
            if obs is not None:
                obs.prefill_chunk_end(job.req.rid, final=False)
            return
        req, slot = job.req, job.slot
        tok, margin = admit_fn(slot, req)
        server.host_transfers += 1
        req.generated, req.margins = [], []
        server._emit(req, [tok], [margin])
        if obs is not None:
            obs.prefill_chunk_end(req.rid, final=True,
                                  prompt_len=len(job.prompt), point=point)
        if server.telemetry is not None:
            server.telemetry.record_prefill(point, len(job.prompt))
        server._after_prefill(slot, req, self.results, self.slot_of,
                              self.free)

    def _flush(self) -> None:
        """Stream newly committed tokens to their handles and settle the
        ones whose outcome landed this tick."""
        server = self.server
        for rid in list(self.handles):
            handle = self.handles[rid]
            gen = handle.request.generated or []
            if len(gen) > handle._sent:
                handle._push(gen[handle._sent:])
                handle._sent = len(gen)
            if rid in server.outcomes:
                handle._settle(server.outcomes[rid])
                del self.handles[rid]


class AsyncFrontend:
    """asyncio facade over :class:`ContinuousScheduler`: the scheduler loops
    on a daemon thread; ``generate``/``stream`` bridge handles onto the
    event loop. Also usable synchronously via ``start()``/``stop()`` +
    ``submit()`` (the stdin/HTTP drivers in ``launch/serve.py`` do)."""

    def __init__(self, server: BatchedServer,
                 config: Optional[FrontendConfig] = None) -> None:
        self.scheduler = ContinuousScheduler(server, config)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "AsyncFrontend":
        self.scheduler.open()
        self._thread = threading.Thread(
            target=self.scheduler.serve_forever, args=(self._stop,),
            daemon=True, name="carmen-frontend")
        self._thread.start()
        return self

    def stop(self, aborted: bool = False) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.scheduler.close(aborted=aborted)

    async def __aenter__(self) -> "AsyncFrontend":
        return self.start()

    async def __aexit__(self, exc_type, exc, tb) -> None:
        self.stop(aborted=exc_type is not None)

    def submit(self, request: Request) -> StreamHandle:
        return self.scheduler.submit(request)

    async def generate(self, request: Request) -> List[int]:
        """Submit and await the full (possibly partial-on-abort) stream."""
        import asyncio

        handle = self.submit(request)
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, handle._done.wait)
        return list(handle.tokens)

    async def stream(self, request: Request):
        """Submit and yield tokens as they land (async generator)."""
        import asyncio

        handle = self.submit(request)
        loop = asyncio.get_running_loop()
        while True:
            item = await loop.run_in_executor(None, handle._events.get)
            if item is _DONE:
                return
            yield item
