"""ServingObserver: the engine-facing bundle of metrics + trace hooks (port of
``repro.obs.observer``, pure Python as there).

One observer instruments one :class:`~repro_torch.serve.engine.BatchedServer`.
Every hook runs host-side at a synchronization point the serving loop
already pays for (burst boundary, prefill return, speculative-round commit),
so observability is OFF the device programs by construction: token streams
are bit-identical with an observer attached or not, and the measured
overhead is bounded in CI (``bench_serving --smoke``'s ≤5% tok/s gate).

SLO metrics recorded per request (histograms, p50/p90/p99 in the snapshot):

=================== ========================================================
``queue_wait_s``     submission -> leaving the queue, by slot admission OR
                     by shed (a shed request still waited; excluding sheds
                     would bias p99 optimistically under heavy shedding)
``ttft_s``           submission -> first token (time-to-first-token). Batch
                     ``run()`` submits everything at run entry; the
                     streaming frontend stamps true per-request submit times
``prefill_s``        admission -> prefill return (one program, synced)
``prefill_chunk_s``  one chunk of a chunked streaming prefill (these replace
                     the monolithic ``prefill`` span on the frontend path)
``intertoken_s``     burst-amortized inter-token latency: a burst that lands
                     ``n`` tokens ``dt`` after the request's previous
                     emission observes ``dt/n`` with weight ``n``
``decode_burst_s``   wall time of one decode burst / speculative round
``request_s``        admission -> completion
``tokens_per_request`` / ``request_tok_s``  per-request totals at completion
=================== ========================================================

plus counters (requests, tokens, prefill_tokens, prefill_chunks, bursts,
spec_rounds, decode_steps, host_transfers, controller_switches, compiles,
evicted, cancelled, admission_ticks) and
run-level gauges (``run_wall_s``, ``tok_s``, ``acceptance_rate`` under
speculation). ``observer.trace`` (optional) records the structured event
timeline documented in :mod:`repro_torch.obs.trace`.

An observer is single-run: ``run_begin`` resets everything, and the server's
:meth:`~repro_torch.serve.engine.BatchedServer.snapshot` is the symmetric export.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from .metrics import MetricsRegistry
from .trace import TraceRecorder

__all__ = ["ServingObserver"]


@dataclasses.dataclass
class _ReqState:
    submit: float
    prompt_len: int
    max_new: int
    slot: Optional[int] = None
    admit: Optional[float] = None
    first_tok: Optional[float] = None
    last_emit: Optional[float] = None
    tokens: int = 0
    done: Optional[float] = None


class ServingObserver:
    """Metrics + trace hooks for one serving run (see module docstring)."""

    def __init__(self, metrics: bool = True, trace: bool = True,
                 clock=time.perf_counter,
                 trace_sink: Optional[str] = None) -> None:
        self._clock = clock
        self._want_trace = trace
        # trace_sink: a JSONL path the trace is flushed to at run_end even
        # when the run aborted (TraceRecorder's crash-safe sink), so traces
        # from crashed runs stay replayable
        self.trace_sink = trace_sink
        self.metrics = MetricsRegistry() if metrics else None
        self.trace: Optional[TraceRecorder] = None
        self.requests: Dict[int, _ReqState] = {}
        self._span_t0: Dict[str, float] = {}
        self.aborted: Optional[bool] = None

    # -- run lifecycle --------------------------------------------------------

    def run_begin(self, meta: Dict, requests) -> None:
        """Reset and open the run: every request is registered as submitted
        now (the batched ``run()`` contract — the whole list arrives at
        entry), which anchors queue-wait and TTFT."""
        if self.metrics is not None:
            self.metrics.reset()
        self.trace = (TraceRecorder(clock=self._clock, sink=self.trace_sink)
                      if self._want_trace else None)
        self.requests = {}
        self._span_t0 = {}
        self.aborted = None
        if self.trace is not None:
            self.trace.attach("run", meta)
            self.trace.begin("run", track="run", **meta)
        for req in requests:
            self.request_submitted(req.rid, len(req.prompt), req.max_new)

    def request_submitted(self, rid: int, prompt_len: int, max_new: int,
                          wall_ts: Optional[float] = None) -> None:
        """Register one arrival. ``run_begin`` calls this for the whole batch
        (the ``run()`` contract: the list arrives at entry); the streaming
        frontend calls it per submission at scheduler intake, passing
        ``wall_ts`` — the raw clock reading stamped on the submitting thread
        — so queue-wait and TTFT anchor at the true submit time, not at the
        tick that first saw the request."""
        now = self._at(wall_ts)
        self.requests[rid] = _ReqState(
            submit=now, prompt_len=prompt_len, max_new=max_new)
        self._count("requests")
        if self.trace is not None:
            self.trace.instant("request_submitted", track="sched",
                               rid=rid, prompt_len=prompt_len,
                               max_new=max_new)

    def run_end(self, aborted: bool, host_transfers: int,
                telemetry: Optional[List[Dict]] = None) -> None:
        """Close the run: settle open spans, evict unfinished requests, and
        derive the run-level gauges. Always called (``finally``), so an
        aborted run still exports a coherent record."""
        now = self._now()
        self.aborted = aborted
        for rid, st in self.requests.items():
            if st.done is None and st.admit is not None:
                self._count("evicted")
                if self.trace is not None:
                    self.trace.instant("request_evicted", track=_slot_track(st),
                                       rid=rid, tokens=st.tokens)
        if self.metrics is not None:
            self.metrics.inc("host_transfers", host_transfers)
            wall = max((now - st.submit for st in self.requests.values()),
                       default=0.0)
            self.metrics.set("run_wall_s", wall)
            tokens = self.metrics.counter("tokens").value
            if wall > 0:
                self.metrics.set("tok_s", tokens / wall)
            for rec in telemetry or []:
                if rec.get("kind") == "speculative":
                    self.metrics.set("acceptance_rate",
                                     rec["detail"]["acceptance_rate"])
                self.metrics.set(f"est_cycle_savings_frac_{rec['kind']}",
                                 rec["est_cycle_savings_frac"])
        if self.trace is not None:
            self.trace.close_open()
            self.trace.header["meta"]["aborted"] = aborted
            self.trace.attach("telemetry", telemetry or [])
            if aborted and self.trace.sink is not None:
                # crashed run: the caller's normal export path never runs, so
                # flush the settled trace to the sink now — it stays
                # replayable (satellite of the aborted-run symmetry fix)
                self.trace.flush()

    # -- admission / prefill --------------------------------------------------

    def request_shed(self, rid: int, reason: str) -> None:
        """The request was rejected at admission (never held a slot):
        bounded-queue overflow, oversized/empty prompt, or a deadline that
        expired while queued. ``reason`` is the structured attribution the
        overload gates assert on."""
        st = self.requests.get(rid)
        if st is not None:
            st.done = self._now()
            # a shed request still waited: its time in the queue contributes
            # to the queue_wait histogram (submission -> leaving the queue,
            # by admission OR by shed). Excluding sheds would bias p99
            # optimistically under heavy shedding — exactly the long-waiting
            # requests a deadline sweep rejects would vanish from the tail.
            self._observe("queue_wait_s", st.done - st.submit)
        self._count("shed")
        self._count(f"shed_{reason}")
        if self.trace is not None:
            self.trace.instant("request_shed", track="sched", rid=rid,
                               reason=reason)

    def request_expired(self, rid: int, tokens: int) -> None:
        """An admitted request missed its deadline mid-decode and was
        evicted at the burst boundary with ``tokens`` partial tokens."""
        now = self._now()
        st = self.requests[rid]
        st.done = now
        self._count("expired")
        self._count("deadline_misses")
        if self.trace is not None:
            self.trace.instant("request_expired", track=_slot_track(st),
                               rid=rid, tokens=tokens)
            if st.admit is not None:
                self.trace.end(f"request:{rid}", track=_slot_track(st),
                               rid=rid, tokens=tokens)

    def request_faulted(self, rid: int, tokens: int,
                        reason: Optional[str] = None) -> None:
        """An admitted request produced non-finite/saturated logits and was
        quarantined; ``tokens`` clean tokens were committed before the
        fault."""
        now = self._now()
        st = self.requests[rid]
        st.done = now
        self._count("faulted")
        if self.trace is not None:
            self.trace.instant("request_faulted", track=_slot_track(st),
                               rid=rid, tokens=tokens, reason=reason)
            if st.admit is not None:
                self.trace.end(f"request:{rid}", track=_slot_track(st),
                               rid=rid, tokens=tokens)

    def request_admitted(self, rid: int, slot: int) -> None:
        st = self.requests[rid]
        st.slot, st.admit = slot, self._now()
        self._observe("queue_wait_s", st.admit - st.submit)
        if self.trace is not None:
            self.trace.instant("request_admitted", track="sched", rid=rid,
                               slot=slot)
            self.trace.begin(f"request:{rid}", track=_slot_track(st), rid=rid,
                             prompt_len=st.prompt_len, max_new=st.max_new)

    def prefill_begin(self, rid: int, bucket: int, point: Optional[str]) -> None:
        self._span_t0["prefill"] = self._now()
        if self.trace is not None:
            self.trace.begin("prefill", track="engine", rid=rid, bucket=bucket,
                             point=point)

    def prefill_end(self, rid: int, prompt_len: int,
                    point: Optional[str]) -> None:
        now = self._now()
        self._observe("prefill_s", now - self._span_t0.pop("prefill", now))
        if self.trace is not None:
            self.trace.end("prefill", track="engine", rid=rid)
        self._prefilled(rid, prompt_len, point, now)

    def _prefilled(self, rid: int, prompt_len: int, point: Optional[str],
                   now: float) -> None:
        """Shared prefill-completion accounting: first token committed."""
        st = self.requests[rid]
        st.first_tok = st.last_emit = now
        st.tokens = 1
        self._observe("ttft_s", now - st.submit)
        self._count("prefill_tokens", prompt_len)
        self._count("tokens")
        if self.trace is not None:
            self.trace.instant("request_prefilled", track=_slot_track(st),
                               rid=rid, prompt_len=prompt_len, point=point)

    def prefill_chunk_begin(self, rid: int, start: int, n: int, bucket: int,
                            point: Optional[str]) -> None:
        """One chunk of a chunked (streaming-frontend) prefill: ``n`` prompt
        rows from offset ``start``, padded to ``bucket``. Chunks appear
        instead of the monolithic ``prefill`` span for chunk-prefilled
        requests; the final chunk's end also fires the ``request_prefilled``
        accounting via :meth:`prefill_chunk_end`."""
        self._span_t0["prefill_chunk"] = self._now()
        if self.trace is not None:
            self.trace.begin("prefill_chunk", track="engine", rid=rid,
                             start=start, n=n, bucket=bucket, point=point)

    def prefill_chunk_end(self, rid: int, final: bool,
                          prompt_len: Optional[int] = None,
                          point: Optional[str] = None) -> None:
        now = self._now()
        self._observe("prefill_chunk_s",
                      now - self._span_t0.pop("prefill_chunk", now))
        self._count("prefill_chunks")
        if self.trace is not None:
            self.trace.end("prefill_chunk", track="engine", rid=rid,
                           final=final)
        if final:
            self._prefilled(rid, prompt_len, point, now)

    def admission_tick(self, queued: int, active: int, free: int) -> None:
        """One streaming-frontend scheduler tick (admission + shed sweeps +
        at most one chunk budget of prefill + one burst)."""
        self._count("admission_ticks")
        if self.trace is not None:
            self.trace.instant("admission_tick", track="sched", queued=queued,
                               active=active, free=free)

    def request_cancelled(self, rid: int, tokens: int) -> None:
        """The client cancelled / disconnected: the request leaves at the
        next tick boundary with ``tokens`` partial tokens (0 if it was still
        queued or mid-prefill)."""
        st = self.requests.get(rid)
        self._count("cancelled")
        if st is None:
            return
        st.done = self._now()
        if self.trace is not None:
            self.trace.instant("request_cancelled", track=_slot_track(st),
                               rid=rid, tokens=tokens)
            if st.admit is not None:
                self.trace.end(f"request:{rid}", track=_slot_track(st),
                               rid=rid, tokens=tokens)

    def compile_event(self, what: str, **args) -> None:
        """A new device program is about to be built: on the card a CUDA
        graph about to be captured (a program's first visit at a point, or
        its re-capture after a weight fault), elsewhere a prefill bucket's or
        burst variant's first visit — the next span's wall time includes it."""
        self._count("compiles")
        if self.trace is not None:
            self.trace.instant("compile", track="engine", what=what, **args)

    # -- decode bursts / speculative rounds -----------------------------------

    def burst_begin(self, point: Optional[str], kind: str = "burst") -> None:
        self._span_t0[kind] = self._now()
        if self.trace is not None:
            self.trace.begin(kind, track="engine", point=point)

    def burst_end(self, point: Optional[str], steps: int,
                  emitted: Dict[int, List[int]], kind: str = "burst",
                  **extra) -> None:
        """Commit of one burst / speculative round: ``emitted`` maps rid ->
        tokens landed this round (the single host transfer's payload)."""
        now = self._now()
        wall = now - self._span_t0.pop(kind, now)
        total = sum(len(t) for t in emitted.values())
        self._observe("decode_burst_s", wall)
        self._count("bursts" if kind == "burst" else "spec_rounds")
        self._count("decode_steps", steps)
        self._count("tokens", total)
        for rid, toks in emitted.items():
            st = self.requests[rid]
            if toks and st.last_emit is not None:
                self._observe("intertoken_s", (now - st.last_emit) / len(toks),
                              n=len(toks))
            if toks:
                st.last_emit = now
                st.tokens += len(toks)
                if self.trace is not None:
                    self.trace.instant("tokens", track=_slot_track(st),
                                       rid=rid, n=len(toks))
        if self.trace is not None:
            self.trace.end(kind, track="engine", point=point, steps=steps,
                           tokens=total, **extra)

    def spec_stage_begin(self, stage: str, point: str) -> None:
        """Draft/verify dispatch inside a speculative round (dispatch-only
        span: the round synchronizes once, at its commit)."""
        if self.trace is not None:
            self.trace.begin(f"spec_{stage}", track="engine", point=point)

    def spec_stage_end(self, stage: str, point: str) -> None:
        if self.trace is not None:
            self.trace.end(f"spec_{stage}", track="engine", point=point)

    def spec_commit(self, accepted) -> None:
        """Accepted-draft counts per slot, after the round's host transfer
        (the rollback already happened on device)."""
        if self.trace is not None:
            self.trace.instant("spec_rollback", track="engine",
                               accepted=[int(a) for a in accepted])

    # -- controller -----------------------------------------------------------

    def controller_switch(self, old: str, new: str, signals) -> None:
        self._count("controller_switches")
        if self.trace is not None:
            args = dataclasses.asdict(signals) if dataclasses.is_dataclass(
                signals) else dict(signals or {})
            self.trace.instant("controller_switch", track="engine",
                               old=old, new=new, signals=args)

    # -- completion -----------------------------------------------------------

    def request_completed(self, rid: int) -> None:
        now = self._now()
        st = self.requests[rid]
        st.done = now
        if st.admit is not None:
            wall = now - st.admit
            self._observe("request_s", wall)
            if wall > 0:
                self._observe("request_tok_s", st.tokens / wall)
        self._observe("tokens_per_request", st.tokens)
        if self.trace is not None:
            self.trace.instant("request_completed", track="sched", rid=rid,
                               tokens=st.tokens)
            self.trace.end(f"request:{rid}", track=_slot_track(st), rid=rid,
                           tokens=st.tokens)

    # -- export ---------------------------------------------------------------

    def snapshot(self) -> Dict:
        """JSON-able export of the current run's metrics + per-request rows
        (the trace exports itself: ``observer.trace.write_jsonl`` /
        ``to_chrome``)."""
        reqs = {}
        for rid, st in self.requests.items():
            reqs[rid] = {
                "prompt_len": st.prompt_len,
                "max_new": st.max_new,
                "slot": st.slot,
                "tokens": st.tokens,
                "queue_wait_s": _delta(st.submit, st.admit),
                "ttft_s": _delta(st.submit, st.first_tok),
                "request_s": _delta(st.admit, st.done),
                "completed": st.done is not None,
            }
        return {
            "aborted": self.aborted,
            "metrics": self.metrics.snapshot() if self.metrics else None,
            "requests": reqs,
        }

    # -- internals ------------------------------------------------------------

    def _now(self) -> float:
        return self.trace.now() if self.trace is not None else (
            self._clock())

    def _at(self, wall_ts: Optional[float]) -> float:
        """Map a raw clock reading onto the observer's time base (trace time
        when a trace is attached); ``None`` means "now"."""
        if wall_ts is None:
            return self._now()
        return self.trace.at(wall_ts) if self.trace is not None else wall_ts

    def _observe(self, name: str, v: float, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.observe(name, v, n)

    def _count(self, name: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, n)


def _slot_track(st: _ReqState) -> str:
    return f"slot{st.slot}" if st.slot is not None else "sched"


def _delta(a: Optional[float], b: Optional[float]) -> Optional[float]:
    return None if a is None or b is None else b - a
