"""PyTorch port: serving observability (``repro_torch.obs``; the server's
``observer=`` and ``snapshot()``) against the reference, on the CPU.

The observer is a pure observer: attaching it never changes a stream
(dense, MoE, MLA, adaptive, speculative). Reduced olmo-1b in kernel mode on
the reference's numpy weights: a run's metrics counters, histogram counts,
per-request rows and trace events (every field but the wall-clock ones) are
the reference's, and the reference's PE-array simulator
(``repro.sim.replay.replay_trace``) replays the port's JSONL trace of a
faulted adaptive (and a faulted speculative) run with the cycle and token
accounting of its replay of the reference's own trace of the same run. The
rest pins the exports: histograms, Chrome traces, JSONL round trips,
symmetric reset across reuse and aborted runs, the telemetry record shape
and ``teacher_forced_agreement``'s edge cases.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro import resilience as jres  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro import spec as jspec  # noqa: E402
from repro.obs import ServingObserver as JObserver  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.sim.replay import replay_trace  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    MetricsRegistry,
    ServingObserver,
    StreamingHistogram,
    TRACE_SCHEMA,
    TRACE_VERSION,
    TraceRecorder,
    read_trace,
)
from repro_torch.resilience import FaultInjector, NaNCacheFault, ResilienceConfig  # noqa: E402
from repro_torch.runtime import (ControllerConfig, ModeController,  # noqa: E402
                                 teacher_forced_agreement)
from repro_torch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401
from test_torch_resilience import LIMIT, Arch  # noqa: E402

# trace-event and snapshot fields that hold host time
WALL = {"ts", "wall_s", "t0_unix"}


@pytest.fixture(scope="module")
def olmo():
    return Arch("olmo-1b")


def _requests(cls, cfg, n, *, max_new=6):
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, cfg.vocab_size, 3 + i).astype(np.int32), max_new)
            for i in range(n)]


def _port_only(arch):
    """An arch on the port alone (its own random weights): for the
    observer-on = observer-off identity, which needs no reference."""
    cfg = reduced(get_config(arch), **({"layers": 4} if arch.startswith("deepseek") else {}))
    model = get_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# metrics primitives
# ---------------------------------------------------------------------------


def test_streaming_histogram_summary():
    h = StreamingHistogram()
    for v in (0.001, 0.002, 0.004, 0.008, 0.1):
        h.observe(v)
    s = h.summary()
    assert s["count"] == 5
    assert s["min"] == pytest.approx(0.001) and s["max"] == pytest.approx(0.1)
    assert s["mean"] == pytest.approx(0.023)
    assert 0.001 <= s["p50"] <= 0.008
    assert s["p50"] <= s["p90"] <= s["p99"] <= s["max"]


def test_streaming_histogram_weighted_observe():
    h = StreamingHistogram()
    h.observe(0.5, n=7)
    assert h.count == 7 and h.summary()["p99"] == pytest.approx(0.5)


@given(st.lists(st.floats(min_value=1e-6, max_value=1e3), min_size=1, max_size=200))
@settings(max_examples=60, deadline=None)
def test_streaming_histogram_quantile_bound(values):
    """Every reported percentile is within one geometric-bucket growth
    factor of the exact order statistic; count, min, max and sum exact."""
    h = StreamingHistogram()
    for v in values:
        h.observe(v)
    ordered = sorted(values)
    for q in (0.50, 0.90, 0.99):
        exact = ordered[max(math.ceil(q * len(ordered)) - 1, 0)]
        ratio = h.quantile(q) / exact
        assert 1 / h.growth <= ratio <= h.growth * (1 + 1e-9)
    assert h.count == len(values)
    assert h.lo == pytest.approx(min(values)) and h.hi == pytest.approx(max(values))
    assert h.total == pytest.approx(sum(values), rel=1e-9)


@given(st.floats(min_value=1e-12, max_value=1e-7), st.floats(min_value=1e-12, max_value=1e-7))
@settings(max_examples=30, deadline=None)
def test_streaming_histogram_below_floor_clamps_exact(a, b):
    h = StreamingHistogram()
    h.observe(a)
    h.observe(b)
    for q in (0.50, 0.99):
        assert min(a, b) <= h.quantile(q) <= max(a, b)


def test_streaming_histogram_single_huge_value_clamped():
    h = StreamingHistogram()
    h.observe(5e4)
    for q in (0.5, 0.9, 0.99):
        assert h.quantile(q) == pytest.approx(5e4)
    with pytest.raises(ValueError):
        StreamingHistogram(growth=1.0)


def test_registry_reset_symmetric():
    reg = MetricsRegistry()
    reg.inc("tokens", 3)
    reg.set("tok_s", 9.0)
    reg.observe("ttft_s", 0.1)
    snap = reg.snapshot()
    assert snap["counters"]["tokens"] == 3 and snap["gauges"]["tok_s"] == 9.0
    assert snap["histograms"]["ttft_s"]["count"] == 1
    reg.reset()
    empty = reg.snapshot()
    assert empty["counters"] == {} and empty["histograms"] == {}


# ---------------------------------------------------------------------------
# trace primitives
# ---------------------------------------------------------------------------


def test_trace_nesting_enforced_at_record_time():
    tr = TraceRecorder()
    tr.begin("outer")
    tr.begin("inner")
    with pytest.raises(ValueError, match="span mismatch"):
        tr.end("outer")
    tr.end("inner")
    tr.end("outer")


def test_trace_close_open_settles_aborted_spans():
    tr = TraceRecorder()
    tr.begin("run", track="run")
    tr.begin("burst")
    tr.close_open(aborted=True)
    phases = [(e["ph"], e["name"]) for e in tr.events]
    assert phases.count(("E", "burst")) == 1 and phases.count(("E", "run")) == 1


def test_trace_jsonl_roundtrip_and_version_guard(tmp_path):
    tr = TraceRecorder()
    tr.attach("run", {"family": "t"})
    tr.instant("x", rid=0)
    path = str(tmp_path / "t.jsonl")
    tr.write_jsonl(path)
    header, events = read_trace(path)
    assert (header["schema"], header["version"]) == (TRACE_SCHEMA, TRACE_VERSION)
    assert header["run"] == {"family": "t"}
    assert len(events) == 1 and events[0]["name"] == "x"
    future = str(tmp_path / "future.jsonl")
    with open(future, "w") as f:
        f.write(json.dumps({"schema": TRACE_SCHEMA, "version": TRACE_VERSION + 1}) + "\n")
    with pytest.raises(ValueError, match="newer than this reader"):
        read_trace(future)
    alien = str(tmp_path / "alien.jsonl")
    with open(alien, "w") as f:
        f.write(json.dumps({"schema": "other"}) + "\n")
    with pytest.raises(ValueError, match="not a"):
        read_trace(alien)


# ---------------------------------------------------------------------------
# bit identity: observability never changes a stream
# ---------------------------------------------------------------------------


def _run_pair(model, ctx, params, cfg, **kw):
    plain = BatchedServer(model, ctx, params, slots=2, max_len=40, device="cpu", **kw)
    ref = plain.run(_requests(Request, cfg, 3))
    margins = [list(r.margins) for r in plain._run_requests]
    watched = BatchedServer(model, ctx, params, slots=2, max_len=40, device="cpu",
                            observer=ServingObserver(), **kw)
    out = watched.run(_requests(Request, cfg, 3))
    assert [list(r.margins) for r in watched._run_requests] == margins
    return ref, out, watched


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "deepseek-v3-671b"])
def test_observer_bit_identical(olmo, arch):
    """MoE and MLA + MoE: streams and margins with the observer on equal
    those with it off (olmo-1b: in the reference comparison below)."""
    cfg, model, params = _port_only(arch)
    ref, out, _ = _run_pair(model, olmo.ctx, params, cfg, burst=4)
    assert out == ref


def test_observer_bit_identical_adaptive(olmo):
    bank = olmo.bank()
    make = lambda: ModeController(bank, ControllerConfig(cycle_budget=0.8))  # noqa: E731
    ref, out, watched = _run_pair(olmo.model, olmo.ctx, olmo.params(), olmo.cfg, burst=4,
                                  controller=make())
    assert out == ref
    counters = watched.snapshot()["observability"]["metrics"]["counters"]
    assert counters["tokens"] == sum(len(v) for v in ref.values())


def test_observer_bit_identical_speculative(olmo):
    ref, out, watched = _run_pair(olmo.model, olmo.ctx, olmo.params(), olmo.cfg,
                                  bank=olmo.bank(), speculate=SpecConfig(draft_len=3))
    assert out == ref
    assert watched.observer.metrics.snapshot()["counters"]["spec_rounds"] > 0
    names = {e["name"] for e in watched.observer.trace.events}
    assert {"spec_draft", "spec_verify", "spec_rollback"} <= names


# ---------------------------------------------------------------------------
# a run's metrics and trace, against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def observed_run(olmo):
    server = olmo.server(slots=2, max_len=32, burst=4, observer=ServingObserver())
    out = server.run(_requests(Request, olmo.cfg, 4))
    jserver = olmo.jserver(slots=2, max_len=32, burst=4, observer=JObserver())
    jout = jserver.run(_requests(JRequest, olmo.cfg, 4))
    return server, out, jserver, jout


def _untimed(tree):
    """``tree`` without its wall-clock fields (and histograms reduced to
    their counts)."""
    if isinstance(tree, dict):
        if "count" in tree and "p50" in tree:
            return {"count": tree["count"]}
        return {k: _untimed(v) for k, v in tree.items() if k not in WALL}
    if isinstance(tree, list):
        return [_untimed(v) for v in tree]
    return tree


def test_run_matches_reference(observed_run):
    """Streams, counters, histogram counts, per-request rows and the trace
    events (names, tracks, arguments: everything but time) are the
    reference's; run-level gauges are wall clock and only present."""
    server, out, jserver, jout = observed_run
    assert out == jout
    snap, jsnap = server.observer.snapshot(), jserver.observer.snapshot()
    m, jm = snap["metrics"], jsnap["metrics"]
    assert m["counters"] == jm["counters"]
    assert _untimed(m["histograms"]) == _untimed(jm["histograms"])
    assert set(m["gauges"]) == set(jm["gauges"])
    rows = {rid: (r["slot"], r["tokens"], r["completed"], r["prompt_len"])
            for rid, r in snap["requests"].items()}
    assert rows == {rid: (r["slot"], r["tokens"], r["completed"], r["prompt_len"])
                    for rid, r in jsnap["requests"].items()}
    events = _untimed(server.observer.trace.events)
    assert events == _untimed(jserver.observer.trace.events)
    assert _untimed(server.observer.trace.header) == _untimed(jserver.observer.trace.header)


def test_slo_histograms_populated(observed_run):
    server, out, _, _ = observed_run
    snap = server.observer.snapshot()
    hists = snap["metrics"]["histograms"]
    gen = sum(len(v) for v in out.values())
    assert hists["ttft_s"]["count"] == 4 and hists["queue_wait_s"]["count"] == 4
    assert hists["intertoken_s"]["count"] == gen - 4
    for name in ("ttft_s", "intertoken_s", "queue_wait_s", "prefill_s", "decode_burst_s",
                 "request_s"):
        h = hists[name]
        assert h["count"] > 0 and 0.0 <= h["min"] <= h["mean"] <= h["max"]
        assert h["min"] - 1e-12 <= h["p50"] <= h["p90"] <= h["p99"] <= h["max"] + 1e-12
    counters = snap["metrics"]["counters"]
    assert counters["tokens"] == gen and counters["host_transfers"] == server.host_transfers
    assert counters["requests"] == 4 and "evicted" not in counters


def test_per_request_rows_monotone(observed_run):
    server, out, _, _ = observed_run
    for rid, row in server.observer.snapshot()["requests"].items():
        assert row["completed"] and row["tokens"] == len(out[rid])
        assert 0.0 <= row["queue_wait_s"] <= row["ttft_s"] and row["request_s"] >= 0.0


def test_trace_events_monotone_and_nested(observed_run):
    events = observed_run[0].observer.trace.events
    ts = [e["ts"] for e in events]
    assert ts == sorted(ts)
    stacks = {}
    for e in events:
        stack = stacks.setdefault(e["track"], [])
        if e["ph"] == "B":
            stack.append(e["name"])
        elif e["ph"] == "E":
            assert stack and stack[-1] == e["name"]
            stack.pop()
    assert all(not s for s in stacks.values())


def test_chrome_export_valid_and_balanced(observed_run, tmp_path):
    path = str(tmp_path / "trace.json")
    observed_run[0].observer.trace.write_chrome(path)
    with open(path) as f:
        doc = json.load(f)
    assert doc["metadata"]["schema"] == TRACE_SCHEMA
    names = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert {"engine", "run", "sched"} <= names
    per_tid = {}
    for e in doc["traceEvents"]:
        if e["ph"] in ("B", "E"):
            per_tid[e["tid"]] = per_tid.get(e["tid"], 0) + (1 if e["ph"] == "B" else -1)
    assert all(v == 0 for v in per_tid.values())


def test_jsonl_export_roundtrips_run(observed_run, tmp_path):
    server = observed_run[0]
    path = str(tmp_path / "trace.jsonl")
    server.observer.trace.write_jsonl(path)
    header, events = read_trace(path)
    assert header["run"]["slots"] == 2 and header["run"]["burst"] == 4
    assert header["meta"]["aborted"] is False
    assert len(events) == len(server.observer.trace.events)


def test_shed_requests_contribute_queue_wait(olmo):
    """Every offered request lands one queue-wait sample, shed ones too."""
    server = olmo.server(slots=1, max_len=32, burst=4, observer=ServingObserver(trace=False),
                         resilience=ResilienceConfig(queue_limit=2))
    out = server.run(_requests(Request, olmo.cfg, 5))
    assert len([o for o in server.outcomes.values() if o.status == "shed"]) == 3
    assert len(out) == 2
    snap = server.observer.snapshot()["metrics"]
    assert snap["histograms"]["queue_wait_s"]["count"] == 5
    assert snap["counters"]["shed"] == 3 and snap["counters"]["requests"] == 5
    assert snap["counters"]["shed_queue_full"] == 3


# ---------------------------------------------------------------------------
# the reference's simulator replays a port trace
# ---------------------------------------------------------------------------


def _replayed(path):
    res = replay_trace(path)
    return {"counts": res.counts, "phases": res.phases, "totals": res.totals,
            "layers": res.layers, "requests": res.requests,
            "points": {p: {k: v for k, v in acc.items() if k != "wall_s"}
                       for p, acc in res.points.items()},
            "savings": {k: v for k, v in res.savings.items() if "measured" not in k},
            "meta": {k: v for k, v in res.meta.items() if k != "aborted"}}


@pytest.mark.parametrize("kind", ["adaptive", "speculative"])
def test_reference_replays_port_trace(olmo, tmp_path, kind):
    """A faulted run (a NaN-poisoned KV slot at round 0, ``logit_limit``
    quarantining the lanes it flags) under the mode controller, or
    speculative: the port writes a ``carmen-serve-trace`` v1 JSONL that
    the reference's ``repro.sim.replay`` reads, and its replay charges the
    cycles, steps, tokens and requests of the replay of the reference's own
    trace of the same run."""
    kw = dict(slots=2, max_len=40, burst=4)
    bank, jbank = olmo.bank(), olmo.jbank()
    path, jpath = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    if kind == "adaptive":
        extra = dict(controller=ModeController(bank, ControllerConfig(cycle_budget=0.8)))
        jextra = dict(controller=jrt.ModeController(jbank, jrt.ControllerConfig(
            cycle_budget=0.8)))
    else:
        extra = dict(bank=bank, speculate=SpecConfig(draft_len=3))
        jextra = dict(bank=jbank, speculate=jspec.SpecConfig(draft_len=3))
    srv = olmo.server(observer=ServingObserver(trace_sink=path),
                      resilience=ResilienceConfig(logit_limit=LIMIT),
                      injector=FaultInjector(NaNCacheFault(rid=1, at_round=0)), **kw, **extra)
    out = srv.run(_requests(Request, olmo.cfg, 4, max_new=8))
    srv.observer.trace.write_jsonl(path)
    jsrv = olmo.jserver(observer=JObserver(trace_sink=jpath),
                        resilience=jres.ResilienceConfig(logit_limit=LIMIT),
                        injector=jres.FaultInjector(jres.NaNCacheFault(rid=1, at_round=0)),
                        **kw, **jextra)
    jout = jsrv.run(_requests(JRequest, olmo.cfg, 4, max_new=8))
    jsrv.observer.trace.write_jsonl(jpath)
    assert out == jout
    assert ({r: (o.status, o.reason, o.tokens) for r, o in srv.outcomes.items()}
            == {r: (o.status, o.reason, o.tokens) for r, o in jsrv.outcomes.items()})
    if kind == "adaptive":
        assert any(o.status == "faulted" for o in srv.outcomes.values())
    got, want = _replayed(path), _replayed(jpath)
    assert got == want
    assert got["counts"]["tokens"] == sum(len(v) for v in out.values())


# ---------------------------------------------------------------------------
# run reuse and aborted runs: reset and export are symmetric
# ---------------------------------------------------------------------------


def test_aborted_run_resets_cleanly_for_reuse(olmo):
    ref = olmo.server(slots=2, max_len=32, burst=4).run(_requests(Request, olmo.cfg, 3))
    server = olmo.server(slots=2, max_len=32, burst=4, observer=ServingObserver())
    server._burst_round = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("induced failure"))
    with pytest.raises(RuntimeError, match="induced failure"):
        server.run(_requests(Request, olmo.cfg, 3))
    snap = server.snapshot()
    assert snap["completed"] is False and snap["observability"]["aborted"] is True
    assert snap["observability"]["metrics"]["counters"]["evicted"] > 0
    assert all(not s for s in server.observer.trace._open.values())
    del server._burst_round
    assert server.run(_requests(Request, olmo.cfg, 3)) == ref
    snap = server.snapshot()
    assert snap["completed"] is True and snap["observability"]["aborted"] is False
    counters = snap["observability"]["metrics"]["counters"]
    assert counters["requests"] == 3 and "evicted" not in counters


def test_second_run_snapshot_has_no_residue(olmo):
    server = olmo.server(slots=2, max_len=32, burst=4, observer=ServingObserver())
    server.run(_requests(Request, olmo.cfg, 2))
    first = server.snapshot()
    server.run(_requests(Request, olmo.cfg, 3))
    second = server.snapshot()
    assert first["observability"]["metrics"]["counters"]["requests"] == 2
    assert second["observability"]["metrics"]["counters"]["requests"] == 3
    assert second["host_transfers"] <= first["host_transfers"] + 3


def test_telemetry_records_share_one_shape(olmo):
    bank = olmo.bank()
    server = olmo.server(slots=2, max_len=40, bank=bank,
                         controller=ModeController(bank, ControllerConfig(cycle_budget=0.8)),
                         speculate=SpecConfig(draft_len=3))
    server.run(_requests(Request, olmo.cfg, 3))
    recs = server.snapshot()["telemetry"]
    assert sorted(r["kind"] for r in recs) == ["adaptive", "speculative"]
    common = {"kind", "reference", "tokens", "est_cycles", "baseline_cycles",
              "est_cycle_savings_frac", "detail"}
    for rec in recs:
        assert common <= set(rec) and rec["reference"] == bank.reference
        assert isinstance(rec["detail"], dict)


# ---------------------------------------------------------------------------
# teacher_forced_agreement edge cases
# ---------------------------------------------------------------------------


def _tfa(olmo, gens):
    reqs = [Request(i, np.array([1 + i, 2, 3], np.int32), 6) for i in range(len(gens))]
    results = {i: list(g) for i, g in enumerate(gens)}
    margins = {i: [2.0] * len(g) for i, g in enumerate(gens)}
    return reqs, results, margins


def _tfa_call(olmo, reqs, results, margins):
    return teacher_forced_agreement(olmo.model, olmo.ctx, olmo.bank().tree("accurate"), reqs,
                                    results, margins)


def test_tfa_edge_cases(olmo):
    """Empty generations are skipped, a one-token request scores, all-empty
    and misaligned margins raise, non-finite margins fall back to the
    overall rate."""
    overall, high, thr, n_high = _tfa_call(olmo, *_tfa(olmo, [[5, 7, 5], []]))
    assert 0.0 <= overall <= 1.0 and n_high == 3
    overall, high, thr, n_high = _tfa_call(olmo, *_tfa(olmo, [[9]]))
    assert n_high == 1 and high == overall
    with pytest.raises(ValueError, match="no generated tokens"):
        _tfa_call(olmo, *_tfa(olmo, [[], []]))
    reqs, results, margins = _tfa(olmo, [[5, 7]])
    margins[0] = [2.0]
    with pytest.raises(ValueError, match="align"):
        _tfa_call(olmo, reqs, results, margins)
    reqs, results, margins = _tfa(olmo, [[5, 7, 5]])
    margins[0] = [float("nan")] * 3
    overall, high, thr, n_high = _tfa_call(olmo, reqs, results, margins)
    assert n_high == 0 and high == overall
