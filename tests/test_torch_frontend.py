"""PyTorch port: the continuous-batching streaming frontend with chunked
prefill (``repro_torch.serve.frontend``) against the reference's, on the CPU.

The cases of the reference's ``tests/test_frontend.py``, on the same seeded
numpy weights on both sides (``test_torch_mamba2.numpy_params``), exact mode:
greedy chunked streams (``chunk_tokens=2``: every prompt goes through several
chunks) equal the reference frontend's and the port's own ``run()`` for
olmo-1b, internvl2-2b, llama4-maverick, deepseek-v3, mamba2-780m and
zamba2-7b; monolithic, sampled, adaptive and speculative streams too; a late
arrival's stream is its ``run()`` stream; the interleaving bound
(``max_prefill_rows_between_bursts <= chunk_tokens``) holds; cancellation
(mid-prefill, mid-decode, queued), submit-relative deadlines and per-tick
shedding give the reference's outcomes; the API guards, threaded
submitters, the asyncio facade and the CLI's stdin and HTTP drivers.
"""
import asyncio
import io
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import EngineContext as JCtx, FXP16 as J16  # noqa: E402
from repro.core import PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serve.engine import BatchedServer as JServer, Request as JRequest  # noqa: E402
from repro.serve.frontend import ContinuousScheduler as JScheduler  # noqa: E402
from repro.serve.frontend import FrontendConfig as JFrontendConfig  # noqa: E402
from repro.spec import SpecConfig as JSpecConfig  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import FXP16, EngineContext, PrecisionPolicy  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.obs import ServingObserver  # noqa: E402
from repro_torch.resilience import ResilienceConfig  # noqa: E402
from repro_torch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.serve.frontend import (  # noqa: E402
    AsyncFrontend, ContinuousScheduler, FrontendConfig)
from repro_torch.spec import SpecConfig  # noqa: E402
from test_torch_mamba2 import numpy_params, one_torch_thread  # noqa: E402,F401

JEXACT = JCtx(mode="exact", compute_dtype=jnp.float32)
EXACT = EngineContext(mode="exact", compute_dtype=torch.float32, attn_impl="decode_kernel")
JCARMEN = JCtx(mode="carmen", policy=JPolicy.accurate(J16), compute_dtype=jnp.float32)
CARMEN = EngineContext(mode="carmen", policy=PrecisionPolicy.accurate(FXP16),
                       compute_dtype=torch.float32, attn_impl="decode_kernel")
FAMILIES = ("olmo-1b", "internvl2-2b", "llama4-maverick-400b-a17b", "deepseek-v3-671b",
            "mamba2-780m", "zamba2-7b")


def _setup(arch):
    ref_model = ref_get_model(ref_reduced(ref_get_config(arch)))
    model = get_model(reduced(get_config(arch)))
    np_params = numpy_params(ref_model.specs())
    return dict(cfg=model.cfg, ref_model=ref_model, model=model,
                jparams=jax.tree.map(jnp.asarray, np_params),
                params=model.load_numpy(np_params, "cpu"))


def _requests(cfg, n, *, max_new=6, temperature=0.0, seed_base=None, cls=Request):
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, cfg.vocab_size, 3 + i).astype(np.int32), max_new,
                temperature=temperature, seed=None if seed_base is None else seed_base + i)
            for i in range(n)]


def _server(s, ctx=EXACT, **kw):
    kw = {"slots": 2, "max_len": 32, "burst": 4, **kw}
    return BatchedServer(s["model"], ctx, s["params"], device="cpu", **kw)


def _frontend_serve(server, reqs, *, chunk_tokens=2, monolithic=False, scheduler=None,
                    config=None):
    cls, cfg_cls = scheduler or ContinuousScheduler, config or FrontendConfig
    sched = cls(server, cfg_cls(chunk_tokens=chunk_tokens, monolithic_prefill=monolithic))
    with sched:
        for r in reqs:
            sched.submit(r)
        out = sched.drain()
    return out, sched


def _ref_frontend(s, reqs, ctx=JEXACT, monolithic=False, **kw):
    kw = {"slots": 2, "max_len": 32, "burst": 4, **kw}
    server = JServer(s["ref_model"], ctx, s["jparams"], **kw)
    return _frontend_serve(server, reqs, monolithic=monolithic, scheduler=JScheduler,
                           config=JFrontendConfig)[0]


@pytest.fixture(scope="module")
def olmo():
    return _setup("olmo-1b")


# ---------------------------------------------------------------------------
# identity: chunked frontend == run() == the reference's frontend, per family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_frontend_greedy_bit_identical_to_run(arch):
    """dense / vlm / moe / mla / ssm / hybrid: chunk_tokens=2 forces every
    prompt through several chunks; the streams match run() and the
    reference's frontend token for token."""
    s = _setup(arch)
    server = _server(s)
    ref = server.run(_requests(s["cfg"], 3))
    out, sched = _frontend_serve(server, _requests(s["cfg"], 3))
    assert out == ref
    assert out == _ref_frontend(s, _requests(s["cfg"], 3, cls=JRequest))
    assert sched.stats["prefill_rows"] == sum(3 + i for i in range(3))
    # one transfer a prefill (the admit) and a burst
    assert server.host_transfers == 3 + sched.stats["bursts"]


def test_frontend_monolithic_prefill_matches_run(olmo):
    server = _server(olmo)
    ref = server.run(_requests(olmo["cfg"], 3))
    out, _ = _frontend_serve(server, _requests(olmo["cfg"], 3), monolithic=True)
    assert out == ref
    assert out == _ref_frontend(olmo, _requests(olmo["cfg"], 3, cls=JRequest), monolithic=True)


def test_frontend_sampled_streams_match_run(olmo):
    """Sampling depends only on (seed, token index): chunked admission
    reproduces run()'s sampled streams, and the reference's."""
    server = _server(olmo)
    ref = server.run(_requests(olmo["cfg"], 3, temperature=0.8, seed_base=11))
    out, _ = _frontend_serve(server, _requests(olmo["cfg"], 3, temperature=0.8, seed_base=11))
    assert out == ref
    assert out == _ref_frontend(olmo, _requests(olmo["cfg"], 3, temperature=0.8, seed_base=11,
                                                cls=JRequest))


@pytest.fixture(scope="module")
def banks(olmo):
    tbank = rt.build_bank(olmo["params"], "carmen", rt.default_points(FXP16, hifi_fmt=None),
                          specs=olmo["model"].specs())
    jbank = jrt.build_bank(olmo["jparams"], "carmen", jrt.default_points(J16, hifi_fmt=None),
                           specs=olmo["ref_model"].specs())
    return tbank, jbank


def test_frontend_adaptive_matches_run(olmo, banks):
    tbank, jbank = banks

    def build():
        return _server(olmo, CARMEN, bank=tbank, controller=rt.ModeController(
            tbank, rt.ControllerConfig(pin=tbank.reference)))

    ref = build().run(_requests(olmo["cfg"], 3))
    out, _ = _frontend_serve(build(), _requests(olmo["cfg"], 3))
    assert out == ref
    want = _ref_frontend(olmo, _requests(olmo["cfg"], 3, cls=JRequest), JCARMEN, bank=jbank,
                         controller=jrt.ModeController(jbank,
                                                       jrt.ControllerConfig(pin=jbank.reference)))
    assert out == want


def test_frontend_speculative_matches_run(olmo, banks):
    tbank, jbank = banks

    def build():
        return _server(olmo, CARMEN, max_len=40, bank=tbank, speculate=SpecConfig(draft_len=3))

    ref = build().run(_requests(olmo["cfg"], 3))
    out, _ = _frontend_serve(build(), _requests(olmo["cfg"], 3))
    assert out == ref
    want = _ref_frontend(olmo, _requests(olmo["cfg"], 3, cls=JRequest), JCARMEN, max_len=40,
                         bank=jbank, speculate=JSpecConfig(draft_len=3))
    assert out == want


def test_frontend_late_arrival_stream_identical(olmo):
    """A request admitted mid-run (other slots already decoding) gets the
    same stream as in the opening batch."""
    server = _server(olmo, burst=2)
    reqs = _requests(olmo["cfg"], 3, max_new=8)
    ref = server.run(_requests(olmo["cfg"], 3, max_new=8))
    sched = ContinuousScheduler(server, FrontendConfig(chunk_tokens=2))
    with sched:
        sched.submit(reqs[0])
        sched.submit(reqs[1])
        for _ in range(4):
            sched.step()
        sched.submit(reqs[2])  # mid-run arrival
        out = sched.drain()
    assert out == ref


# ---------------------------------------------------------------------------
# interleaving: the chunk budget bounds the prefill stall
# ---------------------------------------------------------------------------


def _interleave_workload(cfg):
    """Two shorts with different budgets plus one 24-token prompt submitted
    mid-run."""
    rng = np.random.default_rng(5)
    short = [Request(0, rng.integers(0, cfg.vocab_size, 3).astype(np.int32), 20),
             Request(1, rng.integers(0, cfg.vocab_size, 4).astype(np.int32), 6)]
    long_req = Request(9, rng.integers(0, cfg.vocab_size, 24).astype(np.int32), 4)
    return short, long_req


def test_interleaving_bound_holds_for_long_prompt(olmo):
    server = _server(olmo, max_len=48, burst=2)
    short, long_req = _interleave_workload(olmo["cfg"])
    sched = ContinuousScheduler(server, FrontendConfig(chunk_tokens=4))
    with sched:
        for r in short:
            sched.submit(r)
        sched.step()
        sched.submit(long_req)
        out = sched.drain()
    assert sched.stats["max_prefill_rows_between_bursts"] > 0
    assert sched.stats["max_prefill_rows_between_bursts"] <= 4
    assert len(out[9]) == 4
    assert out[9] == server.run([Request(9, long_req.prompt.copy(), 4)])[9]


def test_monolithic_contrast_takes_the_stall(olmo):
    server = _server(olmo, max_len=48, burst=2)
    short, long_req = _interleave_workload(olmo["cfg"])
    sched = ContinuousScheduler(server, FrontendConfig(chunk_tokens=4, monolithic_prefill=True))
    with sched:
        for r in short:
            sched.submit(r)
        sched.step()
        sched.submit(long_req)
        sched.drain()
    assert sched.stats["max_prefill_rows_between_bursts"] >= 24


def test_chunk_forwards_and_fresh_row(olmo):
    """Each chunk is one forward at its power-of-two bucket, widened to the
    attention kernels' 16 tensor-core rows where the prompt's own bucket
    reaches them (a 10-row prompt; a 6-row one keeps its chunks' buckets);
    the carry is the server's static row cache and last-logits buffer,
    zeroed in place by fresh_row."""
    server = _server(olmo, max_len=48)
    sched = ContinuousScheduler(server, FrontendConfig(chunk_tokens=4))
    prompts = [np.arange(1, 7, dtype=np.int32), np.arange(1, 11, dtype=np.int32)]
    with sched:
        for rid, prompt in enumerate(prompts):
            sched.submit(Request(rid, prompt, 2))
        out = sched.drain()
    # ticks of 4 rows: [4], [2 | 2], [4], [4]
    assert server.prefill_chunks == 5 and sched._chunk_buckets == {4, 2, 16}
    assert out == server.run([Request(rid, p, 2) for rid, p in enumerate(prompts)])
    row, last = server.fresh_row()
    assert row is server._chunk_row and last is server._chunk_last
    assert not last.any() and all(not t.any() for t in _leaves(row))


def test_chunk_span_keeps_rows_on_run_kernel_path_and_in_the_row_cache(olmo):
    """``chunk_span``: a chunk of a prompt whose bucket reaches 16 rows runs
    at least 16 wide (the attention kernels' tensor-core path, run()'s for
    that prompt); a chunk whose bucket would pass ``max_len`` starts earlier;
    the recurrent families step a row at a time from ``start``."""
    server = _server(olmo, max_len=32)
    assert server.chunk_span(6, 4, 2) == (4, 2)
    assert server.chunk_span(10, 4, 2) == (4, 16)
    assert server.chunk_span(30, 0, 5) == (0, 16)
    assert server.chunk_span(30, 25, 5) == (16, 16)
    assert server.chunk_span(32, 24, 8) == (16, 16)
    assert server.chunk_span(7, 4, 3) == (4, 4)
    s = _setup("mamba2-780m")
    assert _server(s, max_len=32).chunk_span(30, 25, 5) == (25, 8)


def test_chunk_near_max_len_matches_run(olmo):
    """A 30-row prompt at max_len 32 in chunks of 5: the chunks from rows 20
    and 25 would pass the row cache at their 16-row bucket, so they start at
    row 16 and recompute committed rows; the stream and its margins are
    run()'s. (The reference runs the last chunk at bucket 8 from row 25, and
    its KV write clamps the start to row 24: every row of that chunk lands
    on its neighbour's.)"""
    server = _server(olmo, max_len=32)
    prompt = np.random.default_rng(1).integers(0, olmo["cfg"].vocab_size, 30).astype(np.int32)
    want = Request(0, prompt, 2)
    server.run([want])
    sched = ContinuousScheduler(server, FrontendConfig(chunk_tokens=5))
    got = Request(0, prompt, 2)
    with sched:
        sched.submit(got)
        sched.drain()
    assert server.prefill_chunks == 6 and sched._chunk_buckets == {16}
    assert got.generated == want.generated
    np.testing.assert_allclose(got.margins, want.margins, rtol=0, atol=1e-5)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# cancellation: mid-prefill, mid-decode, queued
# ---------------------------------------------------------------------------


def test_cancel_mid_prefill_frees_slot_no_leak(olmo):
    server = _server(olmo, slots=1, resilience=ResilienceConfig())
    server.observer = ServingObserver()
    ref = server.run(_requests(olmo["cfg"], 1, max_new=6))
    rng = np.random.default_rng(5)
    victim = Request(50, rng.integers(0, olmo["cfg"].vocab_size, 12).astype(np.int32), 6)
    sched = ContinuousScheduler(server, FrontendConfig(chunk_tokens=2))
    with sched:
        handle = sched.submit(victim)
        sched.step()  # 2 of 12 prompt rows done: mid-prefill
        assert sched.job is not None and sched.job.done == 2
        handle.cancel()
        sched.step()
        assert sched.job is None and sched.free == [0]
        assert handle.done and handle.status == "aborted"
        assert handle.outcome.reason == "cancelled"
        assert handle.tokens == []
        for r in _requests(olmo["cfg"], 1, max_new=6):
            sched.submit(r)
        out = sched.drain()
    assert out[0] == ref[0]  # the slot's next tenant is untouched by the corpse
    assert 50 not in out
    snap = server.observer.snapshot()
    assert snap["metrics"]["counters"]["cancelled"] == 1
    assert snap["requests"][50]["tokens"] == 0
    assert snap["requests"][50]["ttft_s"] is None
    assert [e for e in server.observer.trace.events
            if e["name"] == "request_prefilled" and e["args"]["rid"] == 50] == []


def test_cancel_mid_decode_keeps_partial_tokens(olmo):
    server = _server(olmo, max_len=64, burst=2, resilience=ResilienceConfig())
    ref = server.run(_requests(olmo["cfg"], 1, max_new=40))
    sched = ContinuousScheduler(server, FrontendConfig(chunk_tokens=4))
    with sched:
        handle = sched.submit(_requests(olmo["cfg"], 1, max_new=40)[0])
        while len(handle.tokens) < 5:
            sched.step()
        handle.cancel()
        out = sched.drain()
    assert handle.status == "aborted" and handle.outcome.reason == "cancelled"
    assert 0 < len(handle.tokens) < 40
    assert out[0] == ref[0][:len(out[0])]
    assert server.snapshot()["resilience"]["counters"]["aborted"] == 1


def test_cancel_queued_request_never_prefills(olmo):
    server = _server(olmo, slots=1, resilience=ResilienceConfig())
    sched = ContinuousScheduler(server, FrontendConfig(chunk_tokens=8))
    with sched:
        first = sched.submit(_requests(olmo["cfg"], 1, max_new=12)[0])
        queued = sched.submit(Request(7, np.arange(1, 5, dtype=np.int32), 6))
        sched.step()  # first occupies the only slot; 7 waits
        queued.cancel()
        out = sched.drain()
    assert queued.status == "aborted" and queued.tokens == []
    assert first.status == "ok" and len(out[0]) == 12
    assert 7 not in out


# ---------------------------------------------------------------------------
# submit-relative deadlines + per-tick shed sweeps
# ---------------------------------------------------------------------------


def test_deadline_counts_from_submit(olmo):
    server = _server(olmo, slots=1, resilience=ResilienceConfig(default_deadline_s=30.0))
    sched = ContinuousScheduler(server, FrontendConfig(chunk_tokens=8))
    with sched:
        doomed = sched.submit(Request(0, np.arange(1, 4, dtype=np.int32), 4, deadline_s=0.03))
        time.sleep(0.15)  # expires before the first tick ever sees it
        fine = sched.submit(Request(1, np.arange(1, 4, dtype=np.int32), 4))
        out = sched.drain()
    assert doomed.status == "shed" and doomed.outcome.reason == "deadline_expired"
    assert fine.status == "ok" and len(out[1]) == 4
    assert doomed.request.deadline_s == 0.03 and fine.request.deadline_s is None


def test_queue_overflow_sheds_per_tick(olmo):
    server = _server(olmo, slots=1, burst=2, resilience=ResilienceConfig(queue_limit=1))
    sched = ContinuousScheduler(server, FrontendConfig(chunk_tokens=8))
    with sched:
        running = sched.submit(_requests(olmo["cfg"], 1, max_new=12)[0])
        sched.step()  # occupies the slot
        waiters = [sched.submit(Request(10 + i, np.arange(1, 4, dtype=np.int32), 4))
                   for i in range(3)]
        sched.drain()
    assert running.status == "ok"
    assert sorted(h.status for h in waiters) == ["ok", "shed", "shed"]
    assert all(h.outcome.reason == "queue_full" for h in waiters if h.status == "shed")


def test_legacy_contract_raises_at_submit(olmo):
    server = _server(olmo, slots=1, max_len=8, burst=2)
    sched = ContinuousScheduler(server, FrontendConfig())
    with sched:
        with pytest.raises(ValueError, match="exceeds max_len"):
            sched.submit(Request(0, np.arange(1, 30, dtype=np.int32), 4))
        with pytest.raises(ValueError, match="empty prompt"):
            sched.submit(Request(1, np.zeros(0, dtype=np.int32), 4))


# ---------------------------------------------------------------------------
# API guards
# ---------------------------------------------------------------------------


def test_duplicate_rid_rejected(olmo):
    server = _server(olmo, slots=1, burst=2)
    sched = ContinuousScheduler(server, FrontendConfig())
    with sched:
        sched.submit(Request(3, np.arange(1, 4, dtype=np.int32), 2))
        with pytest.raises(ValueError, match="duplicate rid"):
            sched.submit(Request(3, np.arange(1, 4, dtype=np.int32), 2))
        sched.drain()


def test_submit_requires_open_and_close_is_final(olmo):
    server = _server(olmo, slots=1, burst=2)
    sched = ContinuousScheduler(server, FrontendConfig())
    with pytest.raises(RuntimeError, match="not open"):
        sched.submit(Request(0, np.arange(1, 4, dtype=np.int32), 2))
    with sched:
        pass
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(Request(0, np.arange(1, 4, dtype=np.int32), 2))


def test_mesh_server_rejected(olmo):
    """The port serves no mesh yet; a server that carries one is refused as
    the reference refuses it, and so are its chunk programs."""
    server = _server(olmo, slots=1, burst=2)
    server.mesh = object()
    with pytest.raises(ValueError, match="single-device"):
        ContinuousScheduler(server)
    with pytest.raises(ValueError, match="single-device"):
        server.chunk_fns()


def test_frontend_config_validation():
    with pytest.raises(ValueError):
        FrontendConfig(chunk_tokens=0)


def test_close_settles_in_flight_as_shutdown(olmo):
    server = _server(olmo, slots=1, max_len=64, burst=2, resilience=ResilienceConfig())
    sched = ContinuousScheduler(server, FrontendConfig(chunk_tokens=8))
    with sched:
        h = sched.submit(_requests(olmo["cfg"], 1, max_new=30)[0])
        sched.step()
        sched.step()
    assert h.done and h.status == "aborted" and h.outcome.reason == "shutdown"
    assert 0 < len(h.tokens) < 30


def test_trace_header_carries_the_frontend(olmo):
    server = _server(olmo, observer=ServingObserver())
    _frontend_serve(server, _requests(olmo["cfg"], 2), chunk_tokens=3)
    header = server.observer.trace.events[0]["args"]
    assert header["frontend"] == {"chunk_tokens": 3, "monolithic_prefill": False}


# ---------------------------------------------------------------------------
# threads + asyncio facade
# ---------------------------------------------------------------------------


def test_threaded_submitters_one_scheduler(olmo):
    server = _server(olmo)
    ref = server.run(_requests(olmo["cfg"], 4))
    sched = ContinuousScheduler(server, FrontendConfig(chunk_tokens=2))
    with sched:
        threads = [threading.Thread(target=sched.submit, args=(r,))
                   for r in _requests(olmo["cfg"], 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        out = sched.drain()
    assert out == ref


def test_async_frontend_generate_and_stream(olmo):
    server = _server(olmo)
    ref = server.run(_requests(olmo["cfg"], 2))

    async def go():
        async with AsyncFrontend(server, FrontendConfig(chunk_tokens=2)) as fe:
            reqs = _requests(olmo["cfg"], 2)
            task = asyncio.ensure_future(fe.generate(reqs[0]))
            streamed = [tok async for tok in fe.stream(reqs[1])]
            return await task, streamed

    generated, streamed = asyncio.run(go())
    assert generated == ref[0] and streamed == ref[1]


def test_async_frontend_cancellation(olmo):
    server = _server(olmo, slots=1, max_len=64, burst=2, resilience=ResilienceConfig())
    fe = AsyncFrontend(server, FrontendConfig(chunk_tokens=4)).start()
    try:
        handle = fe.submit(_requests(olmo["cfg"], 1, max_new=40)[0])
        deadline = time.monotonic() + 60
        while len(handle.tokens) < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        handle.cancel()
        handle.result(timeout=30.0)
    finally:
        fe.stop()
    assert handle.status == "aborted" and handle.outcome.reason == "cancelled"
    assert 0 < len(handle.tokens) < 40


# ---------------------------------------------------------------------------
# the CLI's drivers
# ---------------------------------------------------------------------------

CLI = ["--arch", "olmo-1b", "--reduced", "--requests", "3", "--slots", "2", "--max-new", "4",
       "--prompt-len", "10", "--device", "cpu"]


def test_cli_frontend_streams_equal_run(capsys):
    from repro_torch.launch.serve import main

    ref = main(CLI + ["--mode", "carmen"])
    out = main(CLI + ["--mode", "carmen", "--frontend", "--chunk-tokens", "4"])
    assert out == ref
    assert "frontend: ticks=" in capsys.readouterr().out
    # Poisson arrivals and the monolithic arm serve the same streams
    assert main(CLI + ["--mode", "carmen", "--frontend", "--arrival-rate", "200",
                       "--arrival-seed", "3", "--monolithic-prefill"]) == ref


def test_cli_stdin_driver(monkeypatch, capsys):
    from repro_torch.launch import serve

    captured = {}
    monkeypatch.setattr(serve, "_serve_frontend",
                        lambda args, server, reqs: captured.update(args=args, server=server)
                        or {})
    serve.main(CLI + ["--mode", "exact", "--stdin-requests"])
    lines = [json.dumps({"rid": 0, "prompt": [5, 17, 3], "max_new": 4}),
             json.dumps({"rid": 1, "prompt": [], "max_new": 4})]
    capsys.readouterr()
    out = serve._serve_stdin(captured["args"], captured["server"],
                             stdin=io.StringIO("\n".join(lines) + "\n"))
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(out[0]) == 4
    assert [p["token"] for p in printed if p.get("rid") == 0 and "token" in p] == out[0]
    assert {"rid": 1, "done": True, "status": "rejected"}.items() <= [
        p for p in printed if p.get("rid") == 1][0].items()


def test_cli_http_driver(monkeypatch):
    import urllib.request

    from repro_torch.launch import serve

    captured = {}
    monkeypatch.setattr(serve, "_serve_frontend",
                        lambda args, server, reqs: captured.update(args=args, server=server)
                        or {})
    serve.main(CLI + ["--mode", "exact", "--http-port", "0"])
    ready = threading.Event()
    result = {}
    t = threading.Thread(target=lambda: result.update(
        out=serve._serve_http(captured["args"], captured["server"], ready=ready)), daemon=True)
    t.start()
    assert ready.wait(30)
    port = ready.server.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        body = json.dumps({"rid": 4, "prompt": [5, 17, 3], "max_new": 4}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            reply = json.loads(r.read())
    finally:
        ready.server.shutdown()
        t.join(timeout=30)
    assert not t.is_alive()
    assert reply["rid"] == 4 and reply["status"] == "ok" and len(reply["tokens"]) == 4
    assert result["out"] == {4: reply["tokens"]}
