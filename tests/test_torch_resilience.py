"""PyTorch port: fault-tolerant serving (``repro_torch.resilience``; the
server's ``resilience=``, ``injector=`` and the burst's fault flag) against
the reference, on the CPU.

Reduced olmo-1b (and reduced deepseek-v3 where the reference parametrises
by arch) in kernel mode, the same numpy weights on both sides, the bank's
approx and accurate FxP8 points. Each case runs the same fault plan through
both servers and holds the port to the reference exactly: every request's
stream, its ``RequestOutcome`` status, reason and token count, and the
fault counters (wall-clock fields excluded). The isolation contract is held
on the port itself: the slots a fault does not touch serve the fault-free
run's streams bit for bit.

In kernel mode a NaN does not reach a logit: every projection quantizes
its input (NaN to 0, saturating), so a NaN-poisoned slot or point changes
its stream and stays ``ok``, on both sides. The quarantine paths are driven
by ``logit_limit`` (0.8 flags some lanes mid-stream here, and not others),
and the host's handling of the speculative round's flags and of a
non-finite prefill margin by setting the flag or the margin on both
servers at the same round.
"""
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import resilience as jres  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro import spec as jspec  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import FXP8 as J8  # noqa: E402
from repro.core import EngineContext as JCtx, PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.obs import ServingObserver as JObserver  # noqa: E402
from repro.serve.engine import BatchedServer as JServer, Request as JRequest  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import FXP8, EngineContext, PrecisionPolicy  # noqa: E402
from repro_torch.core.backends.base import PreparedWeight  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.obs import ServingObserver  # noqa: E402
from repro_torch.obs.trace import TraceRecorder, read_trace  # noqa: E402
from repro_torch.resilience import (  # noqa: E402
    DegradationConfig,
    DegradationPolicy,
    DelayFault,
    FaultInjector,
    NaNCacheFault,
    NaNWeightFault,
    RequestOutcome,
    ResilienceConfig,
    oversized_request,
    poison_cache_slot,
    poison_tree,
    shed_overflow,
)
from repro_torch.runtime import ControllerConfig, ModeController, StepSignals  # noqa: E402
from repro_torch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401
from test_torch_serving import _numpy_params  # noqa: E402

LIMIT = 0.8  # a logit limit that flags some lanes mid-stream on these weights


class Arch:
    """One arch's reference and port sides on the same numpy weights."""

    def __init__(self, arch, layers=None):
        kw = {"layers": layers} if layers else {}
        self.ref_model = ref_get_model(ref_reduced(ref_get_config(arch), **kw))
        self.np_params = _numpy_params(
            jax.tree.map(np.asarray, self.ref_model.init(jax.random.PRNGKey(0))))
        self.cfg = reduced(get_config(arch), **kw)
        self.model = get_model(self.cfg)
        self.jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32,
                         attn_impl="decode_kernel")
        self.ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                                 compute_dtype=torch.float32, attn_impl="decode_kernel")

    def jparams(self):
        return jax.tree.map(jnp.asarray, self.np_params)

    def params(self):
        return self.model.load_numpy(self.np_params, "cpu")

    def bank(self):
        return rt.build_bank(self.params(), "kernel", rt.default_points(FXP8, hifi_fmt=None),
                             specs=self.model.specs())

    def jbank(self):
        return jrt.build_bank(self.jparams(), "kernel", jrt.default_points(J8, hifi_fmt=None),
                              specs=self.ref_model.specs())

    def server(self, **kw):
        return BatchedServer(self.model, self.ctx, self.params(), device="cpu", **kw)

    def jserver(self, **kw):
        return JServer(self.ref_model, self.jctx, self.jparams(), **kw)


@pytest.fixture(scope="module")
def olmo():
    return Arch("olmo-1b")


@pytest.fixture(scope="module")
def deepseek():
    return Arch("deepseek-v3-671b", layers=4)


def _requests(cls, cfg, n, *, prompt_len=5, max_new=10, deadline_s=None):
    rng = np.random.default_rng(2)
    return [cls(i, rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32), max_new,
                deadline_s=deadline_s)
            for i in range(n)]


def _outcomes(server):
    return {rid: (o.status, o.reason, o.tokens) for rid, o in server.outcomes.items()}


def _same_as_reference(srv, out, jsrv, jout):
    assert out == jout
    assert _outcomes(srv) == _outcomes(jsrv)
    assert srv._fault_counts == jsrv._fault_counts


# ---------------------------------------------------------------------------
# fault isolation: the acceptance-criterion matrix
# ---------------------------------------------------------------------------


def _isolation_case(a, *, spec=False, controller_factory=None, limit=None):
    """The fault-free run and the one-slot-NaN run on the port, the NaN run
    on the reference: the port equals the reference, and on the port the
    untouched slots serve the fault-free streams."""
    res = dict(resilience=ResilienceConfig(logit_limit=limit))
    jres_kw = dict(resilience=jres.ResilienceConfig(logit_limit=limit))
    kw = dict(slots=4, max_len=64, burst=4)
    bank = jbank = None
    if spec or controller_factory is not None:
        bank, jbank = a.bank(), a.jbank()
    if spec:
        kw.update(speculate=SpecConfig(draft_len=3))

    def build(injector=None):
        ctl = controller_factory(bank) if controller_factory is not None else None
        return a.server(injector=injector, controller=ctl, bank=bank, **kw, **res)

    ref = build()
    ref_out = ref.run(_requests(Request, a.cfg, 3))
    srv = build(FaultInjector(NaNCacheFault(rid=1, at_round=1)))
    out = srv.run(_requests(Request, a.cfg, 3))
    assert srv.injector.fired and srv.injector.fired[0][0] == 1
    jkw = dict(kw, speculate=jspec.SpecConfig(draft_len=3)) if spec else dict(kw)
    jctl = (controller_factory(jbank, ref_side=True)
            if controller_factory is not None else None)
    jsrv = a.jserver(injector=jres.FaultInjector(jres.NaNCacheFault(rid=1, at_round=1)),
                     controller=jctl, bank=jbank, **jkw, **jres_kw)
    jout = jsrv.run(_requests(JRequest, a.cfg, 3))
    _same_as_reference(srv, out, jsrv, jout)
    for rid in (0, 2):  # the slots the fault does not touch
        assert out[rid] == ref_out[rid]
        assert _outcomes(srv)[rid] == _outcomes(ref)[rid]
    if limit is None:
        # kernel mode launders the NaN: the poisoned slot's stream changes,
        # nothing is quarantined, and what it committed before the fault is
        # the fault-free run's
        assert all(o.status == "ok" for o in srv.outcomes.values())
        assert out[1] != ref_out[1] and out[1][:2] == ref_out[1][:2]
    return srv, ref


@pytest.mark.parametrize("arch", ["olmo", "deepseek"])
def test_fault_isolation_burst(request, arch):
    """Dense and MoE+MLA: a NaN-poisoned KV slot changes that slot alone;
    the port's streams and outcomes are the reference's."""
    _isolation_case(request.getfixturevalue(arch))


def test_fault_isolation_speculative(olmo):
    """The same through the draft/verify round (draft_len 3)."""
    _isolation_case(olmo, spec=True)


def test_fault_isolation_adaptive(olmo):
    """With a ModeController pinned at the reference point."""

    def pinned(bank, ref_side=False):
        mc, cc = ((jrt.ModeController, jrt.ControllerConfig) if ref_side
                  else (ModeController, ControllerConfig))
        return mc(bank, cc(pin=bank.reference))

    _isolation_case(olmo, controller_factory=pinned)


def test_logit_limit_quarantines_like_reference(olmo):
    """``logit_limit`` flags lanes whose logits pass ±0.8: each flagged
    request commits exactly the steps before its first flagged logit and is
    quarantined with ``decode_nonfinite``, as on the reference; the NaN
    slot's laundered logits stay under the limit and it completes."""
    srv, ref = _isolation_case(olmo, limit=LIMIT)
    statuses = {o.status for o in srv.outcomes.values()}
    assert statuses == {"ok", "faulted"}
    faulted = [o for o in srv.outcomes.values() if o.status == "faulted"]
    assert all(o.reason == "decode_nonfinite" for o in faulted)
    assert any(0 < o.tokens < 10 for o in faulted)  # cut mid-stream
    assert srv._fault_counts["faulted"] == len(faulted)


def test_spec_draft_fault_degrades_to_accurate(olmo):
    """NaN draft weights (integer banks zeroed, as the reference's NaN
    grid casts to 0): every draft is rejected, each round commits the
    verify point's token, the streams equal a healthy run's and the
    reference's, and nothing is quarantined."""
    kw = dict(slots=4, max_len=64, speculate=SpecConfig(draft_len=3),
              resilience=ResilienceConfig())
    ref = olmo.server(bank=olmo.bank(), **kw)
    ref_out = ref.run(_requests(Request, olmo.cfg, 3))
    bank = olmo.bank()
    srv = olmo.server(bank=bank, injector=FaultInjector(
        NaNWeightFault(at_round=1, point=bank.names[0])), **kw)
    out = srv.run(_requests(Request, olmo.cfg, 3))
    assert out == ref_out
    assert all(o.status == "ok" for o in srv.outcomes.values())
    # zero drafts are rejected: at least as many rounds as the healthy run
    assert srv.spec_telemetry.summary()["rounds"] >= ref.spec_telemetry.summary()["rounds"]
    jbank = olmo.jbank()
    jsrv = olmo.jserver(bank=jbank, slots=4, max_len=64,
                        speculate=jspec.SpecConfig(draft_len=3),
                        resilience=jres.ResilienceConfig(),
                        injector=jres.FaultInjector(jres.NaNWeightFault(
                            at_round=1, point=jbank.names[0])))
    jout = jsrv.run(_requests(JRequest, olmo.cfg, 3))
    _same_as_reference(srv, out, jsrv, jout)
    assert srv.spec_telemetry.summary() == jsrv.spec_telemetry.summary()


def _flag_round(server, at_round, slot, which):
    """Set the speculative round's draft (``which`` 3) or verify (4) fault
    flag of ``slot`` at round ``at_round`` (the two servers' ``spec.round``
    return them at the same places)."""
    inner, calls = server.spec.round, [0]

    def flagged(*args, **kw):
        out = list(inner(*args, **kw))
        if calls[0] == at_round:
            flags = np.array(out[which], dtype=bool)
            flags[slot] = True
            out[which] = flags
        calls[0] += 1
        return tuple(out)

    server.spec.round = flagged


def test_spec_fault_flags_handled_like_reference(olmo):
    """A verify-faulted lane commits nothing from its round and is
    quarantined (``verify_nonfinite``); a draft-faulted lane commits and
    stays admitted, named in the round's trace span. Flags set at the same
    rounds on both servers: the port's outcomes, streams and trace spans
    are the reference's."""
    kw = dict(slots=4, max_len=64)
    srv = olmo.server(bank=olmo.bank(), speculate=SpecConfig(draft_len=3),
                      resilience=ResilienceConfig(), observer=ServingObserver(), **kw)
    jsrv = olmo.jserver(bank=olmo.jbank(), speculate=jspec.SpecConfig(draft_len=3),
                        resilience=jres.ResilienceConfig(), observer=JObserver(), **kw)
    for s in (srv, jsrv):
        _flag_round(s, 1, 1, 4)
        _flag_round(s, 0, 2, 3)
    out = srv.run(_requests(Request, olmo.cfg, 3))
    jout = jsrv.run(_requests(JRequest, olmo.cfg, 3))
    _same_as_reference(srv, out, jsrv, jout)
    assert srv.outcomes[1].status == "faulted" and srv.outcomes[1].reason == "verify_nonfinite"
    assert srv.outcomes[2].status == "ok"

    def spans(s):
        return [(e["name"], e["args"].get("draft_faults"), e["args"].get("tokens"))
                for e in s.observer.trace.events if e["ph"] == "E" and e["name"] == "spec"]

    assert spans(srv) == spans(jsrv)
    assert spans(srv)[0][1] == [2]


def test_prefill_fault_quarantines_before_commit(olmo):
    """A non-finite prefill margin means token 0 is garbage: the request is
    quarantined with zero tokens (``prefill_nonfinite``) and its slot
    reused; here the margin of request 1's prefill is set to NaN on both
    servers (a kernel-mode logit cannot go non-finite)."""

    def poison_prefill(server):
        inner = server._prefill_slot

        def prefill(slot, req):
            inner(slot, req)
            if req.rid == 1:
                req.margins[0] = float("nan")

        server._prefill_slot = prefill

    srv = olmo.server(slots=1, max_len=64, burst=4, resilience=ResilienceConfig())
    jsrv = olmo.jserver(slots=1, max_len=64, burst=4, resilience=jres.ResilienceConfig())
    for s in (srv, jsrv):
        poison_prefill(s)
    out = srv.run(_requests(Request, olmo.cfg, 3))
    jout = jsrv.run(_requests(JRequest, olmo.cfg, 3))
    _same_as_reference(srv, out, jsrv, jout)
    assert srv.outcomes[1].status == "faulted"
    assert srv.outcomes[1].reason == "prefill_nonfinite"
    assert out[1] == [] and srv.outcomes[2].status == "ok"


def test_nan_weights_serve_zero_logits_like_reference(olmo):
    """A NaN weight fault on the served point at round 0 (slots=1): the
    reference's NaN grid casts to 0, the port's banks are zeroed, so both
    serve all-zero logits (token 0) from then on, request 1's prefill
    included; nothing is flagged in kernel mode."""
    bank, jbank = olmo.bank(), olmo.jbank()
    srv = olmo.server(slots=1, max_len=64, burst=4, bank=bank,
                      controller=ModeController(bank, ControllerConfig(pin="accurate")),
                      resilience=ResilienceConfig(),
                      injector=FaultInjector(NaNWeightFault(at_round=0, point="accurate")))
    jsrv = olmo.jserver(slots=1, max_len=64, burst=4, bank=jbank,
                        controller=jrt.ModeController(jbank, jrt.ControllerConfig(pin="accurate")),
                        resilience=jres.ResilienceConfig(),
                        injector=jres.FaultInjector(jres.NaNWeightFault(at_round=0,
                                                                        point="accurate")))
    out = srv.run(_requests(Request, olmo.cfg, 2))
    jout = jsrv.run(_requests(JRequest, olmo.cfg, 2))
    _same_as_reference(srv, out, jsrv, jout)
    assert out[1] == [0] * 10 and all(o.status == "ok" for o in srv.outcomes.values())


# ---------------------------------------------------------------------------
# in-place faults: the captured graphs keep their addresses
# ---------------------------------------------------------------------------


def test_nan_cache_fault_writes_in_place(olmo):
    """The cache fault writes NaN into the slot's rows of the server's own
    cache tensors (a captured graph replays their addresses), leaves the
    other slots and the write indices untouched, and is refused by the
    recurrent-state families."""
    srv = olmo.server(slots=3, max_len=16)
    leaves = {k: dict(v) for k, v in srv.cache.items()}
    before = {k: {n: t.clone() for n, t in v.items()} for k, v in srv.cache.items()}
    NaNCacheFault(rid=5, at_round=0).apply(srv, {5: 1})
    for seg, tree in srv.cache.items():
        for name, t in tree.items():
            assert t is leaves[seg][name]
            if t.is_floating_point():
                assert torch.isnan(t[:, 1]).all()
                assert torch.equal(t[:, [0, 2]], before[seg][name][:, [0, 2]])
            else:
                assert torch.equal(t, before[seg][name])
    with pytest.raises(ValueError, match="not active"):
        NaNCacheFault(rid=9, at_round=0).apply(srv, {5: 1})
    mamba = get_model(reduced(get_config("mamba2-780m")))
    ssm = BatchedServer(mamba, olmo.ctx, mamba.init(torch.Generator().manual_seed(0)),
                        slots=1, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="scatterable"):
        NaNCacheFault(rid=0, at_round=0).apply(ssm, {0: 0})
    assert poison_cache_slot(leaves, 0, layer=0) is leaves


def test_weight_fault_poisons_only_its_point(olmo):
    """Poisoning one bank point gives it private copies of the leaves it
    matches (f32 NaN, integer banks zero in their K-major layout) and drops
    only that point's graphs; the other points keep their trees, leaf for
    leaf, and the graphs that read them."""
    bank = olmo.bank()
    approx, accurate = (dict(bank.tree(n)) for n in bank.names)
    srv = olmo.server(bank=bank, controller=ModeController(bank, ControllerConfig(pin="accurate")))
    srv.programs.graphs.update({n: None for n in ("burst greedy @approx", "prefill 8 @approx",
                                                   "burst greedy @accurate",
                                                   "prefill 8 @accurate")})
    srv.programs._outs.update({n: None for n in srv.programs.graphs})
    NaNWeightFault(at_round=0, point="approx", layer="attn").apply(srv, {})
    assert sorted(srv.programs.graphs) == ["burst greedy @accurate", "prefill 8 @accurate"]
    assert all(bank.tree("accurate")[k] is v for k, v in accurate.items())
    new = bank.tree("approx")
    assert new["embed"] is approx["embed"]  # unmatched: shared
    old_wq, new_wq = approx["seg0_dense"]["attn"]["wq"], new["seg0_dense"]["attn"]["wq"]
    assert isinstance(new_wq, PreparedWeight) and new_wq.data is not old_wq.data
    assert new_wq.data.stride() == old_wq.data.stride() and not new_wq.data.any()
    assert torch.equal(new_wq.point, old_wq.point)
    assert bool(old_wq.data.any())  # the shared leaf stays clean
    full = poison_tree({"w": torch.ones(3), "i": torch.ones(2, dtype=torch.int32)})
    assert torch.isnan(full["w"]).all() and torch.equal(full["i"], torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="no float weight leaf"):
        poison_tree(approx, "nothing-matches")
    static = olmo.server()
    static.programs.graphs.update({"burst greedy": None, "prefill finish": None})
    static.programs._outs.update({"burst greedy": None, "prefill finish": None})
    NaNWeightFault(at_round=0, layer="embed").apply(static, {})
    assert list(static.programs.graphs) == ["prefill finish"]
    assert torch.isnan(static.params["embed"]).all()


# ---------------------------------------------------------------------------
# admission control and shedding
# ---------------------------------------------------------------------------


def test_oversized_prompt_shed_not_crash(olmo):
    """prompt + max_new > max_len is shed with reason too_long; the rest of
    the batch serves normally."""
    srv = olmo.server(slots=2, max_len=16, burst=4, resilience=ResilienceConfig())
    out = srv.run(_requests(Request, olmo.cfg, 2, max_new=4) + [oversized_request(9, 16)])
    jsrv = olmo.jserver(slots=2, max_len=16, burst=4, resilience=jres.ResilienceConfig())
    jout = jsrv.run(_requests(JRequest, olmo.cfg, 2, max_new=4)
                    + [jres.oversized_request(9, 16)])
    _same_as_reference(srv, out, jsrv, jout)
    assert srv.outcomes[9].status == "shed" and srv.outcomes[9].reason == "too_long"
    assert 9 not in out and all(len(out[r]) == 4 for r in (0, 1))
    empty = Request(3, np.zeros((0,), np.int32), 4)
    srv.run([empty])
    assert _outcomes(srv) == {3: ("shed", "empty_prompt", 0)}


def test_legacy_contract_still_raises(olmo):
    """resilience=None keeps the fail-stop ValueError."""
    srv = olmo.server(slots=1, max_len=16, burst=4)
    with pytest.raises(ValueError, match="exceeds max_len"):
        srv.run([oversized_request(0, 16)])


def test_queue_limit_sheds_with_reason(olmo):
    """queue_limit bounds admitted work; every rejected request carries a
    structured shed outcome, and the survivors complete."""
    srv = olmo.server(slots=2, max_len=64, burst=4, resilience=ResilienceConfig(queue_limit=3))
    out = srv.run(_requests(Request, olmo.cfg, 6, max_new=4))
    jsrv = olmo.jserver(slots=2, max_len=64, burst=4,
                        resilience=jres.ResilienceConfig(queue_limit=3))
    jout = jsrv.run(_requests(JRequest, olmo.cfg, 6, max_new=4))
    _same_as_reference(srv, out, jsrv, jout)
    shed = {r: o for r, o in srv.outcomes.items() if o.status == "shed"}
    assert len(shed) == 3 and all(o.reason == "queue_full" for o in shed.values())
    assert all(len(out[r]) == 4 for r in out) and srv._fault_counts["shed"] == 3


@pytest.mark.parametrize("policy", ["reject_newest", "reject_largest", "deadline_aware"])
def test_shed_policies(policy):
    """The three shed policies pick the reference's victims from one queue."""
    def queue(cls):
        return [cls(0, np.arange(2, dtype=np.int32), 4, deadline_s=None),
                cls(1, np.arange(9, dtype=np.int32), 4, deadline_s=0.5),
                cls(2, np.arange(5, dtype=np.int32), 4, deadline_s=9.0),
                cls(3, np.arange(3, dtype=np.int32), 4, deadline_s=2.0)]

    kept, shed = shed_overflow(queue(Request), 2, policy)
    jkept, jshed = jres.shed_overflow(queue(JRequest), 2, policy)
    assert [r.rid for r in kept] == [r.rid for r in jkept]
    assert [r.rid for r in shed] == [r.rid for r in jshed]
    want = {"reject_newest": [0, 1], "reject_largest": [0, 3], "deadline_aware": [0, 2]}
    assert [r.rid for r in kept] == want[policy]


def test_shed_overflow_noop_under_limit():
    reqs = [Request(0, np.arange(3, dtype=np.int32), 2)]
    kept, shed = shed_overflow(list(reqs), 4, "reject_newest")
    assert kept == reqs and shed == []


# ---------------------------------------------------------------------------
# deadlines (host time at burst boundaries; driven by DelayFault)
# ---------------------------------------------------------------------------


def test_deadline_expiry_keeps_partial_tokens(olmo):
    """A delay past every deadline before round 1 expires the active slots
    at its boundary; their partial streams survive, as on the reference
    (token counts depend on host time and are not compared)."""
    srv = olmo.server(slots=4, max_len=64, burst=4,
                      resilience=ResilienceConfig(default_deadline_s=0.5),
                      injector=FaultInjector(DelayFault(at_round=1, seconds=1.0)))
    out = srv.run(_requests(Request, olmo.cfg, 3, max_new=24))
    assert all((o.status, o.reason) == ("expired", "deadline") for o in srv.outcomes.values())
    assert all(0 < len(v) < 24 for v in out.values())
    assert srv._fault_counts["deadline_misses"] == 3
    assert all(not o.deadline_met for o in srv.outcomes.values())
    jsrv = olmo.jserver(slots=4, max_len=64, burst=4,
                        resilience=jres.ResilienceConfig(default_deadline_s=0.5),
                        injector=jres.FaultInjector(jres.DelayFault(at_round=1, seconds=1.0)))
    jsrv.run(_requests(JRequest, olmo.cfg, 3, max_new=24))
    assert ({r: o[:2] for r, o in _outcomes(srv).items()}
            == {r: o[:2] for r, o in _outcomes(jsrv).items()})
    assert srv._fault_counts == jsrv._fault_counts


def test_queued_requests_expire_without_prefill(olmo):
    """A request whose deadline passes while queued is shed, never
    prefilled."""
    srv = olmo.server(slots=1, max_len=64, burst=4, resilience=ResilienceConfig(),
                      injector=FaultInjector(DelayFault(at_round=0, seconds=0.3)))
    reqs = _requests(Request, olmo.cfg, 1, max_new=8)
    reqs.append(Request(7, np.arange(1, 6, dtype=np.int32), 8, deadline_s=0.05))
    srv.run(reqs)
    assert (srv.outcomes[7].status, srv.outcomes[7].reason) == ("shed", "deadline_expired")
    assert srv.outcomes[0].status == "ok" and srv.prefill_calls == 1


def test_per_request_deadline_overrides_default(olmo):
    srv = olmo.server(slots=2, max_len=64, burst=4,
                      resilience=ResilienceConfig(default_deadline_s=0.001))
    reqs = _requests(Request, olmo.cfg, 2, max_new=4)
    reqs[0].deadline_s = 60.0
    srv.run(reqs)
    assert srv.outcomes[0].status == "ok"
    assert srv.outcomes[1].status in ("expired", "ok")
    assert srv.outcomes[1].deadline_s == 0.001


def test_run_never_mutates_caller_requests(olmo):
    """Deadline resolution is run-local: the same request list served by two
    servers with different defaults keeps ``deadline_s`` None, and each run
    resolves its own server's default."""
    reqs = _requests(Request, olmo.cfg, 2, max_new=4)
    generous = olmo.server(slots=2, max_len=64, burst=4,
                           resilience=ResilienceConfig(default_deadline_s=120.0))
    generous.run(reqs)
    assert all(r.deadline_s is None for r in reqs)
    assert all(o.deadline_s == 120.0 for o in generous.outcomes.values())
    tight = olmo.server(slots=2, max_len=64, burst=4,
                        resilience=ResilienceConfig(default_deadline_s=0.002))
    tight.run(reqs)
    assert all(r.deadline_s is None for r in reqs)
    assert all(o.deadline_s == 0.002 for o in tight.outcomes.values())


# ---------------------------------------------------------------------------
# outcomes and aborted-run attribution
# ---------------------------------------------------------------------------


def _snapshot_outcomes(server):
    return {rid: {k: v for k, v in o.items() if k != "wall_s"}
            for rid, o in server.snapshot()["resilience"]["outcomes"].items()}


def test_outcomes_recorded_without_resilience(olmo):
    """Outcome bookkeeping is unconditional: a legacy run's snapshot holds
    every request's outcome, as the reference's does."""
    srv = olmo.server(slots=2, max_len=64, burst=4)
    srv.run(_requests(Request, olmo.cfg, 2, max_new=4))
    jsrv = olmo.jserver(slots=2, max_len=64, burst=4)
    jsrv.run(_requests(JRequest, olmo.cfg, 2, max_new=4))
    snap = srv.snapshot()
    assert _snapshot_outcomes(srv) == _snapshot_outcomes(jsrv)
    assert all(v["status"] == "ok" and v["deadline_met"]
               for v in snap["resilience"]["outcomes"].values())
    assert snap["resilience"]["counters"] == jsrv.snapshot()["resilience"]["counters"]
    assert snap["completed"] is True and snap["host_transfers"] == jsrv.host_transfers


class _Bomb:
    fired = ()

    def before_round(self, server, round_idx, slot_of):
        if round_idx == 1:
            raise RuntimeError("boom")


def test_aborted_run_snapshot_attribution(olmo):
    """snapshot() after an aborted run reports every in-flight request's
    outcome (aborted, tokens so far), as the reference's does."""
    srv = olmo.server(slots=2, max_len=64, burst=4, resilience=ResilienceConfig(),
                      injector=_Bomb())
    with pytest.raises(RuntimeError, match="boom"):
        srv.run(_requests(Request, olmo.cfg, 3, max_new=24))
    jsrv = olmo.jserver(slots=2, max_len=64, burst=4, resilience=jres.ResilienceConfig(),
                        injector=_Bomb())
    with pytest.raises(RuntimeError, match="boom"):
        jsrv.run(_requests(JRequest, olmo.cfg, 3, max_new=24))
    oc = _snapshot_outcomes(srv)
    assert oc == _snapshot_outcomes(jsrv)
    assert all(v["status"] == "aborted" for v in oc.values())
    assert sorted(v["tokens"] for v in oc.values()) == [0, 5, 5]
    assert srv.snapshot()["completed"] is False


def test_outcome_to_dict_roundtrip():
    o = RequestOutcome(rid=3, status="expired", reason="deadline", tokens=4,
                       deadline_s=0.5, wall_s=0.7)
    d = o.to_dict()
    assert d == jres.RequestOutcome(rid=3, status="expired", reason="deadline", tokens=4,
                                    deadline_s=0.5, wall_s=0.7).to_dict()
    assert d["rid"] == 3 and d["deadline_met"] is False
    assert RequestOutcome(rid=1, status="ok", tokens=8, wall_s=0.1).deadline_met
    with pytest.raises(ValueError):
        RequestOutcome(rid=0, status="nope")


@pytest.mark.parametrize("kw", [dict(shed_policy="coin_flip"), dict(queue_limit=0),
                                dict(default_deadline_s=-1.0), dict(logit_limit=0.0)])
def test_resilience_config_validation(kw):
    with pytest.raises(ValueError):
        ResilienceConfig(**kw)


# ---------------------------------------------------------------------------
# graceful degradation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def olmo_bank(olmo):
    return olmo.bank()


def _mk_controller(bank, **cfg):
    inner = ModeController(bank, ControllerConfig(pin=bank.reference))
    return DegradationPolicy(inner, DegradationConfig(**cfg))


def test_degradation_demotes_under_pressure(olmo_bank):
    pol = _mk_controller(olmo_bank, promote_hysteresis=3)
    assert pol.point == olmo_bank.reference
    pol.observe(StepSignals(active=2, steps=4, queue_depth=3, free_slots=0, deadline_misses=1))
    assert pol._cap < pol._top_idx and pol.demotions == 1 and pol.switches == 1
    before = pol._cap
    for _ in range(3):
        assert pol._cap == before
        pol.observe(StepSignals(active=2, steps=4, queue_depth=0, free_slots=2))
    assert pol._cap == before + 1 and pol.promotions == 1


def test_degradation_floor_bounds_demotion(olmo_bank):
    floor = olmo_bank.names[1]
    pol = _mk_controller(olmo_bank, floor=floor, demote_hysteresis=1)
    for _ in range(10):
        pol.observe(StepSignals(active=2, steps=4, queue_depth=5, free_slots=0, shed=1))
    assert pol.point == floor
    with pytest.raises(ValueError, match="unknown floor"):
        _mk_controller(olmo_bank, floor="nope")
    with pytest.raises(ValueError, match="hysteresis"):
        DegradationConfig(demote_hysteresis=0)


def test_degradation_effective_point_caps_inner(olmo_bank):
    pol = _mk_controller(olmo_bank, demote_hysteresis=1)
    pol.observe(StepSignals(active=2, steps=4, queue_depth=9, free_slots=0, deadline_misses=2))
    assert olmo_bank.index(pol.point) < olmo_bank.index(pol.inner.point)
    assert pol.cap == pol.point and pol.tree() is olmo_bank.tree(pol.point)


def test_degradation_reset(olmo_bank):
    pol = _mk_controller(olmo_bank, demote_hysteresis=1)
    pol.observe(StepSignals(active=2, steps=4, queue_depth=9, free_slots=0, shed=2))
    assert pol._cap < pol._top_idx
    pol.reset()
    assert pol._cap == pol._top_idx and pol.point == olmo_bank.reference


def test_degradation_trajectory_matches_reference(olmo, olmo_bank):
    """Under queue pressure (6 requests, 2 slots) the degrading server demotes
    the batch and promotes it back: the effective-point trajectory, the
    switches, the streams and the adaptive telemetry are the reference's."""

    def run(server, policy):
        seen = []
        inner = policy.observe
        policy.observe = lambda signals: seen.append(inner(signals)) or seen[-1]
        out = server.run(_requests(server_request, olmo.cfg, 6, max_new=12))
        return out, seen

    kw = dict(slots=2, max_len=64, burst=4)
    server_request = Request
    pol = DegradationPolicy(ModeController(olmo_bank, ControllerConfig(pin="accurate")),
                            DegradationConfig(promote_hysteresis=2))
    srv = olmo.server(bank=olmo_bank, controller=pol, resilience=ResilienceConfig(), **kw)
    out, traj = run(srv, pol)
    jbank = olmo.jbank()
    jpol = jres.DegradationPolicy(jrt.ModeController(jbank, jrt.ControllerConfig(pin="accurate")),
                                  jres.DegradationConfig(promote_hysteresis=2))
    jsrv = olmo.jserver(bank=jbank, controller=jpol, resilience=jres.ResilienceConfig(), **kw)
    server_request = JRequest
    jout, jtraj = run(jsrv, jpol)
    _same_as_reference(srv, out, jsrv, jout)
    assert traj == jtraj and len(set(traj)) > 1
    assert (pol.switches, pol.demotions, pol.promotions) == (
        jpol.switches, jpol.demotions, jpol.promotions)
    assert srv.telemetry.summary() == jsrv.telemetry.summary()


def test_degradation_improves_deadline_met_fraction(olmo, olmo_bank):
    """Under deadline pressure the degrading server meets at least as many
    deadlines as the pinned-accurate one."""

    def run(controller):
        srv = olmo.server(slots=2, max_len=64, burst=4, bank=olmo_bank, controller=controller,
                          resilience=ResilienceConfig(default_deadline_s=2.0))
        srv.run(_requests(Request, olmo.cfg, 6, max_new=12))
        return sum(o.deadline_met for o in srv.outcomes.values())

    pinned = ModeController(olmo_bank, ControllerConfig(pin=olmo_bank.reference))
    assert run(_mk_controller(olmo_bank, demote_hysteresis=1)) >= run(pinned)


# ---------------------------------------------------------------------------
# trace recorder context manager
# ---------------------------------------------------------------------------


def test_trace_recorder_flushes_on_exception(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with pytest.raises(RuntimeError):
        with TraceRecorder(sink=path) as tr:
            tr.begin("burst")
            raise RuntimeError("mid-span crash")
    header, events = read_trace(path)
    assert header["meta"]["aborted"] is True
    assert [e["ph"] for e in events] == ["B", "E"]


def test_trace_recorder_clean_exit_flushes(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with TraceRecorder(sink=path) as tr:
        tr.instant("tick")
    header, events = read_trace(path)
    assert "aborted" not in header["meta"] and len(events) == 1


def test_server_trace_survives_aborted_run(olmo, tmp_path):
    """A crash mid-run still leaves a replayable trace on disk when the
    observer has a sink."""
    path = str(tmp_path / "aborted.jsonl")
    srv = olmo.server(slots=2, max_len=64, burst=4, observer=ServingObserver(trace_sink=path),
                      resilience=ResilienceConfig(), injector=_Bomb())
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError):
        srv.run(_requests(Request, olmo.cfg, 2, max_new=24))
    header, events = read_trace(path)
    assert header["meta"]["aborted"] is True
    assert any(e["name"] == "burst" for e in events)
    assert all(0 <= e["ts"] <= time.perf_counter() - t0 + 1 for e in events)
    assert math.isfinite(header["t0_unix"])
