"""PyTorch port: runtime-adaptive precision (``repro_torch.runtime``: banks,
controller, telemetry; the server's controller hook and the CLI's
``--adaptive``) against the reference, on the CPU.

Reduced olmo-1b (2 layers, d_model 128) in kernel mode, the same numpy
weights on both sides (layer matrices N(0, 0.1^2), as test_torch_serving).
Exact: point order, cycle estimates (host float64 sums), bank leaf sharing,
each point's prepared integers, the controller's trajectory on the same
signals (pure host arithmetic), the telemetry summaries and the adaptive
runs' point trajectories and streams. Margins agree with the reference's to
the logits' f32 reduction-order tolerance (1e-4).
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import FXP8 as J8, FXP16 as J16  # noqa: E402
from repro.core import EngineContext as JCtx, LayerPrecision as JLP  # noqa: E402
from repro.core import PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serve.engine import BatchedServer as JServer, Request as JRequest  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import FXP8, FXP16, EngineContext, LayerPrecision  # noqa: E402
from repro_torch.core import PrecisionPolicy, approx_depth, full_depth, prepare_params  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.sim import CALIBRATION_SCHEMA, load_calibration  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401
from test_torch_prepare import _assert_prepared_like_reference  # noqa: E402
from test_torch_serving import _numpy_params  # noqa: E402

MARGIN_TOL = 1e-4
PROMPTS = (3, 7, 12, 5)
CALIBRATION = {"schema": CALIBRATION_SCHEMA, "version": 1, "id": "fit-test",
               "constants": {"mac_overhead": 0.37}}


@pytest.fixture(scope="module")
def setup():
    ref_model = ref_get_model(ref_reduced(ref_get_config("olmo-1b")))
    np_params = _numpy_params(jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0))))
    model = get_model(reduced(get_config("olmo-1b")))
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32,
                attn_impl="decode_kernel")
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl="decode_kernel")
    return ref_model, np_params, model, jctx, ctx


@pytest.fixture(scope="module")
def banks(setup):
    """The CLI's ladder (approx FxP8, accurate FxP8, hifi FxP16) on both sides."""
    ref_model, np_params, model, _, _ = setup
    jbank = jrt.build_bank(jax.tree.map(jnp.asarray, np_params), "kernel",
                           jrt.default_points(J8, hifi_fmt=J16), specs=ref_model.specs())
    tbank = rt.build_bank(model.load_numpy(np_params, "cpu"), "kernel",
                          rt.default_points(FXP8, hifi_fmt=FXP16), specs=model.specs())
    return jbank, tbank


def _prompts(lens=PROMPTS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


def _policies():
    """(name, port policy, reference policy) for the cycle-model checks."""
    mixed = PrecisionPolicy(LayerPrecision(FXP8, full_depth(FXP8)),
                            {"layer.attn": LayerPrecision(FXP8, approx_depth(FXP8)),
                             "lm_head": LayerPrecision(FXP16, 9)})
    out = [("fxp8_accurate", PrecisionPolicy.accurate(FXP8)),
           ("fxp8_approximate", PrecisionPolicy.approximate(FXP8)),
           ("fxp16_accurate", PrecisionPolicy.accurate(FXP16)), ("mixed", mixed)]
    return [(n, p, JPolicy.from_json(p.to_json())) for n, p in out]


# ---------------------------------------------------------------------------
# multi-point banks and the cycle model
# ---------------------------------------------------------------------------


def test_bank_matches_reference(banks):
    jbank, tbank = banks
    assert tbank.names == jbank.names == ("approx", "accurate", "hifi")
    assert tbank.reference == jbank.reference == "accurate"
    assert tbank.cycles_per_token == jbank.cycles_per_token  # host float64, exact
    for name in tbank.names:
        assert tbank.rel_cycles(name) == jbank.rel_cycles(name)
    assert tbank.rel_cycles("approx") == (approx_depth(FXP8) + 1) / (full_depth(FXP8) + 1)
    assert tbank.rel_cycles("hifi") == (full_depth(FXP16) + 1) / (full_depth(FXP8) + 1)
    assert (tbank.shared_leaves, tbank.unique_leaves) == (jbank.shared_leaves,
                                                          jbank.unique_leaves)
    assert tbank.cycle_model == jbank.cycle_model == "analytic"
    assert tbank.mode == "kernel"


@pytest.mark.parametrize("point", ["approx", "accurate", "hifi"])
def test_bank_point_prepares_reference_integers(banks, point):
    """Each point's tree holds the reference's prepared banks: the
    signed-digit integers at that point's depth and format (int16 at hifi)."""
    jbank, tbank = banks
    flat = _assert_prepared_like_reference(jbank.tree(point), tbank.tree(point))
    dtype = torch.int16 if point == "hifi" else torch.int8
    assert flat[("lm_head",)].data.dtype == dtype


@pytest.mark.parametrize("calibration", [None, CALIBRATION], ids=["analytic", "calibrated"])
@pytest.mark.parametrize("name,policy,jpolicy", _policies(), ids=[p[0] for p in _policies()])
def test_estimate_point_cycles_matches_reference(setup, banks, name, policy, jpolicy,
                                                 calibration):
    """Raw trees (tied lm_head added) and prepared trees (its materialized
    leaf), analytic and with a calibration's mac_overhead: equal to the
    reference's float64 sums exactly."""
    ref_model, np_params, model, _, _ = setup
    jbank, tbank = banks
    jraw = jax.tree.map(jnp.asarray, np_params)
    traw = model.load_numpy(np_params, "cpu")
    for jtree, ttree in ((jraw, traw), (jbank.tree("accurate"), tbank.tree("accurate"))):
        want = jrt.estimate_point_cycles(jtree, jpolicy, specs=ref_model.specs(),
                                         calibration=calibration)
        got = rt.estimate_point_cycles(ttree, policy, specs=model.specs(),
                                       calibration=calibration)
        assert got == want > 0


def test_calibration_changes_cycle_model(setup, banks):
    ref_model, np_params, model, _, _ = setup
    _, tbank = banks
    params = model.load_numpy(np_params, "cpu")
    cal = rt.build_bank(params, "kernel", rt.default_points(FXP8, hifi_fmt=None),
                        specs=model.specs(), calibration=CALIBRATION)
    assert cal.cycle_model == "fit-test"
    jraw = jax.tree.map(jnp.asarray, np_params)
    for p in cal.points:
        want = jrt.estimate_point_cycles(jraw, JPolicy.from_json(p.policy.to_json()),
                                         specs=ref_model.specs(), calibration=CALIBRATION)
        assert cal.cycles_per_token[p.name] == want > tbank.cycles_per_token[p.name]
    assert rt.telemetry.calibration_id(None) == "analytic"


def test_bank_shares_leaves_where_points_agree(setup):
    """A calibrated base policy becomes the "mixed" point: the layers it
    keeps accurate are the accurate point's own prepared leaves."""
    ref_model, np_params, model, _, _ = setup
    base = PrecisionPolicy(LayerPrecision(FXP8, full_depth(FXP8)),
                           {"layer.attn": LayerPrecision(FXP8, approx_depth(FXP8))})
    bank = rt.build_bank(model.load_numpy(np_params, "cpu"), "kernel",
                         rt.default_points(FXP8, base_policy=base, hifi_fmt=None),
                         specs=model.specs())
    jbank = jrt.build_bank(jax.tree.map(jnp.asarray, np_params), "kernel",
                           jrt.default_points(J8, base_policy=JPolicy.from_json(base.to_json()),
                                              hifi_fmt=None), specs=ref_model.specs())
    assert bank.names == jbank.names == ("mixed", "accurate")
    mixed, acc = bank.tree("mixed"), bank.tree("accurate")
    assert mixed["seg0_dense"]["attn"]["wq"] is not acc["seg0_dense"]["attn"]["wq"]
    assert mixed["seg0_dense"]["mlp"]["up"] is acc["seg0_dense"]["mlp"]["up"]
    assert mixed["lm_head"] is acc["lm_head"]
    assert (bank.shared_leaves, bank.unique_leaves) == (jbank.shared_leaves,
                                                        jbank.unique_leaves)
    assert bank.shared_leaves > 0
    assert bank.cycles_per_token == jbank.cycles_per_token
    _assert_prepared_like_reference(jbank.tree("mixed"), mixed)


def test_bank_rejects_exact_mode_and_bad_ladders(setup):
    _, np_params, model, _, _ = setup
    params = model.load_numpy(np_params, "cpu")
    with pytest.raises(ValueError, match="precision knob"):
        rt.build_bank(params, "exact", specs=model.specs())
    one = rt.default_points(FXP8, hifi_fmt=None)[:1]
    with pytest.raises(ValueError, match="at least two"):
        rt.build_bank(params, "kernel", one, specs=model.specs())
    with pytest.raises(ValueError, match="reference point"):
        rt.build_bank(params, "kernel", rt.default_points(FXP8, hifi_fmt=None),
                      specs=model.specs(), reference="fp4")


def test_layer_cost_table_matches_reference(setup, banks):
    ref_model, _, model, _, _ = setup
    jbank, tbank = banks
    want = jrt.telemetry.layer_cost_table(
        jbank.tree("accurate"), {p.name: p.policy for p in jbank.points}, specs=ref_model.specs())
    got = rt.telemetry.layer_cost_table(
        tbank.tree("accurate"), {p.name: p.policy for p in tbank.points}, specs=model.specs())
    assert got == want and len(got) == 8


def test_load_calibration(tmp_path):
    good = tmp_path / "cal.json"
    good.write_text(json.dumps(CALIBRATION))
    assert load_calibration(str(good)) == CALIBRATION
    for bad, match in (({"schema": "other"}, "not a"),
                       (dict(CALIBRATION, version=2), "newer")):
        path = tmp_path / "bad.json"
        path.write_text(json.dumps(bad))
        with pytest.raises(ValueError, match=match):
            load_calibration(str(path))


# ---------------------------------------------------------------------------
# the mode controller
# ---------------------------------------------------------------------------


def _toy_bank(module):
    """A bank stub: three points, relative cycles 0.5 / 1.0 / 2.0."""
    pol = (PrecisionPolicy if module is rt else JPolicy).accurate()
    points = tuple(module.ExecutionPoint(n, pol) for n in ("cheap", "accurate", "hifi"))
    return module.MultiPointBank(
        mode="kernel", points=points, trees={n: {"w": n} for n in ("cheap", "accurate", "hifi")},
        cycles_per_token={"cheap": 50.0, "accurate": 100.0, "hifi": 200.0},
        reference="accurate")


def test_controller_demotes_under_pressure_with_hysteresis():
    ctrl = rt.ModeController(_toy_bank(rt), rt.ControllerConfig(hysteresis=2))
    pressure = rt.StepSignals(active=2, queue_depth=5, free_slots=0, min_margin=3.0)
    assert ctrl.point == "accurate"
    ctrl.observe(pressure)
    assert ctrl.point == "accurate"  # one vote is not enough
    ctrl.observe(pressure)
    assert ctrl.point == "cheap" and ctrl.switches == 1
    ctrl.observe(pressure)
    ctrl.observe(pressure)
    assert ctrl.point == "cheap" and ctrl.switches == 1


def test_controller_promotes_on_low_margin_when_unloaded():
    ctrl = rt.ModeController(
        _toy_bank(rt), rt.ControllerConfig(hysteresis=2, start="cheap", margin_promote=1.5))
    idle_uncertain = rt.StepSignals(active=1, queue_depth=0, free_slots=2, min_margin=0.2)
    ctrl.observe(idle_uncertain)
    ctrl.observe(idle_uncertain)
    assert ctrl.point == "accurate" and ctrl.switches == 1


def test_controller_budget_blocks_promotion():
    cfg = rt.ControllerConfig(hysteresis=1, cycle_budget=0.75, ema=0.5, start="accurate")
    ctrl = rt.ModeController(_toy_bank(rt), cfg)
    uncertain = rt.StepSignals(active=1, queue_depth=0, free_slots=2, min_margin=0.1)
    ctrl.observe(uncertain)
    assert ctrl.point == "cheap"
    trajectory = [ctrl.observe(uncertain) for _ in range(4)]
    assert "accurate" in trajectory and ctrl.switches >= 2
    assert "hifi" not in trajectory


def test_controller_hold_resets_streak_and_pin_never_moves():
    ctrl = rt.ModeController(_toy_bank(rt), rt.ControllerConfig(hysteresis=2))
    pressure = rt.StepSignals(active=2, queue_depth=5, free_slots=0, min_margin=3.0)
    neutral = rt.StepSignals(active=2, queue_depth=0, free_slots=1, min_margin=3.0)
    for sig in (pressure, neutral, pressure):
        ctrl.observe(sig)
    assert ctrl.point == "accurate" and ctrl.switches == 0
    pinned = rt.ModeController(_toy_bank(rt), rt.ControllerConfig(pin="cheap", hysteresis=1))
    for sig in (rt.StepSignals(active=1, queue_depth=9, free_slots=0, min_margin=0.0),
                rt.StepSignals(active=1, queue_depth=0, free_slots=3, min_margin=0.0)):
        for _ in range(5):
            pinned.observe(sig)
    assert pinned.point == "cheap" and pinned.switches == 0
    assert pinned.tree() == {"w": "cheap"}


def test_controller_rejects_unknown_points_and_bad_budget():
    with pytest.raises(ValueError, match="unknown execution point"):
        rt.ModeController(_toy_bank(rt), rt.ControllerConfig(pin="fp4"))
    with pytest.raises(ValueError, match="unknown execution point"):
        rt.ModeController(_toy_bank(rt), rt.ControllerConfig(start="fp4"))
    with pytest.raises(ValueError, match="positive"):
        rt.ModeController(_toy_bank(rt), rt.ControllerConfig(cycle_budget=0.0))


@pytest.mark.parametrize("cfg", [
    dict(), dict(hysteresis=1), dict(cycle_budget=0.75, ema=0.5),
    dict(cycle_budget=0.7, margin_promote=-1.0, margin_demote=math.inf),
    dict(start="cheap", hysteresis=3, margin_demote=2.0), dict(pin="hifi"),
], ids=["default", "hysteresis1", "budget", "budget_disarmed", "start_cheap", "pinned"])
def test_controller_trajectory_matches_reference(cfg):
    """The same random signal stream (margins None, finite, NaN and inf; queue
    pressure; burst-sized steps) through both controllers: the same point
    after every observation, the same switches, the same cycle EMA bits."""
    rng = np.random.default_rng(len(cfg))
    special = [None, math.nan, math.inf, -math.inf]
    mine = rt.ModeController(_toy_bank(rt), rt.ControllerConfig(**cfg))
    ref = jrt.ModeController(_toy_bank(jrt), jrt.ControllerConfig(**cfg))
    for _ in range(200):
        margin = (special[rng.integers(4)] if rng.random() < 0.2
                  else float(rng.standard_normal() * 4 + 3))
        kw = dict(active=int(rng.integers(0, 4)), queue_depth=int(rng.integers(0, 3)),
                  free_slots=int(rng.integers(0, 2)), min_margin=margin,
                  steps=int(rng.integers(1, 9)))
        assert mine.observe(rt.StepSignals(**kw)) == ref.observe(jrt.StepSignals(**kw))
        assert mine.rel_cycles_ema == ref.rel_cycles_ema
    assert mine.switches == ref.switches
    mine.reset()
    assert mine.point == (cfg.get("pin") or cfg.get("start") or "accurate")
    assert mine.switches == 0


def test_telemetry_recorder_matches_reference():
    mine = rt.TelemetryRecorder({"cheap": 50.0, "accurate": 100.0}, "accurate")
    ref = jrt.TelemetryRecorder({"cheap": 50.0, "accurate": 100.0}, "accurate")
    for rec in (mine, ref):
        rec.record_prefill("accurate", tokens=4)
        rec.record_step("accurate", active=2, min_margin=1.0)
        rec.record_burst("cheap", tokens=7, steps=4, min_margin=2.0)
        rec.record_step("cheap", active=1, min_margin=0.5)
    s = mine.summary()
    assert s == ref.summary() and mine.to_dict() == ref.to_dict()
    assert s["steps"] == 3 and s["decode_steps"] == 6 and s["tokens"] == 14
    assert s["switches"] == 1
    assert s["est_mac_cycles"] == 4 * 100 + 2 * 100 + 7 * 50 + 1 * 50
    assert mine.min_margins == [1.0, 2.0, 0.5]
    mine.reset()
    assert mine.summary()["tokens"] == 0 and mine.min_margins == []


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point", ["approx", "accurate", "hifi"])
def test_pinned_controller_equals_static_server(setup, banks, point):
    """A controller pinned to a point serves what a static server of that
    point's prepared weights serves: streams and f32 margins bit for bit,
    every token charged to the point, no switch."""
    _, np_params, model, _, ctx = setup
    _, tbank = banks
    policy = next(p.policy for p in tbank.points if p.name == point)
    static_tree = prepare_params(model.load_numpy(np_params, "cpu"), policy, "kernel",
                                 specs=model.specs())
    static = BatchedServer(model, ctx, static_tree, slots=2, max_len=32, burst=4, device="cpu",
                           prepare_weights=False)
    want_reqs = [Request(i, p, 8) for i, p in enumerate(_prompts())]
    want = static.run(want_reqs)
    ctrl = rt.ModeController(tbank, rt.ControllerConfig(pin=point))
    adaptive = BatchedServer(model, ctx, model.load_numpy(np_params, "cpu"), slots=2,
                             max_len=32, burst=4, device="cpu", controller=ctrl)
    got_reqs = [Request(i, p, 8) for i, p in enumerate(_prompts())]
    assert adaptive.run(got_reqs) == want
    assert [r.margins for r in got_reqs] == [r.margins for r in want_reqs]
    s = adaptive.telemetry.summary()
    assert s["mode_occupancy"][point] == 1.0 and s["switches"] == 0
    assert s["tokens"] == sum(len(p) for p in _prompts()) + 8 * len(PROMPTS) - len(PROMPTS)
    assert adaptive.host_transfers == len(PROMPTS) + adaptive.decode_steps // 4


def _record(ctrl):
    """Wrap ``ctrl.observe`` to record the point it picks after each burst."""
    trajectory, observe = [], ctrl.observe
    ctrl.observe = lambda sig: trajectory.append(observe(sig)) or trajectory[-1]
    return trajectory


@pytest.mark.parametrize("cfg", [
    dict(cycle_budget=0.75),
    dict(cycle_budget=0.7, margin_promote=-1.0, margin_demote=math.inf),
], ids=["cli_flow", "budget_driven"])
def test_adaptive_run_matches_reference(setup, banks, cfg):
    """The CLI's flow (cycle budget 0.75) and a budget-driven run with the
    margins disarmed: the same point after every burst, the same streams and
    the same telemetry summary as the reference's run; margins within
    1e-4."""
    ref_model, np_params, model, jctx, ctx = setup
    jbank, tbank = banks
    jctrl = jrt.ModeController(jbank, jrt.ControllerConfig(**cfg))
    jtraj = _record(jctrl)
    jserver = JServer(ref_model, jctx, jax.tree.map(jnp.asarray, np_params), slots=2,
                      max_len=32, burst=4, controller=jctrl)
    jreqs = [JRequest(i, p, 10) for i, p in enumerate(_prompts((3, 7, 12, 5, 9, 4)))]
    want = jserver.run(jreqs)
    ctrl = rt.ModeController(tbank, rt.ControllerConfig(**cfg))
    traj = _record(ctrl)
    server = BatchedServer(model, ctx, model.load_numpy(np_params, "cpu"), slots=2, max_len=32,
                           burst=4, device="cpu", controller=ctrl)
    reqs = [Request(i, p, 10) for i, p in enumerate(_prompts((3, 7, 12, 5, 9, 4)))]
    assert server.run(reqs) == want
    assert traj == jtraj and len(set(traj)) > 1  # the run moved along the ladder
    assert server.telemetry.summary() == jserver.telemetry.summary()
    assert server.telemetry.summary()["switches"] >= 1
    np.testing.assert_allclose(server.telemetry.min_margins, jserver.telemetry.min_margins,
                               atol=MARGIN_TOL, rtol=0)
    for r, j in zip(reqs, jreqs):
        np.testing.assert_allclose(r.margins, j.margins, atol=MARGIN_TOL, rtol=0)
    records = server._telemetry_records()
    assert [r["kind"] for r in records] == ["adaptive"]
    assert records[0]["est_cycles"] == jserver._telemetry_records()[0]["est_cycles"]


def test_run_reuse_starts_fresh(setup, banks):
    _, np_params, model, _, ctx = setup
    _, tbank = banks
    ctrl = rt.ModeController(tbank, rt.ControllerConfig(cycle_budget=0.8))
    server = BatchedServer(model, ctx, model.load_numpy(np_params, "cpu"), slots=2, max_len=32,
                           burst=4, device="cpu", controller=ctrl)
    out1 = server.run([Request(i, p, 6) for i, p in enumerate(_prompts())])
    tele1, point1 = server.telemetry.summary(), ctrl.point
    out2 = server.run([Request(i, p, 6) for i, p in enumerate(_prompts())])
    assert out1 == out2 and server.telemetry.summary() == tele1 and ctrl.point == point1


def test_teacher_forced_agreement_matches_reference(setup, banks):
    ref_model, np_params, model, _, _ = setup
    jbank, tbank = banks
    prompts = _prompts((3, 6))
    results = {0: [5, 9, 200], 1: [17, 3]}
    margins = {0: [0.5, 2.0, 1.0], 1: [3.0, 0.1]}
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32)
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl="xla")
    want = jrt.teacher_forced_agreement(ref_model, jctx, jbank.tree("approx"),
                                        [JRequest(i, p, 3) for i, p in enumerate(prompts)],
                                        results, margins)
    got = rt.teacher_forced_agreement(model, ctx, tbank.tree("approx"),
                                      [Request(i, p, 3) for i, p in enumerate(prompts)],
                                      results, margins)
    assert got == want
    with pytest.raises(ValueError, match="align"):
        rt.teacher_forced_agreement(model, ctx, tbank.tree("approx"),
                                    [Request(0, prompts[0], 3)], {0: [1, 2]}, {0: [1.0]})


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_serves_adaptive_on_cpu(capsys, tmp_path):
    from repro_torch.launch.serve import main

    path = tmp_path / "cal.json"
    path.write_text(json.dumps(CALIBRATION))
    out = main(["--arch", "olmo-1b", "--reduced", "--mode", "kernel", "--requests", "3",
                "--slots", "2",
                "--max-new", "6", "--burst", "2", "--device", "cpu", "--adaptive",
                "--cycle-budget", "0.75", "--calibration", str(path)])
    assert sorted(out) == [0, 1, 2] and all(len(v) == 6 for v in out.values())
    text = capsys.readouterr().out
    assert "cycle calibration: fit-test" in text and "points=('approx', 'accurate', 'hifi')" in text
    tele = json.loads(text.split("telemetry: ", 1)[1].splitlines()[0])
    assert tele["reference"] == "accurate" and tele["steps"] >= 1
    with pytest.raises(SystemExit, match="per-call"):
        main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--mode", "kernel", "--adaptive",
              "--per-call"])
