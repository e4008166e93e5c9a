"""PyTorch port: the PE-array simulator (``repro_torch.sim``) against the
reference's ``repro.sim``, on the CPU.

* **array**: ``dot_pass_cost`` equals the reference's field for field over
  a grid of configs and shapes, and on one ideal PE it is the analytic
  ``mac_cycles`` of the port's core.
* **calibration**: ``fit_calibration`` of synthetic measurements (the
  reference's ``test_sim`` set, a depth-blind set that falls back, a noisy
  set) equals the reference's dict, ``id`` included; exports round-trip
  through either package; ``measure(smoke=True, device="cpu")`` produces a
  dict both fits take; the calibrate CLI writes an export.
* **replay**: a trace the reference's server wrote and one the port's wrote
  (the same adaptive carmen run on the same numpy weights), and a port
  speculative trace, each replay in the port to the reference's report:
  ``report_dict`` and ``render`` equal, analytic and calibrated. The
  replay CLI's JSON equals the reference's.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import FXP8 as J8  # noqa: E402
from repro.core import EngineContext as JCtx, PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.obs import ServingObserver as JObserver  # noqa: E402
from repro.serve.engine import BatchedServer as JServer, Request as JRequest  # noqa: E402
from repro.sim import analyze as janalyze  # noqa: E402
from repro.sim import array as jarray  # noqa: E402
from repro.sim import calibrate as jcal  # noqa: E402
from repro.sim import replay as jreplay  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import FXP8, EngineContext, PrecisionPolicy, mac_cycles  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.obs import ServingObserver  # noqa: E402
from repro_torch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.sim import (ArrayConfig, dot_pass_cost, fit_calibration,  # noqa: E402
                             load_calibration, replay_trace, save_calibration)
from repro_torch.sim import analyze, calibrate, replay  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401
from test_torch_serving import _numpy_params  # noqa: E402


def _json(tree):
    return json.loads(json.dumps(tree))


# ---------------------------------------------------------------------------
# the array cost model
# ---------------------------------------------------------------------------

ARRAYS = [
    dict(n_pes=1, af_blocks=1, weight_bits_per_cycle=1e12, af_cycles_per_elem=0.0),
    dict(),
    dict(n_pes=64),
    dict(n_pes=256, weight_bits_per_cycle=1.0),
    dict(n_pes=256, weight_bits_per_cycle=64.0),
    dict(n_pes=256, af_blocks=1),
    dict(n_pes=64, af_blocks=1, af_iter_cycles=4.0),
    dict(n_pes=256, parallel_overhead_exp=0.37, mac_overhead=0.25),
]
SHAPES = [(1, 1, 0, 1, 8, 1), (64, 256, 7, 1, 8, 1), (64, 257, 7, 3, 16, 2),
          (1, 4096, 7, 1, 8, 1), (512, 64, 4, 128, 8, 4), (8, 512, 13, 5, 16, 1)]


@pytest.mark.parametrize("arr", range(len(ARRAYS)))
def test_dot_pass_cost_equals_reference(arr):
    cfg, jcfg = ArrayConfig(**ARRAYS[arr]), jarray.ArrayConfig(**ARRAYS[arr])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.bandwidth == jcfg.bandwidth
    for k, n, depth, positions, bits, reps in SHAPES:
        got = dot_pass_cost(cfg, k, n, depth, positions=positions, bits=bits, reps=reps)
        want = jarray.dot_pass_cost(jcfg, k, n, depth, positions=positions, bits=bits,
                                    reps=reps)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_single_pe_is_the_analytic_mac_cycles():
    ideal = ArrayConfig(**ARRAYS[0])
    for k, depth in ((1, 0), (64, 4), (256, 7), (512, 13)):
        c = dot_pass_cost(ideal, k, 1, depth)
        assert c.total == mac_cycles(k, depth)
        assert c.weight_stall == 0.0 and c.af_stall == 0.0
    with pytest.raises(ValueError):
        ArrayConfig(n_pes=0)
    assert ArrayConfig().scaled(n_pes=64).n_pes == 64


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def _synthetic(*, sec_per_iter=2e-9, mac_overhead=0.25, dispatch_s=1e-4, af_iter=3.0,
               exponent=0.5, depths=(2, 4, 7)):
    """The reference's test_sim synthetic measurements."""
    m, k, n = 64, 256, 64
    macs = m * k * n
    times = {d: dispatch_s + macs * sec_per_iter * (d + 1 + mac_overhead) for d in depths}
    n_elems = 64 * 512
    af_t = dispatch_s + n_elems * af_iter * (7 + 1) * sec_per_iter
    return {
        "mac": {"shape": [m, k, n], "times_by_depth": times},
        "dispatch_s": dispatch_s,
        "af": {"shape": [64, 512], "depth": 7, "n_elems": n_elems,
               "times_by_mode": {"relu": af_t, "gelu": af_t}},
        "lanes": {"shape": [1024, 256], "times_by_n": {64: 1.0, 256: 4.0 ** exponent}},
        "smoke": True,
    }


def _depth_blind():
    meas = _synthetic()
    meas["mac"]["times_by_depth"] = {2: 3e-4, 4: 3e-4, 7: 3e-4}
    return meas


def _noisy():
    meas = _synthetic(mac_overhead=3.0, af_iter=40.0, exponent=2.0)
    meas["mac"]["times_by_depth"][4] *= 1.07
    return meas


@pytest.mark.parametrize("make", [_synthetic, _depth_blind, _noisy,
                                  lambda: _synthetic(mac_overhead=0.0)])
def test_fit_calibration_equals_reference(make):
    got, want = fit_calibration(make()), jcal.fit_calibration(make())
    assert got == want
    assert got["id"] == want["id"] and got["id"].startswith("calib-")


def test_fit_calibration_recovers_constants_and_refuses_one_depth():
    cal = fit_calibration(_synthetic())
    c = cal["constants"]
    assert c["sec_per_cycle"] == pytest.approx(2e-9, rel=1e-6)
    assert c["mac_overhead"] == pytest.approx(0.25, rel=1e-3)
    assert not cal["fit"]["mac_slope_fallback"]
    assert fit_calibration(_depth_blind())["fit"]["mac_slope_fallback"]
    with pytest.raises(ValueError):
        fit_calibration(_synthetic(depths=(7,)))


def test_calibration_export_round_trips_across_packages(tmp_path):
    cal = fit_calibration(_synthetic())
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    save_calibration(cal, ours)
    jcal.save_calibration(jcal.fit_calibration(_synthetic()), theirs)
    assert jcal.load_calibration(ours) == load_calibration(theirs) == _json(cal)
    cfg = ArrayConfig.from_calibration(load_calibration(theirs))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jarray.ArrayConfig.from_calibration(jcal.load_calibration(ours)))
    with open(ours, "w") as f:
        json.dump(dict(cal, version=99), f)
    with pytest.raises(ValueError, match="newer"):
        load_calibration(ours)


def test_measure_smoke_on_cpu_feeds_both_fits():
    meas = calibrate.measure(smoke=True, device="cpu")
    assert meas["mac"]["shape"] == [32, 128, 32] and sorted(meas["mac"]["times_by_depth"]) == [2, 7]
    assert set(meas["af"]["times_by_mode"]) == {"relu", "gelu"}
    assert sorted(meas["lanes"]["times_by_n"]) == [64, 256]
    times = [meas["dispatch_s"], *meas["mac"]["times_by_depth"].values(),
             *meas["af"]["times_by_mode"].values(), *meas["lanes"]["times_by_n"].values()]
    assert all(t > 0 for t in times)
    cal = fit_calibration(meas)
    assert cal == jcal.fit_calibration(meas)
    assert cal["constants"]["sec_per_cycle"] > 0


def test_calibrate_cli_writes_an_export(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(calibrate, "measure", lambda smoke, device: _synthetic())
    out = str(tmp_path / "sim" / "cal.json")
    calibrate.main(["--smoke", "--device", "cpu", "--out", out])
    printed = json.loads(capsys.readouterr().out)
    assert printed["id"] == jcal.fit_calibration(_synthetic())["id"]
    assert jcal.load_calibration(out)["constants"] == printed["constants"]


# ---------------------------------------------------------------------------
# replay: both packages' traces, replayed in both packages
# ---------------------------------------------------------------------------


class _Olmo:
    """Reduced olmo-1b (2 layers, d_model 64) on both sides, the same numpy
    weights, carmen mode at FxP8."""

    def __init__(self):
        self.ref_model = ref_get_model(ref_reduced(ref_get_config("olmo-1b"), layers=2,
                                                   d_model=64))
        self.np_params = _numpy_params(
            jax.tree.map(np.asarray, self.ref_model.init(jax.random.PRNGKey(0))))
        self.cfg = reduced(get_config("olmo-1b"), layers=2, d_model=64)
        self.model = get_model(self.cfg)
        self.ctx = EngineContext(mode="carmen", policy=PrecisionPolicy.accurate(FXP8),
                                 compute_dtype=torch.float32)
        self.jctx = JCtx(mode="carmen", policy=JPolicy.accurate(J8), compute_dtype=jnp.float32)

    def requests(self, cls):
        rng = np.random.default_rng(0)
        return [cls(i, rng.integers(0, self.cfg.vocab_size, 4 + i).astype(np.int32), 8)
                for i in range(3)]

    def port_trace(self, path, **kw):
        params = self.model.load_numpy(self.np_params, "cpu")
        bank = rt.build_bank(params, "carmen", rt.default_points(FXP8, hifi_fmt=None),
                             specs=self.model.specs())
        if kw.pop("speculative", False):
            extra = dict(bank=bank, speculate=SpecConfig(draft_len=3))
        else:
            extra = dict(controller=rt.ModeController(bank, rt.ControllerConfig(
                cycle_budget=0.75)))
        server = BatchedServer(self.model, self.ctx, params, device="cpu", slots=2,
                               max_len=32, burst=4, observer=ServingObserver(trace=True),
                               **extra)
        out = server.run(self.requests(Request))
        server.observer.trace.write_jsonl(path)
        return out

    def ref_trace(self, path):
        params = jax.tree.map(jnp.asarray, self.np_params)
        bank = jrt.build_bank(params, "carmen", jrt.default_points(J8, hifi_fmt=None),
                              specs=self.ref_model.specs())
        server = JServer(self.ref_model, self.jctx, params, slots=2, max_len=32, burst=4,
                         controller=jrt.ModeController(bank, jrt.ControllerConfig(
                             cycle_budget=0.75)))
        server.observer = JObserver(trace=True)
        out = server.run(self.requests(JRequest))
        server.observer.trace.write_jsonl(path)
        return out


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    olmo = _Olmo()
    d = tmp_path_factory.mktemp("sim")
    paths = {k: str(d / f"{k}.jsonl") for k in ("port", "ref", "port_spec")}
    out = olmo.port_trace(paths["port"])
    jout = olmo.ref_trace(paths["ref"])
    spec_out = olmo.port_trace(paths["port_spec"], speculative=True)
    return paths, {"port": out, "ref": jout, "port_spec": spec_out}


@pytest.mark.parametrize("kind", ["port", "ref", "port_spec"])
@pytest.mark.parametrize("calibrated", [False, True])
def test_replay_report_equals_reference(traces, kind, calibrated):
    paths, outs = traces
    cal = fit_calibration(_synthetic(mac_overhead=0.0)) if calibrated else None
    result = replay_trace(paths[kind], calibration=cal)
    jresult = jreplay.replay_trace(paths[kind], calibration=cal)
    assert _json(analyze.report_dict(result)) == _json(janalyze.report_dict(jresult))
    assert analyze.render(result) == janalyze.render(jresult)
    assert analyze.savings_drift(result) == janalyze.savings_drift(jresult)
    assert result.measured["tokens"] == sum(len(v) for v in outs[kind].values())


def test_port_and_reference_traces_replay_alike(traces):
    """The same adaptive run traced by the two servers: the same streams, and
    replays that agree on everything but wall-clock time."""
    paths, outs = traces
    assert outs["port"] == outs["ref"]
    got, want = replay_trace(paths["port"]), jreplay.replay_trace(paths["ref"])
    for field in ("counts", "phases", "layers", "requests", "totals"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.savings["est_cycle_savings_frac"] == want.savings["est_cycle_savings_frac"]


def test_replay_gates_on_a_port_trace(traces):
    paths, outs = traces
    result = replay_trace(paths["port"])
    assert analyze.savings_drift(result) == pytest.approx(0.0, abs=1e-9)
    assert result.counts["switches"] >= 1
    assert set(result.requests) == {str(r) for r in outs["port"]}
    for rid, generated in outs["port"].items():
        assert result.requests[str(rid)]["tokens"] == len(generated)
    attributed = sum(r["cycles"] for r in result.requests.values())
    charged = result.phases.get("prefill", 0) + result.phases.get("decode", 0)
    assert attributed == pytest.approx(charged, rel=1e-9)
    spec = replay_trace(paths["port_spec"])
    assert spec.counts["spec_rounds"] > 0
    assert spec.savings["speculative"]["rel_diff_vs_reported"] == pytest.approx(0.0, abs=1e-9)


def test_replay_rejects_a_trace_without_engine_block(tmp_path):
    from repro_torch.obs import TraceRecorder

    tr = TraceRecorder()
    tr.begin("run", track="run")
    tr.end("run", track="run")
    path = str(tmp_path / "bare.jsonl")
    tr.write_jsonl(path)
    with pytest.raises(ValueError, match="engine cost table"):
        replay_trace(path)


def test_replay_cli_json_equals_reference(traces, tmp_path, capsys):
    paths, _ = traces
    cal_path = str(tmp_path / "cal.json")
    save_calibration(fit_calibration(_synthetic()), cal_path)
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    args = ["--calibration", cal_path, "--pes", "64"]
    replay.main([paths["ref"], "--json", ours, *args])
    jreplay.main([paths["ref"], "--json", theirs, *args])
    printed = capsys.readouterr().out
    with open(ours) as f, open(theirs) as g:
        assert json.load(f) == json.load(g)
    replay.main([paths["port"], "--report"])
    text = capsys.readouterr().out
    for needle in ("PE-array replay", "where cycles go", "savings", "requests"):
        assert needle in text
    assert "total_cycles" in printed


def test_ordering_inversions_equal_reference():
    rows = [("a", 100.0, 1.0), ("b", 200.0, 0.5), ("c", 205.0, 2.0), ("d", 50.0, None)]
    for margin in (0.0, 0.1, 0.5):
        assert analyze.ordering_inversions(rows, margin=margin) == \
            janalyze.ordering_inversions(rows, margin=margin)
