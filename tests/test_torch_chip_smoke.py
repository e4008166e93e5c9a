"""``chip_smoke.py`` on the CPU: its phase helper and its refusal to run
without a card. The script imports nothing but the standard library at its
top, so it imports here."""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_mamba2 import one_torch_thread  # noqa: E402, F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_phase_returns_the_phase_result(smoke, capsys):
    assert smoke.phase("adds", lambda a, b=0: a + b, 2, b=3) == 5
    assert capsys.readouterr().out == ""  # nothing on stdout, the log goes to stderr


def test_failed_phase_prints_where_and_reraises(smoke, capsys):
    def broken(n):
        raise AssertionError("x" * n)

    with pytest.raises(AssertionError):
        smoke.phase("serve olmo-1b", broken, 400)
    out, err = capsys.readouterr()
    line = json.loads(out.strip())
    assert line == {"failed_phase": "serve olmo-1b", "error": "AssertionError: " + "x" * 300}
    assert "Traceback" in err and "broken" in err


def test_main_refuses_without_a_card(smoke, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_arch_configs_keep_stock_widths_and_name_their_cuts(smoke):
    """The other archs' card configs: stock widths, f32, depth cut to
    ``ARCH_LAYERS``, llama4's experts to 64 of 128, with the byte reckoning
    the llama4 phase reports (64.4 GB of f32 routed experts a MoE layer at
    128)."""
    from repro_torch.configs import get_config

    for name, layers in smoke.ARCH_LAYERS.items():
        cfg, stock = smoke.arch_config(name), get_config(name)
        assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size) == (
            stock.d_model, stock.num_heads, stock.num_kv_heads, stock.d_ff, stock.vocab_size)
        assert cfg.dtype == "float32" and cfg.num_layers == (layers or stock.num_layers)
    llama4 = smoke.weight_reckoning(smoke.arch_config("llama4-maverick-400b-a17b"))
    assert (llama4["experts"], llama4["stock_experts"], llama4["layers"]) == (64, 128, 2)
    assert round(llama4["stock_routed_experts_gb_per_moe_layer"], 1) == 64.4
    assert round(llama4["routed_experts_gb_per_moe_layer"], 1) == 32.2
    assert 42 < llama4["f32_weights_gb"] < 43


def test_arch_phases_names_and_reports(smoke, monkeypatch, capsys):
    """``arch_phases`` with its phases stubbed: one named phase per served
    arch, internvl2 also sampled, the ``ARCH_FORWARD`` forwards on the
    serving weights, then reduced llama4 card vs CPU; each report printed
    as one JSON line. A failing phase prints ``failed_phase`` and raises."""
    calls = []

    def serve(device, label, cfg):
        calls.append(("serve", label))
        return {"config": label}, {0: [1]}, [[0.5]], {"weights of": label}

    monkeypatch.setattr(smoke, "serve_full_width", serve)
    monkeypatch.setattr(smoke, "serve_sampled", lambda d, cfg, w, streams: (
        calls.append(("sampled", cfg.name)) or {"config": "sampled"}))
    monkeypatch.setattr(smoke, "forward_phase", lambda d, label, cfg, w, batch: (
        calls.append(("forward", label, w["weights of"], batch)) or {"config": "forward"}))
    monkeypatch.setattr(smoke, "llama4_card_vs_cpu", lambda d: {"config": "parity"})
    monkeypatch.setattr(smoke, "free_card", lambda: None)
    serving, forward, parity = {}, {}, {}
    smoke.arch_phases("cpu", serving, forward, parity)
    out, err = capsys.readouterr()
    names = list(smoke.ARCH_LAYERS)
    assert [c[1] for c in calls if c[0] == "serve"] == names
    assert [c[1] for c in calls if c[0] == "sampled"] == ["internvl2-2b"]
    assert [(c[1], c[3]) for c in calls if c[0] == "forward"] == list(smoke.ARCH_FORWARD.items())
    assert all(c[1] == c[2] for c in calls if c[0] == "forward")  # the serving weights
    assert sorted(serving) == sorted(names + ["internvl2-2b sampled"])
    assert all(serving[n]["weights"]["layers"] == smoke.arch_config(n).num_layers for n in names)
    assert sorted(forward) == sorted(smoke.ARCH_FORWARD) and list(parity) == ["llama4-maverick"]
    lines = [json.loads(line) for line in out.splitlines()]
    assert [next(iter(x)) for x in lines].count("serving") == len(names) + 1
    assert lines[-1] == {"card_vs_cpu": {"config": "parity"}}
    for name in names:
        assert f"phase serve {name}" in err

    def broken(*a):
        raise AssertionError("streams differ")

    monkeypatch.setattr(smoke, "serve_full_width", broken)
    with pytest.raises(AssertionError):
        smoke.arch_phases("cpu", {}, {}, {})
    assert json.loads(capsys.readouterr().out.strip()) == {
        "failed_phase": f"serve {names[0]}", "error": "AssertionError: streams differ"}


def test_last_line_is_the_device_contract(smoke):
    """``main`` ends by printing exactly ``{"ok": true, "device": {"platform":
    "gpu", "kind": ..., "count": ...}}``: its last ``emit`` call, read from
    the source (the run itself needs a card)."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(smoke.main))
    emits = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "emit"]
    last = max(emits, key=lambda n: n.lineno).args[0]
    assert [k.value for k in last.keys] == ["ok", "device"]
    assert isinstance(last.values[0], ast.Constant) and last.values[0].value is True
    device = last.values[1]
    assert [k.value for k in device.keys] == ["platform", "kind", "count"]
    assert device.values[0].value == "gpu"
    assert "get_device_name" in ast.unparse(device.values[1])
    assert "device_count" in ast.unparse(device.values[2])


class _CpuCapture:
    """A stand-in for ``serve.capture.GraphRunner`` on the CPU, with the card's
    launch accounting: a new program runs twice on copies of the cache and
    state (the warm-up and the capture, each counted by the wrappers), then
    every call runs it on the real ones with the wrappers' counts saved and
    restored (a replay issues no launch) and counts a replay."""

    def __new__(cls, device, capture=True):
        from repro_torch.serve import capture as cap

        class Runner(cap.GraphRunner):
            def __init__(self, device, capture=True):
                super().__init__(device, capture=False)
                self.emulate, self.pool = capture, None

            def run(self, name, fn, cache, state, inputs=()):
                from repro_torch.kernels import launch_counts, wrappers

                if not self.emulate:
                    return super().run(name, fn, cache, state, inputs)
                if name not in self.graphs:
                    if name in self.capture_seconds:  # dropped, captured again
                        self.recaptures[name] = self.recaptures.get(name, 0) + 1
                    before = launch_counts()
                    fn(cap._clone(cache), cap._clone(state))
                    mid = launch_counts()
                    fn(cap._clone(cache), cap._clone(state))
                    self.warmup_launches[name] = cap._diff(mid, before)
                    self.captured_launches[name] = cap._diff(launch_counts(), mid)
                    self.capture_seconds[name] = 0.0
                    self.graphs[name] = None
                saved = {n: (w.launches, dict(w.instantiations)) for n, w in wrappers().items()}
                out = fn(cache, state)
                for n, w in wrappers().items():
                    w.launches, w.instantiations = saved[n][0], saved[n][1]
                self.replays[name] = self.replays.get(name, 0) + 1
                return cap._to_host(out)

        return Runner(device, capture)


@pytest.fixture
def counted(monkeypatch):
    """On the CPU the wrappers run their plain versions and count nothing:
    each plain version the model paths reach counts a launch on its wrapper,
    by the instantiation the wrapper's plan would launch."""
    from repro_torch import kernels
    from repro_torch.kernels.cordic_fused import ops as fused_ops
    from repro_torch.kernels.cordic_mac import ops as mac_ops
    from repro_torch.kernels.decode_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.int_dot import PATH_NAMES, plan

    def counting(module, name, wrapper, instantiation):
        plain = getattr(module, name)

        def run(*args, **kw):
            kernels.count_launch(wrapper, instantiation(*args))
            return plain(*args, **kw)

        monkeypatch.setattr(module, name, run)

    counting(fused_ops, "fused_dot_af_ref", fused_ops.fused_dot_af,
             lambda x, w, *a: PATH_NAMES[plan(x.numel() // x.shape[-1], w.shape[1], w.shape[0],
                                              1, w.element_size()).path])
    counting(attn_ops, "gqa_decode_attention_ref", attn_ops.gqa_decode_attention,
             lambda q, *a: "tc" if q.shape[1] >= attn_ops.TC_MIN_S else "split")
    counting(flash_ops, "flash_attention_ref", flash_ops.flash_attention, lambda *a: "tc")
    counting(mac_ops, "mac_matmul_ref", mac_ops.mac_matmul,
             lambda x, w, *a: PATH_NAMES[plan(x.shape[0], w.shape[1], w.shape[0],
                                              x.element_size(), w.element_size()).path])


SCAN_ARCHS = ["mamba2-780m", "zamba2-7b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("name", ["zamba2-7b"])
def test_scan_prefill_launch_accounting(smoke, counted, monkeypatch, name):
    """A reduced scan arch (zamba2: Mamba2 layers and the shared block's GQA)
    served on the CPU under the stand-in capture, with the smoke's exact
    gates: each prefill is one single-row forward per
    prompt token (the step graph, replayed) and one finish replay without a
    kernel, one transfer a prefill and a burst; the launches per forward
    (mamba2 2L + 1 fused; zamba2 2L + 7 groups + 1 and a GQA launch a group;
    seamless 8L + 1 and a GQA launch a layer) times the forwards, by
    instantiation (every prefill step a narrow dot and a split-key GQA); a
    steady repeat issues nothing from the host; the uncaptured run launches
    exactly the replays' launches; a count off by one fails."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import kernel_totals
    from repro_torch.models import get_model
    from repro_torch.serve import engine

    monkeypatch.setattr(engine, "GraphRunner", _CpuCapture)
    cfg = reduced(get_config(name))
    model = get_model(cfg)
    per_forward = smoke.launches_per_forward(cfg)
    layers, groups = cfg.num_layers, cfg.num_layers // (cfg.hybrid.attn_every if cfg.hybrid else 1)
    assert per_forward == {"mamba2-780m": {"fused_dot_af": 2 * layers + 1},
                           "zamba2-7b": {"fused_dot_af": 2 * layers + 7 * groups + 1,
                                         "gqa_decode_attention": groups},
                           "seamless-m4t-large-v2": {"fused_dot_af": 8 * layers + 1,
                                                     "gqa_decode_attention": layers}}[name]
    params = smoke.scaled_init(model)
    make = lambda capture=True: engine.BatchedServer(  # noqa: E731
        model, smoke.kernel_ctx(), params, slots=2, max_len=64, burst=4, device="cpu",
        capture=capture)
    server = make()
    lens = (3, 6)
    smoke.zero_launches()
    reqs = smoke.requests(cfg, lens=lens, max_new=5)
    first = server.run(reqs)
    launches, replayed = smoke.graph_accounting(name, server, cfg, reqs)
    forwards = sum(lens) + server.decode_steps
    assert smoke.model_forwards(server) == forwards
    assert launches == {k: v * forwards for k, v in per_forward.items()}
    assert server.prefill_steps == sum(lens) and server.prefill_calls == len(lens)
    assert server.programs.replays["prefill step"] == sum(lens)
    assert server.programs.replays["prefill finish"] == len(lens)
    assert server.programs.captured_launches["prefill finish"] == {}
    assert replayed.get("fused_dot_af/narrow") == per_forward["fused_dot_af"] * forwards
    if "gqa_decode_attention" in per_forward:
        assert replayed["gqa_decode_attention/split"] == per_forward["gqa_decode_attention"] * forwards
    # steady: every graph captured, nothing issued from the host
    captured = frozenset(server.programs.graphs)
    smoke.zero_launches()
    again_reqs = smoke.requests(cfg, lens=lens, max_new=5)
    assert server.run(again_reqs) == first
    smoke.graph_accounting(f"{name} steady", server, cfg, again_reqs, captured_before=captured)
    assert not any(smoke.wrapper_counts().values())
    # uncaptured: every launch issued from the host, no replay
    eager = make(capture=False)
    smoke.zero_launches()
    eager_reqs = smoke.requests(cfg, lens=lens, max_new=5)
    assert eager.run(eager_reqs) == first
    assert smoke.uncaptured_accounting(f"{name} uncaptured", eager, cfg, eager_reqs) == launches
    assert smoke.nonzero(kernel_totals(smoke.wrapper_counts())) == kernel_totals(replayed)
    # the gates are exact: one scan step more than the prompts hold fails
    smoke.zero_launches()
    server.prefill_steps += 1
    with pytest.raises(AssertionError, match="tampered"):
        smoke.graph_accounting(f"{name} tampered", server, cfg, again_reqs,
                               captured_before=captured)


@pytest.mark.parametrize("name", SCAN_ARCHS)
def test_scan_forward_launches(smoke, counted, name):
    """One cache-free forward of each reduced scan arch under ``"flash"``
    launches what ``forward_launches`` says (seamless: 6 per encoder and 10
    per decoder layer fused, a flash launch each; zamba2 a flash launch a
    group; mamba2 none), every dot over more than 16 rows on the wgmma
    instantiation; one decode step what ``launches_per_forward`` says."""
    import numpy as np

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model

    cfg = reduced(get_config(name))
    model = get_model(cfg)
    params = smoke.scaled_init(model)
    from repro_torch.core import prepare_params

    ctx = smoke.kernel_ctx("flash")
    prepared = prepare_params(params, ctx.policy, "kernel", specs=model.specs())
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 32)))}
    if cfg.frontend == "audio":
        batch["frontend_embeds"] = torch.randn((1, 64, cfg.d_model)) * 0.02
    kernels = smoke.zero_launches()
    with torch.no_grad():
        model.forward(prepared, batch, ctx)
    want = smoke.forward_launches(cfg, "flash")
    smoke.check_launches(f"{name} forward", kernels, want)
    smoke.check_instantiations(f"{name} forward", smoke.wrapper_counts(),
                               smoke.by_instantiation(want, 32, 32))
    if name == "seamless-m4t-large-v2":
        enc, dec = cfg.encdec.encoder_layers, cfg.num_layers
        assert want == {"fused_dot_af": 6 * enc + 10 * dec + 1, "flash_attention": enc + dec}
    kernels = smoke.zero_launches()
    cache = model.make_cache(2, 16, device="cpu")
    with torch.no_grad():
        model.decode_step(prepared, torch.zeros((2, 1), dtype=torch.int64), cache,
                          smoke.kernel_ctx())
    smoke.check_launches(f"{name} decode", kernels, smoke.launches_per_forward(cfg))


def test_scan_configs_keep_stock_widths_and_name_their_cuts(smoke):
    """The scan archs' card configs: stock widths, f32, mamba2 cut to 24 of
    its 48 layers, zamba2 to 18 of its 81 (two groups of nine), with the
    parameter reckoning the phases report (mamba2 505.9 M of a stock
    857.4 M, zamba2 1.84 B of a stock 6.75 B, seamless 1.63 B)."""
    from repro_torch.configs import get_config

    for name, layers in smoke.SCAN_ARCH_LAYERS.items():
        cfg, stock = smoke.scan_config(name), get_config(name)
        assert dataclass_widths(cfg) == dataclass_widths(stock)
        assert cfg.dtype == "float32" and cfg.num_layers == (layers or stock.num_layers)
    got = {n: smoke.weight_reckoning(smoke.scan_config(n)) for n in smoke.SCAN_ARCH_LAYERS}
    assert round(got["mamba2-780m"]["params_b"], 4) == 0.5059
    assert round(got["mamba2-780m"]["params_b_at_stock_depth"], 4) == 0.8574
    assert round(got["zamba2-7b"]["params_b"], 2) == 1.84
    assert round(got["zamba2-7b"]["params_b_at_stock_depth"], 2) == 6.75
    assert round(got["zamba2-7b"]["f32_weights_gb"], 2) == 7.35
    assert round(got["seamless-m4t-large-v2"]["params_b"], 2) == 1.63
    assert smoke.scan_config("zamba2-7b").num_layers % 9 == 0


def dataclass_widths(cfg):
    return (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.ssm, cfg.hybrid, cfg.encdec)


def test_scan_phases_names_and_reports(smoke, monkeypatch, capsys):
    """``scan_phases`` with its phases stubbed: each scan arch served, mamba2
    also sampled and through the streaming frontend on its serving weights,
    each one's forward on its serving weights, then each reduced card vs
    CPU; a failing phase prints ``failed_phase``."""
    calls = []

    def serve(device, label, cfg):
        calls.append(("serve", label))
        return {"config": label}, {0: [1]}, [[0.5]], {"weights of": label}

    monkeypatch.setattr(smoke, "serve_full_width", serve)
    monkeypatch.setattr(smoke, "serve_sampled", lambda d, cfg, w, streams: (
        calls.append(("sampled", cfg.name)) or {"config": "sampled"}))
    monkeypatch.setattr(smoke, "forward_phase", lambda d, label, cfg, w, batch: (
        calls.append(("forward", label, w["weights of"], batch)) or {"config": "forward"}))
    monkeypatch.setattr(smoke, "scan_card_vs_cpu", lambda d, name: (
        calls.append(("parity", name)) or {"config": name}))
    monkeypatch.setattr(smoke, "chunked_frontend", lambda d, label, cfg, w, run: (
        calls.append(("frontend", label, w["weights of"], run)) or {"config": "frontend"}))
    monkeypatch.setattr(smoke, "free_card", lambda: None)
    serving, forward, parity = {}, {}, {}
    smoke.scan_phases("cpu", serving, forward, parity)
    out, err = capsys.readouterr()
    names = list(smoke.SCAN_ARCH_LAYERS)
    assert [c[1] for c in calls if c[0] == "serve"] == names
    assert [c[1] for c in calls if c[0] == "sampled"] == ["mamba2-780m"]
    assert [(c[1], c[3]) for c in calls if c[0] == "forward"] == list(smoke.SCAN_FORWARD.items())
    assert all(c[1] == c[2] for c in calls if c[0] == "forward")
    assert [c[1] for c in calls if c[0] == "parity"] == names == list(parity)
    assert [c[1:] for c in calls if c[0] == "frontend"] == [
        ("mamba2-780m", "mamba2-780m", ({0: [1]}, [[0.5]]))]
    assert sorted(serving) == sorted(names + ["mamba2-780m sampled", "mamba2-780m frontend"])
    lines = [json.loads(line) for line in out.splitlines()]
    assert [next(iter(x)) for x in lines].count("card_vs_cpu") == len(names)
    for name in names:
        assert f"phase serve {name}" in err and f"phase {name} card vs cpu" in err


def test_bank_servers_launch_accounting(smoke, counted, monkeypatch):
    """Reduced olmo-1b served from a multi-point bank on the CPU under the
    stand-in capture, with the smoke's exact gates: every graph is named by
    its program and point (``"<program> @<point>"``), each captured once at
    its first visit (a point visited again replays), its launches by
    instantiation those of its point's weights (the hifi point's FxP16 dots
    on the CUDA-core loop, ``imad``); captured x replays by (program, point)
    is what the run recorded (bursts by the telemetry's points; a
    speculative round one draft at its draft point and one verify at the
    verify point, every prefill at the verify point); one transfer a prefill
    and a burst or round; a count off by one fails."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import FXP8, FXP16
    from repro_torch.models import get_model
    from repro_torch.runtime import ControllerConfig, ModeController, build_bank, default_points
    from repro_torch.serve import engine
    from repro_torch.spec import SpecConfig

    monkeypatch.setattr(engine, "GraphRunner", _CpuCapture)
    cfg = reduced(get_config("olmo-1b"))
    model = get_model(cfg)
    params = smoke.scaled_init(model)
    bank = build_bank(params, "kernel", default_points(FXP8, hifi_fmt=FXP16), specs=model.specs())
    widths = smoke.point_bytes(bank)
    assert widths == {"approx": 1, "accurate": 1, "hifi": 2}
    kw = dict(slots=2, max_len=64, burst=4, device="cpu")
    lens = (3, 9, 17, 5)
    # adaptive: the CLI's budget; then pinned at hifi
    ctrl = ModeController(bank, ControllerConfig(cycle_budget=0.75))
    trajectory = smoke.recorded(ctrl)
    server = engine.BatchedServer(model, smoke.kernel_ctx(), params, controller=ctrl, **kw)
    smoke.zero_launches()
    reqs = smoke.requests(cfg, lens=lens, max_new=16)
    server.run(reqs)
    smoke.graph_accounting("adaptive", server, cfg, reqs, widths=widths)
    assert len(set(trajectory)) > 1 and server.telemetry.summary()["switches"] >= 1
    names = set(server.programs.graphs)
    assert {n.partition(" @")[2] for n in names} == set(trajectory)
    assert "burst greedy @approx" in names and "burst greedy @accurate" in names
    replays = smoke.check_point_replays("adaptive", server, reqs)
    assert replays["burst"] == {p: n for p, n in server.telemetry.steps_by_point.items() if n}
    captured = frozenset(names)
    smoke.zero_launches()
    again = smoke.requests(cfg, lens=lens, max_new=16)
    server.run(again)
    smoke.graph_accounting("adaptive steady", server, cfg, again, captured_before=captured,
                           widths=widths)
    assert set(server.programs.graphs) == captured  # visited points replay, no capture
    assert not any(smoke.wrapper_counts().values())
    hifi = engine.BatchedServer(model, smoke.kernel_ctx(), params,
                                controller=ModeController(bank, ControllerConfig(pin="hifi")),
                                **kw)
    smoke.zero_launches()
    reqs = smoke.requests(cfg, lens=lens, max_new=6)
    hifi.run(reqs)
    smoke.graph_accounting("hifi", hifi, cfg, reqs, widths=widths)
    assert hifi.programs.captured_launches["burst greedy @hifi"] == {
        "fused_dot_af/imad": 4 * (7 * cfg.num_layers + 1),
        "gqa_decode_attention/split": 4 * cfg.num_layers}
    # speculative: greedy, then sampled
    spec = engine.BatchedServer(model, smoke.kernel_ctx(), params, bank=bank,
                                speculate=SpecConfig(draft_len=3), **kw)
    for label, make in (("greedy", smoke.requests), ("sampled", smoke.sampled_requests)):
        captured = frozenset(spec.programs.graphs)
        smoke.zero_launches()
        reqs = make(cfg, lens=lens, max_new=8) if label == "greedy" else [
            r for r in make(cfg) if r.rid < 2]
        spec.run(reqs)
        smoke.graph_accounting(f"spec {label}", spec, cfg, reqs, captured_before=captured,
                               widths=widths)
        assert spec.host_transfers == len(reqs) + spec.spec_rounds
        assert spec.programs.replays[f"verify {label} @accurate"] == spec.spec_rounds
        assert spec.programs.replays[f"draft {label} @approx"] == spec.spec_rounds
    # 2 slots x 4 rows: the narrow loop (the card's 4 x 5 rows: wgmma)
    assert spec.programs.captured_launches["verify greedy @accurate"] == {
        "fused_dot_af/narrow": 7 * cfg.num_layers + 1,
        "gqa_decode_attention/split": cfg.num_layers}
    assert all(n.endswith("@accurate") for n in spec.programs.graphs if n.startswith("prefill"))
    # the gates are exact: one round more than the replays fails
    spec.spec_rounds += 1
    with pytest.raises(AssertionError, match="spec tampered"):
        smoke.graph_accounting("spec tampered", spec, cfg, reqs,
                               captured_before=frozenset(spec.programs.graphs), widths=widths)


def test_resilience_phase_accounting(smoke, counted, monkeypatch, tmp_path):
    """``resilience_phases``' bookkeeping, rehearsed on reduced olmo-1b under
    the stand-in capture: a resilient, observed server launches exactly
    what the plain server launches (the fault flag is glue), its JSONL and
    Chrome traces pass ``check_trace_files``; the fault flag's outcomes and
    counters (a NaN slot, ``logit_limit`` quarantine) are exact and leave
    the unflagged requests' streams alone; a NaN weight fault on one point
    of an adaptive bank re-captures that point's graphs only, counted by
    point, the launch gates still exact with the re-captured graphs
    issued again, and the other point's streams unchanged."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import FXP8
    from repro_torch.models import get_model
    from repro_torch.obs import ServingObserver
    from repro_torch.resilience import (FaultInjector, NaNCacheFault, NaNWeightFault,
                                        ResilienceConfig)
    from repro_torch.runtime import ControllerConfig, ModeController, build_bank, default_points
    from repro_torch.serve import engine

    monkeypatch.setattr(engine, "GraphRunner", _CpuCapture)
    cfg = reduced(get_config("olmo-1b"))
    model = get_model(cfg)
    params = smoke.scaled_init(model)
    kw = dict(slots=2, max_len=64, burst=4, device="cpu")
    lens = (3, 9, 17, 5)
    make = lambda **k: engine.BatchedServer(model, smoke.kernel_ctx(), params, **kw, **k)  # noqa
    plain = make()
    smoke.zero_launches()
    reqs = smoke.requests(cfg, lens=lens, max_new=10)
    out = plain.run(reqs)
    plain_launches, plain_replayed = smoke.graph_accounting("plain", plain, cfg, reqs)
    jsonl, chrome = tmp_path / "t.jsonl", tmp_path / "t.json"
    observer = ServingObserver(trace_sink=str(jsonl))
    resilient = make(resilience=ResilienceConfig(), observer=observer)
    smoke.zero_launches()
    reqs = smoke.requests(cfg, lens=lens, max_new=10)
    assert resilient.run(reqs) == out
    assert smoke.graph_accounting("resilient", resilient, cfg, reqs) == (plain_launches,
                                                                         plain_replayed)
    assert resilient.programs.captured_launches == plain.programs.captured_launches
    observer.trace.write_jsonl(str(jsonl))
    observer.trace.write_chrome(str(chrome))
    checked = smoke.check_trace_files(jsonl, chrome)
    assert checked["balanced"] and {"prefill", "burst", "run"} <= set(checked["names"])
    assert {o.status for o in resilient.outcomes.values()} == {"ok"}
    # the flag's bookkeeping: a NaN slot beside logit_limit quarantine
    flagged = make(resilience=ResilienceConfig(logit_limit=smoke.RESILIENCE_LIMIT),
                   injector=FaultInjector(NaNCacheFault(rid=1, at_round=1)))
    reqs = smoke.requests(cfg, lens=lens, max_new=10)
    fout = flagged.run(reqs)
    faulted = {r for r, o in flagged.outcomes.items() if o.status == "faulted"}
    assert flagged._fault_counts["faulted"] == len(faulted)
    for rid, o in flagged.outcomes.items():
        assert o.tokens == len(fout[rid])
        if rid != 1:
            assert fout[rid] == out[rid][:len(fout[rid])]
        if rid not in faulted:
            assert o.status == "ok" and len(fout[rid]) == 10
    # a NaN weight fault on one point: its graphs only are captured again
    bank = build_bank(params, "kernel", default_points(FXP8, hifi_fmt=None), specs=model.specs())
    widths = smoke.point_bytes(bank)
    server = make(controller=ModeController(bank, ControllerConfig(pin="approx")))
    server.run(smoke.requests(cfg, lens=lens, max_new=10))
    before = frozenset(server.programs.graphs)
    server.injector = FaultInjector(NaNWeightFault(at_round=1, point="approx"))
    smoke.zero_launches()
    reqs = smoke.requests(cfg, lens=lens, max_new=10)
    server.run(reqs)
    again = set(server.programs.recaptures)
    assert again and all(n.endswith(" @approx") for n in again)
    assert "burst greedy @approx" in again
    smoke.graph_accounting("weight fault", server, cfg, reqs, widths=widths,
                           captured_before=before - again)
    with pytest.raises(AssertionError, match="issued from the host"):
        smoke.graph_accounting("weight fault tampered", server, cfg, reqs, widths=widths,
                               captured_before=before)
    pinned = make(controller=ModeController(bank, ControllerConfig(pin="accurate")))
    reqs = smoke.requests(cfg, lens=lens, max_new=10)
    accurate = make(controller=ModeController(
        build_bank(params, "kernel", default_points(FXP8, hifi_fmt=None), specs=model.specs()),
        ControllerConfig(pin="accurate")))
    assert pinned.run(reqs) == accurate.run(smoke.requests(cfg, lens=lens, max_new=10))


@pytest.fixture
def small_smoke(smoke, monkeypatch):
    """The smoke's serving sizes cut to the CPU's: 2 slots, 64 rows, burst 4,
    four prompts (the third, 40 rows, the long one) of 6 new tokens, chunks
    of 8 rows; no card to synchronize or free."""
    for name, value in (("SLOTS", 2), ("MAX_LEN", 64), ("BURST", 4),
                        ("PROMPT_LENS", (3, 17, 40, 9)), ("MAX_NEW", 6), ("CHUNK_TOKENS", 8),
                        ("LONG_RID", 2)):
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(smoke, "free_card", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return smoke


@pytest.mark.parametrize("name", ["olmo-1b", "mamba2-780m"])
def test_frontend_chunk_launch_accounting(small_smoke, counted, monkeypatch, name):
    """The streaming frontend on a reduced arch under the stand-in capture,
    with the smoke's exact gates (``chunked_identity``): each chunk bucket a
    graph (the scan: its step graph a chunk row), captured launches x
    replays exactly the chunks' forwards and the decode steps by
    instantiation, one transfer an admit and a burst, the interleaving
    bound, streams equal to run()'s; a steady repeat issues nothing from the
    host; a chunk the scheduler did not run fails the gate."""
    smoke = small_smoke
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.serve import engine

    monkeypatch.setattr(engine, "GraphRunner", _CpuCapture)
    cfg = reduced(get_config(name))
    model = get_model(cfg)
    params = smoke.scaled_init(model)
    make = lambda: engine.BatchedServer(  # noqa: E731
        model, smoke.kernel_ctx(), params, slots=2, max_len=64, burst=4, device="cpu")
    reqs = smoke.requests(cfg)
    run = (make().run(reqs), smoke.margins(reqs))
    server = make()
    rep, chunks = smoke.chunked_identity(name, server, cfg, run)
    assert rep["streams_identical"] and rep["margins_max_abs_diff"] <= smoke.MARGIN_ATOL
    assert 0 < rep["max_prefill_rows_between_bursts"] <= 8
    assert sum(n for n, _, _ in chunks) == sum(smoke.PROMPT_LENS)
    per_forward = smoke.launches_per_forward(cfg)
    assert rep["launches"] == {k: v * smoke.model_forwards(server)
                               for k, v in per_forward.items()}
    if server.batched_prefill:
        assert server.prefill_chunks == len(chunks) > len(reqs)
        # a chunk of a prompt whose bucket is 16 or more runs 16 wide
        assert set(rep["chunk_buckets"]) == {f"prefill_chunk {b}" for b in (1, 2, 4, 8, 16)} & set(
            server.programs.graphs)
        assert {server.chunk_span(p, s, n)[1] for n, s, p in chunks if p > 8} == {16}
        assert server.programs.captured_launches["prefill admit"] == {}
    else:
        assert server.programs.replays["prefill step"] == sum(smoke.PROMPT_LENS)
    captured = frozenset(server.programs.graphs)
    chunks.clear()
    smoke.zero_launches()
    again = smoke.requests(cfg)
    out, _, _ = smoke.frontend_run(server, again)
    smoke.frontend_accounting(f"{name} steady", server, cfg, again, chunks, captured)
    assert not any(smoke.wrapper_counts().values())
    assert smoke.same_as_run(f"{name} steady", out, again, run)["streams_identical"]
    chunks.append((1, 0, 1))
    with pytest.raises(AssertionError, match="tampered"):
        smoke.frontend_accounting(f"{name} tampered", server, cfg, again, chunks, captured)


@pytest.mark.parametrize("mode", ["exact", "carmen", "int8"])
def test_mode_serving_launch_accounting(small_smoke, counted, monkeypatch, mode):
    """The exact, carmen and int8 modes on reduced olmo-1b under the
    stand-in capture, with the smoke's gates (``serve_mode``): captured =
    repeat = uncaptured, bitwise; launches exact (every int8 dot a
    MAC-array launch, on the narrow loop at decode and the int8 tensor
    cores past 16 rows; the cache attention in every mode); prepared = per
    call."""
    smoke = small_smoke
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.serve import engine

    monkeypatch.setattr(engine, "GraphRunner", _CpuCapture)
    cfg = reduced(get_config("olmo-1b"))
    params = smoke.scaled_init(get_model(cfg))
    report, run = smoke.serve_mode("cpu", mode, cfg, params)
    forwards, rest = divmod(report["launches"]["gqa_decode_attention"], cfg.num_layers)
    assert rest == 0 and forwards > len(smoke.PROMPT_LENS)
    if mode == "int8":
        assert report["launches"]["cordic_mac"] == (7 * cfg.num_layers + 1) * forwards
    else:
        assert set(report["launches"]) == {"gqa_decode_attention"}
    assert report["uncaptured_identical"] and report["repeat_identical"]
    per_call, per_call_run = smoke.serve_mode("cpu", mode, cfg, params, per_call=True,
                                              uncaptured=False)
    assert per_call_run == run and per_call["launches"] == report["launches"]


def _reduced_olmo(layers=None):
    from repro_torch.configs import get_config, reduced

    return reduced(get_config("olmo-1b"), **({"layers": layers} if layers else {}))


def test_frontend_and_modes_phases_rehearsed(small_smoke, counted, monkeypatch):
    """``frontend_phases`` and ``modes_phases`` end to end on reduced olmo-1b
    under the stand-in capture: chunked, its steady repeat, the monolithic
    arm (run()'s margins bitwise) and Poisson arrivals all serve run()'s
    streams; each mode's reports, prepared = per call, card vs CPU (here CPU
    vs CPU) and the CLI's carmen --adaptive --metrics flow."""
    smoke = small_smoke
    from repro_torch.launch import serve as cli
    from repro_torch.models import get_model
    from repro_torch.serve import engine

    monkeypatch.setattr(engine, "GraphRunner", _CpuCapture)
    monkeypatch.setattr(smoke, "olmo", _reduced_olmo)
    cfg = _reduced_olmo()
    model = get_model(cfg)
    server = engine.BatchedServer(model, smoke.kernel_ctx(),
                                  model.init(torch.Generator().manual_seed(smoke.SEED)),
                                  slots=2, max_len=64, burst=4, device="cpu")
    reqs = smoke.requests(cfg)
    run = (server.run(reqs), smoke.margins(reqs))
    report = smoke.frontend_phases("cpu", run)
    for key in ("chunked", "chunked_steady", "monolithic", "monolithic_steady"):
        assert report[key]["streams_identical"], key
    assert report["monolithic"]["margins_identical"]
    for arm in ("chunked", "monolithic"):
        assert report[f"interleaved_{arm}"]["long_prompt_gaps"]["gaps"] > 0
    assert report["poisson_arrivals"]["arrival_rate"] == smoke.ARRIVAL_RATE
    assert report["half_chunk_budget"]["captured_equals_uncaptured"]
    assert report["half_chunk_budget"]["streams_identical"]
    assert report["poisson_arrivals"]["streams_identical"]
    assert report["launches"] == report["chunked"]["launches"]
    main = cli.main
    monkeypatch.setattr(cli, "main", lambda argv: main(argv + ["--device", "cpu", "--reduced"]))
    modes = smoke.modes_phases("cpu")
    for mode in smoke.MODES:
        assert modes[mode]["uncaptured_identical"]
        assert modes[f"{mode} {smoke.PER_CALL_LAYERS} layers"]["per_call_identical"]
        assert modes[f"{mode} card vs cpu"]["streams_identical"]
    cli_report = modes["cli carmen adaptive metrics"]
    assert cli_report["telemetry"]["reference"] == "accurate" and cli_report["metrics"]


def test_sim_and_train_phases_rehearsed(small_smoke, monkeypatch, tmp_path):
    """``sim_phases`` and ``train_phases`` end to end on reduced olmo-1b on the
    CPU: the calibration fit and its export, the adaptive CLI flow's trace
    replayed with every request and token attributed; remat bitwise, the
    loss falling, the restart bitwise, and kernel 6's launches in the int8
    steps exactly ``int8_train_launches`` (each plain call counted by the
    path its wrapper's plan takes), the recorded calls bitwise."""
    smoke = small_smoke
    from repro_torch import kernels
    from repro_torch.kernels.cordic_mac import ops as mac_ops, ref as mac_ref
    from repro_torch.kernels.int_dot import PATH_NAMES, plan

    def cpu_launch(x_q, w_q, x_scale, w_scale, relu):
        p = plan(x_q.shape[0], w_q.shape[1], w_q.shape[0], x_q.element_size(),
                 w_q.element_size())
        kernels.count_launch(mac_ops.mac_matmul, PATH_NAMES[p.path])
        return mac_ref.mac_matmul_ref(x_q, w_q, x_scale, w_scale, fuse_relu=relu)

    monkeypatch.setattr(mac_ops, "_launch", cpu_launch)
    monkeypatch.setattr(mac_ops, "mac_matmul_ref",
                        lambda *a, fuse_relu=False: mac_ops._launch(*a, fuse_relu))
    for name in ("reset_peak_memory_stats", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    monkeypatch.setattr(smoke, "ROOT", tmp_path)
    monkeypatch.setattr(smoke, "SIM_CLI", smoke.SIM_CLI + ("--reduced", "--device", "cpu"))
    monkeypatch.setattr(smoke, "train_config", _reduced_olmo)
    monkeypatch.setattr(smoke, "TRAIN_STEPS", 6)
    sim = smoke.sim_phases("cpu")
    assert not sim["calibration"]["fit"]["mac_slope_fallback"]
    assert sim["savings_drift"] == pytest.approx(0.0, abs=smoke.SIM_DRIFT_TOL)
    assert sim["requests_attributed"] == sim["cli"]["requests"] == 6
    assert (tmp_path / "chiprun_out" / "sim" / "replay_calibrated.json").exists()
    train = smoke.train_phases("cpu")
    assert train["remat"]["bitwise"] and train["restart"]["bitwise"]
    assert train["exact"]["losses"][-1] < train["exact"]["losses"][0]
    cfg = _reduced_olmo()
    assert train["int8"]["launches_by_instantiation"] == smoke.int8_train_launches(
        cfg, smoke.TRAIN_MODE_STEPS)
    assert len(train["int8"]["bitwise_plain_calls"]) == smoke.TRAIN_RECORD_CALLS
    assert not (tmp_path / "build" / "train_ckpt").exists()
