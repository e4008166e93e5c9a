"""``chip_smoke.py`` on the CPU: its phase helper and its refusal to run
without a card. The script imports nothing but the standard library at its
top, so it imports here."""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

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
