"""PyTorch port: the dry run (``repro_torch.launch.dryrun``), the roofline
(``launch.roofline``), ``reanalyze`` and ``topcolls`` and the abstract
inputs they trace, against the reference, on the CPU.

* The cell shapes, ``shape_applicable``, ``active_params``, ``model_flops``
  and ``attn_flops`` equal the reference's for all 10 archs x 4 shapes.
* ``abstract_params``, ``param_axes``, ``count_params``, ``input_specs`` and
  ``abstract_state`` give the reference's shapes and dtypes (meta tensors).
* In kernel mode the meta dry run of one decode step calls each kernel as
  ``chip_smoke.launches_per_forward`` says, by instantiation, for every arch
  at reduced widths.
* One full-width cell runs and is recorded; the skip rules, the refused
  multi-pod mesh (the meshed dry run: ``test_torch_dryrun_mesh.py``), the
  roofline's terms and render, ``measured_share``, ``reanalyze`` and
  ``topcolls`` on its trace.
"""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ALL_SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.configs import shape_applicable as ref_applicable  # noqa: E402
from repro.data.pipeline import input_specs as ref_input_specs  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import ALL_SHAPES, ARCHS, SHAPES, get_config, reduced  # noqa: E402
from repro_torch.configs import shape_applicable  # noqa: E402
from repro_torch.core import FXP8, EngineContext, PrecisionPolicy, prepare_params  # noqa: E402
from repro_torch.data.pipeline import input_specs  # noqa: E402
from repro_torch.kernels.costs import PEAKS, peak_seconds  # noqa: E402
from repro_torch.launch import cost_analysis, dryrun, reanalyze, roofline, topcolls  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.float32): torch.float32}


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), DTYPES.get(getattr(tree, "dtype", None), tree.dtype))


def test_cell_shapes_equal_the_reference():
    assert [(s.name, s.seq_len, s.global_batch, s.kind, s.is_decode) for s in ALL_SHAPES] == [
        (s.name, s.seq_len, s.global_batch, s.kind, s.is_decode) for s in REF_SHAPES]
    assert set(SHAPES) == {s.name for s in REF_SHAPES}
    for arch in ARCHS:
        for s, rs in zip(ALL_SHAPES, REF_SHAPES):
            assert shape_applicable(get_config(arch), s) == ref_applicable(
                ref_get_config(arch), rs)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert roofline.routed_expert_params(cfg) == ref_roofline.routed_expert_params(ref_cfg)
    assert roofline.active_params(cfg) == ref_roofline.active_params(ref_cfg)
    assert get_model(cfg).count_params() == ref_get_model(ref_cfg).count_params()
    for s, rs in zip(ALL_SHAPES, REF_SHAPES):
        assert roofline.model_flops(cfg, s) == ref_roofline.model_flops(ref_cfg, rs)
        assert roofline.attn_flops(cfg, s) == ref_roofline.attn_flops(ref_cfg, rs)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_inputs_equal_the_reference(arch):
    cfg, ref_cfg = reduced(get_config(arch)), ref_reduced(ref_get_config(arch))
    model, ref_model = get_model(cfg), ref_get_model(ref_cfg)
    params = model.abstract_params(torch.float32)
    assert all(t.is_meta for _, t in _leaves(params))
    ref_params = ref_model.abstract_params(jnp.float32)
    assert _shapes(params) == _shapes(ref_params)
    assert model.param_axes() == _axes(ref_model.param_axes())
    state, ref_state = opt.abstract_state(params), jopt.abstract_state(ref_params)
    assert _shapes(state.step) == _shapes(ref_state.step)
    assert _shapes(state.m) == _shapes(ref_state.m) == _shapes(state.v)
    assert state.m is not state.v
    for s, rs in zip(ALL_SHAPES, REF_SHAPES):
        batch = input_specs(cfg, s)
        assert all(t.is_meta for t in batch.values())
        assert _shapes(batch) == _shapes(ref_input_specs(ref_cfg, rs))


def _axes(tree):
    if isinstance(tree, dict):
        return {k: _axes(v) for k, v in tree.items()}
    return tuple(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield None, tree


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_meta_kernel_decode_calls_equal_launches_per_forward(arch, smoke):
    """One kernel-mode decode step of 4 slots on meta, prepared: the kernel
    records by instantiation are what the smoke's launch gates expect of a
    decode forward on the card, and no launch is counted."""
    cfg = reduced(get_config(arch))
    model = get_model(cfg)
    ctx = dryrun.engine_ctx("kernel", decode=True)
    params = prepare_params(model.abstract_params(), ctx.policy, "kernel", specs=model.specs())
    tokens = torch.empty((4, 1), dtype=torch.int32, device="meta")
    kernels.reset_launch_counts()
    an, _ = cost_analysis.analyze(model.decode_step, params, tokens,
                                  model.make_cache(4, 32, device="meta"), ctx)
    costs = an.costs()
    assert costs.kernel_totals() == smoke.launches_per_forward(cfg)
    assert costs.kernels == smoke.by_instantiation(smoke.launches_per_forward(cfg), 4, 1)
    assert sum(kernels.launch_counts().values()) == 0


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    recs = [dryrun.run_cell("olmo-1b", "decode_32k", mode="kernel", out_dir=str(out),
                            prepared=True),
            dryrun.run_cell("olmo-1b", "long_500k", mode="kernel", out_dir=str(out),
                            prepared=True),
            dryrun.run_cell("olmo-1b", "train_4k", mode="kernel", out_dir=str(out))]
    return out, recs


def test_cell_records_with_the_reference_keys(cells):
    out, (ok, long_ctx, train) = cells
    assert ok["status"] == "ok", ok.get("traceback")
    for key in ("flops_dev", "hbm_bytes_dev", "hbm_bytes_upper_dev", "coll_bytes_dev",
                "coll_by_kind", "memory", "ops_by_kind", "kernels", "fits_one_card"):
        assert key in ok
    cfg = get_config("olmo-1b")
    # 128 rows a dot: the int8 tensor cores (wgmma); one query row: split keys
    assert ok["kernels"] == {"fused_dot_af/wgmma": 7 * cfg.num_layers + 1,
                             "gqa_decode_attention/split": cfg.num_layers}
    assert 0 < ok["hbm_bytes_dev"] <= ok["hbm_bytes_upper_dev"]
    cache_bytes = 2 * cfg.num_layers * 128 * 32768 * cfg.num_kv_heads * cfg.head_dim * 4
    assert ok["hbm_bytes_dev"] >= cache_bytes  # the cache is read once
    assert ok["memory"]["argument_size_in_bytes"] >= cache_bytes
    assert ok["fits_one_card"] is False  # a 1.1 TB cache
    assert ok["coll_bytes_dev"] == 0 and ok["coll_by_kind"] == {}
    assert long_ctx["status"] == "skip" and "quadratic" in long_ctx["reason"]
    assert train["status"] == "skip" and "no backward" in train["reason"]
    with open(out / (dryrun.stem(ok) + ".json")) as f:
        assert json.load(f) == ok
    with pytest.raises(ValueError, match="ROADMAP"):
        dryrun.run_cell("olmo-1b", "decode_32k", mesh_kind="multi")
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "olmo-1b", "--mesh", "multi"])


def test_roofline_terms_render_and_measured_share(cells):
    out, (ok, *_) = cells
    t = roofline.terms(ok)
    assert t["compute_s"] == peak_seconds(ok["ops_by_kind"])
    assert t["memory_s"] == ok["hbm_bytes_dev"] / 3.35e12
    assert t["bottleneck"] == "memory" and t["link_s"] == 0.0
    mf = roofline.model_flops(get_config("olmo-1b"), SHAPES["decode_32k"])
    assert t["model_flops"] == mf
    assert roofline.measured_share(ok, 0.5) == mf / (0.5 * PEAKS["int8"])
    table = roofline.render(roofline.load_records(str(out), mode="kernel", tag="prepared"))
    assert "| olmo-1b | decode_32k | kernel |" in table and "**memory**" in table
    assert "SKIP: quadratic" in table
    step = dict(ok, shape="serving decode", seq_len=512, global_batch=4, kind="decode")
    assert roofline.model_flops(get_config("olmo-1b"), roofline.cell_shape(step)) == (
        2.0 * roofline.active_params(get_config("olmo-1b")) * 4)


def test_reanalyze_and_topcolls_read_the_saved_trace(cells, capsys):
    out, (ok, *_) = cells
    path = out / (dryrun.stem(ok) + ".json")
    with open(path) as f:
        rec = json.load(f)
    rec["flops_dev"] = 0.0
    with open(path, "w") as f:
        json.dump(rec, f)
    assert reanalyze.reanalyze(str(path))
    with open(path) as f:
        assert json.load(f) == ok
    header, records = cost_analysis.load_trace(str(out / "ops" / (dryrun.stem(ok) + ".jsonl.gz")))
    assert header["memory"] == ok["memory"] and len(records) == ok["ops"]
    assert topcolls.top_collectives(records) == ([], 0)


def test_engine_contexts_of_the_modes():
    assert dryrun.engine_ctx("exact").mode == "exact"
    assert dryrun.engine_ctx("kernel", decode=True).attn_impl == "decode_kernel"
    assert dryrun.engine_ctx("kernel", "xla").attn_impl == "flash"
    assert dryrun.engine_ctx("exact", "flash").attn_impl == "flash"
    assert dryrun.engine_ctx("int8").policy == PrecisionPolicy.accurate(FXP8)
    assert isinstance(dryrun.engine_ctx("carmen"), EngineContext)


def test_chip_smoke_analysis_phase_rehearsed_on_meta(smoke, monkeypatch):
    """``chip_smoke.analysis_phase`` at reduced olmo-1b with the 'card' run
    on meta tensors too (the wrappers count a meta call as a launch, the
    card's memory calls return 0): both gates pass and the report carries
    the roofline terms and ``measured_share`` of the decode step."""
    import importlib

    cfg = reduced(get_config("olmo-1b"))
    monkeypatch.setattr(smoke, "olmo", lambda layers=None: cfg)
    monkeypatch.setattr(smoke, "SLOTS", 4)
    monkeypatch.setattr(smoke, "MAX_LEN", 64)
    monkeypatch.setattr(smoke, "BUCKET", 32)
    monkeypatch.setattr(smoke, "free_card", lambda: None)
    for name in ("synchronize", "memory_allocated", "max_memory_allocated",
                 "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    for mod in ("cordic_fused", "cordic_mac", "cordic_af", "decode_attention",
                "flash_attention", "mla_flash"):
        ops = importlib.import_module(f"repro_torch.kernels.{mod}.ops")
        monkeypatch.setattr(ops, "kernel_call", lambda w, i, c, launched: kernels.kernel_call(
            w, i, c, launched=True))
    ctx = smoke.kernel_ctx()
    model = get_model(cfg)
    weights = prepare_params(model.abstract_params(), ctx.policy, "kernel", specs=model.specs())
    report = smoke.analysis_phase(torch.device("meta"), weights, {"decode_ms_per_step": 2.5})
    decode, prefill = report["steps"]["decode"], report["steps"]["prefill 32"]
    assert decode["records_equal"] and prefill["records_equal"]
    assert decode["kernel_calls"] == {"fused_dot_af/narrow": 15, "gqa_decode_attention/split": 2}
    assert prefill["kernel_calls"] == {"fused_dot_af/wgmma": 15, "gqa_decode_attention/tc": 2}
    assert decode["roofline"]["bottleneck"] == "memory"
    assert decode["bound_over_measured"] == decode["roofline"]["step_s"] / 2.5e-3
    assert decode["measured_share"] > 0 and "roofline" not in prefill
    assert [k["instantiation"] for k in decode["kernels"]] == [
        "fused_dot_af/narrow", "gqa_decode_attention/split"]
