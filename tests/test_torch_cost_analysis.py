"""PyTorch port: the cost analyzer (``repro_torch.launch.cost_analysis``) and
the kernels' cost formulas (``repro_torch.kernels.costs``) against the
reference's HLO analyzer, on the CPU.

* Each case of ``tests/test_hlo_analysis.py`` as torch code: a loop of 7
  matmuls and nested loops give the reference's ``dot_flops`` exactly (eager
  torch dispatches every iteration: no trip correction); a gradient is at
  least twice its forward; a stack of L layers charges each slice once; a
  small tile read inside a loop stays small; large scores are charged;
  fused <= literal; a world-size-1 gloo ``all_reduce`` in a loop of 5 is
  counted 5 times.
* Reduced olmo-1b and deepseek-v3 in exact mode, ``attn_impl="xla"``, on
  seeded CPU weights: ``dot_flops`` equals the reference's for the decode
  step and the prefill forward. The remat train step: olmo-1b exactly;
  deepseek-v3 exactly plus one (B*S, d_model) x (d_model, d_ff_shared)
  product a MoE layer, the shared expert's input projection that XLA's
  remat does not compute again (the port's ``torch.utils.checkpoint``
  recomputes the whole layer): 1.06 % more here, held exactly.
* The fused bytes of a decode step lie between every parameter and cache
  row it reads and the literal model.
* Each kernel wrapper on meta tensors returns its plain version's shape and
  dtype, reports its cost and moves no launch counter; the formulas give the
  numbers ``chip_smoke.py``'s own formulas gave for the ``PERF.md`` §6
  table's shapes; a saved trace sums back to its costs.
"""
import dataclasses
import math
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig as JShape  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import EngineContext as JCtx  # noqa: E402
from repro.data.pipeline import input_specs as ref_input_specs  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_loop import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.train_loop import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import FXP8, FXP16, EngineContext  # noqa: E402
from repro_torch.core.activations import internal_depth  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.launch import cost_analysis as ca  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_loop import TrainConfig, make_train_step  # noqa: E402
from test_torch_mamba2 import numpy_params, one_torch_thread  # noqa: E402,F401

B, S = 4, 64


def _ref(fn, *avals):
    return hlo_analysis.analyze(jax.jit(fn).lower(*avals).compile().as_text())


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


# -- the reference's analyzer cases ----------------------------------------------

def test_loop_of_matmuls_gives_the_reference_flops():
    def body(h, w):
        return jnp.tanh(h @ w), None

    ref = _ref(lambda h, ws: jax.lax.scan(body, h, ws)[0], _sds(32, 64), _sds(7, 64, 64))

    def loop(h, ws):
        for w in ws:
            h = torch.tanh(h @ w)
        return h

    an, _ = ca.analyze(loop, _randn(32, 64), _randn(7, 64, 64, seed=1))
    assert an.costs().dot_flops == ref.dot_flops == 7 * 2 * 32 * 64 * 64


def test_nested_loops_multiply():
    def inner(h, w):
        return jnp.tanh(h @ w), None

    def outer(h, wg):
        return jax.lax.scan(inner, h, wg)[0], None

    ref = _ref(lambda h, ws: jax.lax.scan(outer, h, ws)[0], _sds(16, 32), _sds(3, 4, 32, 32))

    def loop(h, ws):
        for group in ws:
            for w in group:
                h = torch.tanh(h @ w)
        return h

    an, _ = ca.analyze(loop, _randn(16, 32), _randn(3, 4, 32, 32, seed=1))
    assert an.costs().dot_flops == ref.dot_flops == 12 * 2 * 16 * 32 * 32


def test_gradient_counts_both_passes():
    w = _randn(64, 64).requires_grad_(True)
    x = _randn(32, 64, seed=1)

    def loss(w, x):
        return torch.sum((x @ w) ** 2)

    fwd, _ = ca.analyze(loss, w, x)
    both, _ = ca.analyze(lambda w, x: torch.autograd.grad(loss(w, x), w)[0], w, x)
    assert both.costs().dot_flops >= 2 * fwd.costs().dot_flops


def test_stack_of_layers_charges_each_slice_once():
    """A layer's slice of a stacked weight is charged once, not the stack."""
    n_layers, d = 8, 256
    full_bytes = n_layers * d * d * 4

    def loop(h, ws):
        for i in range(n_layers):
            h = torch.tanh(h @ ws[i])
        return h

    c = ca.analyze(loop, _randn(32, d), _randn(n_layers, d, d, seed=1))[0].costs()
    assert full_bytes <= c.hbm_bytes < 3 * full_bytes, (c.hbm_bytes, full_bytes)


def test_small_tiles_read_in_a_loop_stay_small():
    """The reference's flash-like loop: 16 (64, 64) score tiles, each
    written and read once in eager torch, ~k reads and no stacked copies."""
    def flashish(q, ks):
        acc = torch.zeros((q.shape[0],))
        for kk in ks:
            acc = acc + torch.sum(torch.exp(q @ kk.T), -1)
        return acc

    c = ca.analyze(flashish, _randn(64, 32), _randn(16, 64, 32, seed=1))[0].costs()
    assert c.hbm_bytes < 3e6, c.hbm_bytes


def test_large_scores_are_charged():
    def naive(q, k):
        return torch.sum(torch.softmax(q @ k.T, -1), -1)

    c = ca.analyze(naive, _randn(2048, 64), _randn(2048, 64, seed=1))[0].costs()
    assert c.hbm_bytes >= 2 * 2048 * 2048 * 4  # write + read of the scores


def test_fused_model_never_exceeds_the_literal_one():
    def f(x, w):
        h = torch.tanh(x @ w)
        return torch.sum(h * 2.0 + 1.0)

    c = ca.analyze(f, _randn(128, 128), _randn(128, 128, seed=1))[0].costs()
    assert 0 < c.hbm_bytes <= c.hbm_bytes_upper


def test_collectives_counted_each_iteration():
    """A world-size-1 gloo all_reduce in a loop of 5, in-place and
    functional: 5 x 16 * 16 * 4 bytes each."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as fc

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
                                world_size=1, rank=0)
        try:
            def body(xs):
                total = torch.zeros(())
                for x in xs:
                    y = x.clone()
                    dist.all_reduce(y)
                    total = total + torch.sum(y)
                return total

            def functional(xs):
                return sum(torch.sum(fc.wait_tensor(fc.all_reduce(x, "sum", dist.group.WORLD)))
                           for x in xs)

            xs = _randn(5, 16, 16)
            for fn in (body, functional):
                c = ca.analyze(fn, xs)[0].costs()
                assert c.collective_bytes == 5 * 16 * 16 * 4, fn.__name__
                assert c.collective_by_kind == {"all-reduce": 5 * 16 * 16 * 4}
        finally:
            dist.destroy_process_group()


# -- reduced models against the reference ----------------------------------------

def _models(arch):
    jcfg, cfg = ref_reduced(ref_get_config(arch)), reduced(get_config(arch))
    jm, m = ref_get_model(jcfg), get_model(cfg)
    params = m.load_numpy(numpy_params(jm.specs()), "cpu")
    return jcfg, jm, cfg, m, params


JCTX = JCtx(mode="exact", attn_impl="xla", compute_dtype=jnp.float32)
CTX = EngineContext(mode="exact", attn_impl="xla", compute_dtype=torch.float32)


def _tokens(cfg, *shape):
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(np.int64))


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v3-671b"])
def test_decode_and_prefill_flops_equal_the_reference(arch):
    jcfg, jm, cfg, m, params = _models(arch)
    jp = jm.abstract_params(jnp.float32)
    cache = jm.make_cache(B, S, jnp.float32, abstract=True)
    toks = jax.ShapeDtypeStruct((B, 1), jnp.int32)
    ref_decode = _ref(lambda p, t, c: jm.decode_step(p, t, c, JCTX), jp, toks, cache)
    ref_prefill = _ref(lambda p, b: jm.forward(p, b, JCTX)[0], jp,
                       ref_input_specs(jcfg, JShape("x", S, B, "prefill")))

    decode, _ = ca.analyze(m.decode_step, params, _tokens(cfg, B, 1), m.make_cache(B, S), CTX)
    prefill, _ = ca.analyze(lambda p, b: m.forward(p, b, CTX)[0], params,
                            {"tokens": _tokens(cfg, B, S)})
    assert decode.costs().dot_flops == ref_decode.dot_flops
    assert prefill.costs().dot_flops == ref_prefill.dot_flops


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v3-671b"])
def test_remat_train_step_flops_against_the_reference(arch):
    """olmo-1b exactly. deepseek-v3: XLA's remat computes one of the shared
    expert's two input projections ((B*S, d_model) x (d_model, d_ff_shared),
    up or gate: the same shape) once, where the port's checkpoint recomputes
    the layer; so the port counts that product once more a MoE layer, and
    nothing else differs."""
    jcfg, jm, cfg, m, params = _models(arch)
    jp = jm.abstract_params(jnp.float32)
    jb = ref_input_specs(jcfg, JShape("x", S, B, "train"))
    ref = _ref(ref_make_train_step(jm, JCTX, JTrainConfig(remat=True)), jp,
               jopt.abstract_state(jp), jb)
    batch = {"tokens": _tokens(cfg, B, S), "targets": _tokens(cfg, B, S)}
    an, _ = ca.analyze(make_train_step(m, CTX, TrainConfig(remat=True)), params,
                       opt.init_state(params), batch)
    extra = 0.0
    if cfg.moe and cfg.moe.num_shared_experts:
        moe_layers = (cfg.num_layers - cfg.moe.first_dense_layers) // cfg.moe.moe_every
        extra = moe_layers * 2.0 * B * S * cfg.d_model * cfg.moe.d_ff_shared
        assert 0 < extra / ref.dot_flops < 0.011
    assert an.costs().dot_flops == ref.dot_flops + extra


def test_decode_bytes_cover_every_parameter_and_cache_row():
    _, _, cfg, m, params = _models("olmo-1b")
    cache = m.make_cache(B, S)
    an, _ = ca.analyze(m.decode_step, params, _tokens(cfg, B, 1), cache, CTX)
    c = an.costs()
    param_bytes = sum(t.numel() * 4 for _, t in _leaves(params) if _ != ("embed",))
    cache_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(cache))
    assert param_bytes + cache_bytes <= c.hbm_bytes <= c.hbm_bytes_upper
    mem = an.memory()
    assert mem["argument_size_in_bytes"] >= param_bytes + cache_bytes
    assert mem["output_size_in_bytes"] >= B * cfg.vocab_size * 4
    assert mem["temp_size_in_bytes"] > 0


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


# -- the wrappers on meta tensors ------------------------------------------------

def _meta_cases():
    """(kernel, wrapper call on meta, plain call on CPU): each kernel at a
    small shape, both calls on the same shapes."""
    from repro_torch.core.backends.kernel import POINT_LEN
    from repro_torch.kernels.cordic_af import af_softmax, multi_af
    from repro_torch.kernels.cordic_fused import fused_dot_af
    from repro_torch.kernels.cordic_mac import mac_matmul
    from repro_torch.kernels.decode_attention import gqa_decode_attention, mla_decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.int_dot import to_k_major
    from repro_torch.kernels.mla_flash import mla_flash_attention

    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    point = torch.tensor([4, 6, -128, 127, 7], dtype=torch.int32)
    assert point.numel() == POINT_LEN
    return [
        ("fused_dot_af", fused_dot_af,
         lambda d: (t(3, 2, 64).to(d), to_k_major(t(64, 40, dtype=torch.int8)).to(d),
                    point.to(d)), dict(af_mode="swish")),
        ("cordic_mac", mac_matmul,
         lambda d: (t(24, 64, dtype=torch.int8).to(d),
                    to_k_major(t(64, 40, dtype=torch.int8)).to(d), t(24, 1).to(d),
                    t(1, 40).to(d)), {}),
        ("af_elementwise", multi_af, lambda d: (t(2, 3, 50).to(d), "gelu"), dict(depth=7)),
        ("af_softmax", af_softmax, lambda d: (t(5, 300).to(d),), dict(depth=7)),
        ("gqa_decode_attention", gqa_decode_attention,
         lambda d: (t(2, 3, 4, 32).to(d), t(2, 16, 2, 32).to(d), t(2, 16, 2, 32).to(d),
                    t(2, 3, dtype=torch.int32).to(d)), dict(scale=0.2)),
        ("mla_decode_attention", mla_decode_attention,
         lambda d: (t(2, 1, 4, 16).to(d), t(2, 1, 4, 8).to(d), t(2, 16, 16).to(d),
                    t(2, 16, 8).to(d), t(2, 1, dtype=torch.int32).to(d)), dict(scale=0.2)),
        ("flash_attention", flash_attention,
         lambda d: (t(1, 9, 4, 32).to(d), t(1, 9, 2, 32).to(d), t(1, 9, 2, 32).to(d)), {}),
        ("mla_flash_attention", mla_flash_attention,
         lambda d: (t(1, 9, 4, 16).to(d), t(1, 9, 4, 8).to(d), t(1, 9, 16).to(d),
                    t(1, 9, 8).to(d)), dict(scale=0.2)),
    ]


@pytest.mark.parametrize("case", _meta_cases(), ids=lambda c: c[0])
def test_meta_call_reports_its_cost_and_launches_nothing(case):
    name, wrapper, args, kw = case
    kernels.reset_launch_counts()
    want = wrapper(*args("cpu"), **kw)
    an = ca.Analyzer()
    got = an.run(lambda *a: wrapper(*a, **kw), *args("meta"))
    assert got.is_meta and got.shape == want.shape and got.dtype == want.dtype
    assert sum(kernels.launch_counts().values()) == 0
    kernel_records = [r for r in an.records if "kernel" in r]
    assert [r["kernel"] for r in kernel_records] == [name]
    assert [r for r in an.records if "kernel" not in r] == []  # its own ops are skipped
    assert an.costs().kernel_totals() == {name: 1}


def test_meta_kernel_mode_decode_counts_each_wrapper_call():
    """Reduced olmo-1b prepared in kernel mode on meta: one fused record a
    dot, one GQA record a layer, every one on the plan the card would take
    (narrow at decode), and no launch counted."""
    from repro_torch.core import PrecisionPolicy, prepare_params

    cfg = reduced(get_config("olmo-1b"))
    m = get_model(cfg)
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(FXP8),
                        compute_dtype=torch.float32, attn_impl="decode_kernel")
    params = prepare_params(m.abstract_params(), ctx.policy, "kernel", specs=m.specs())
    kernels.reset_launch_counts()
    an, (logits, _) = ca.analyze(m.decode_step, params,
                                 torch.empty((B, 1), dtype=torch.int32, device="meta"),
                                 m.make_cache(B, S, device="meta"), ctx)
    assert logits.is_meta and logits.shape == (B, 1, cfg.vocab_size)
    assert an.costs().kernels == {"fused_dot_af/narrow": 7 * cfg.num_layers + 1,
                                  "gqa_decode_attention/split": cfg.num_layers}
    assert sum(kernels.launch_counts().values()) == 0


# -- the formulas against the smoke's earlier ones --------------------------------

# chip_smoke.py's bound formulas as they were before they moved to
# kernels/costs.py: the yardstick the PERF.md §6 bounds were printed with
_HBM, _INT8, _F32, _BF16, _INT32, _TF32 = (3.35e12, 1.979e15, 67e12, 989e12,
                                            64 * 132 * 1.98e9, 494.7e12)


def _bound(bytes_moved, ops, ops_per_s):
    t_bytes = bytes_moved / _HBM * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bound_tf32(bytes_moved, flops, passes=3.0):
    return max(bytes_moved / _HBM, passes * flops / _TF32) * 1e3


def _fused_bound(m, k, n, af, af_depth, fmt, w_bytes=1):
    t_bytes, _ = _bound(m * k * 4 + k * n * w_bytes + m * n * 4 + 20, 0.0, _INT8)
    t_mma = (2.0 * m * n * k / _INT8 if w_bytes == 1 else 1.0 * m * n * k / _INT32) * 1e3
    t_af = 0.0
    if af != "identity":
        t_af = costs.af_int_ops(af, internal_depth(af_depth, fmt)) * m * n / _INT32 * 1e3
    return max((t_bytes, "bytes"), (t_mma, "operations"), (t_af, "operations (AF int32)"))


@pytest.mark.parametrize("m,k,n,af,fmt,w_bytes", [
    (4, 2048, 8192, "identity", FXP8, 1), (512, 2048, 8192, "identity", FXP8, 1),
    (1024, 2048, 2048, "identity", FXP8, 1), (4, 2048, 8192, "swish", FXP8, 1),
    (4, 5120, 152064, "identity", FXP8, 1), (512, 3584, 14336, "swish", FXP8, 1),
    (4, 2048, 50304, "identity", FXP8, 2), (512, 8192, 2048, "identity", FXP8, 2),
    (32, 2048, 8192, "swish", FXP16, 2), (20, 2048, 50304, "identity", FXP8, 1)])
def test_fused_formula_equals_the_smokes(m, k, n, af, fmt, w_bytes):
    depth = fmt.frac + 1 if fmt is FXP8 else 15
    got = costs.fused_dot_af(m, n, k, w_bytes, af, depth, fmt).bound()
    assert got == _fused_bound(m, k, n, af, depth, fmt, w_bytes)


@pytest.mark.parametrize("b,s,t,h,kv,hd,rows,scored", [
    (4, 1, 512, 16, 16, 128, 4 * 512, 4 * 512), (1, 512, 512, 16, 16, 128, 512, 512 * 513 // 2),
    (1, 16, 512, 40, 8, 128, 16, 136), (4, 5, 512, 16, 16, 128, 1900, 9410)])
def test_gqa_formula_equals_the_smokes(b, s, t, h, kv, hd, rows, scored):
    nbytes = rows * kv * hd * 4 * 2 + 2 * (b * s * h * hd) * 4 + b * s * 4
    flops = 4.0 * h * hd * scored
    cost = costs.gqa_decode_attention(b, s, h, t, kv, hd, keys=(rows, scored))
    assert cost.bound() == _bound(nbytes, flops, _F32)
    assert cost.bound_tf32_ms() == _bound_tf32(nbytes, flops)
    full = costs.gqa_decode_attention(b, s, h, t, kv, hd)  # the dry run's: every key
    assert full.dot_flops == 4.0 * h * hd * b * s * t


@pytest.mark.parametrize("b,s,t,h,r,rd,keys", [
    (4, 1, 512, 128, 512, 64, (2048, 2048, 2048, 2048)),
    (1, 512, 512, 128, 512, 64, (512, 512, 131328, 131328)),
    (3, 5, 100, 7, 512, 64, (240, 300, 1100, 1180))])
def test_mla_formula_equals_the_smokes(b, s, t, h, r, rd, keys):
    rows_qk, rows_v, seen, mean = keys
    flops = 2.0 * h * (seen * (r + rd) + mean * r)
    nbytes = (rows_qk * (r + rd) + (rows_v - rows_qk) * r + b * s * h * (r + rd + r)) * 4
    cost = costs.mla_decode_attention(b, s, h, t, r, rd, keys=keys)
    assert cost.bound() == _bound(nbytes + b * s * 4, flops, _F32)
    assert cost.bound_tf32_ms() == _bound_tf32(nbytes + b * s * 4, flops)


@pytest.mark.parametrize("b,s,h,kv,d,elem,causal", [
    (2, 512, 16, 16, 128, 4, True), (1, 2048, 16, 16, 128, 4, True),
    (2, 512, 16, 16, 128, 2, True), (1, 256, 16, 16, 64, 4, False)])
def test_flash_formulas_equal_the_smokes(b, s, h, kv, d, elem, causal):
    pairs = h * costs.causal_pairs(b, s, s, causal)
    nbytes = (2 * b * s * h * d + 2 * b * s * kv * d) * elem
    cost = costs.flash_attention(b, s, h, kv, d, elem, causal)
    assert cost.bound() == _bound(nbytes, 4.0 * d * pairs, _BF16 if elem == 2 else _F32)
    assert cost.bound_tf32_ms() == _bound_tf32(nbytes, 4.0 * d * pairs,
                                               1.5 if elem == 2 else 3.0)
    r, rd = 512, 64
    mla = costs.mla_flash_attention(b, s, 128, r, rd)
    pairs = 128 * costs.causal_pairs(b, s, s, True)
    nbytes = (b * s * 128 * (r + rd + r) + b * s * (r + rd)) * 4
    assert mla.bound() == _bound(nbytes, 2.0 * pairs * (r + rd + r), _F32)


@pytest.mark.parametrize("fmt", [FXP8, FXP16], ids=str)
def test_af_mac_and_softmax_formulas_equal_the_smokes(fmt):
    depth = fmt.frac + 1 if fmt is FXP8 else 15
    n = 4 * 256 * 8 * 2048
    for mode in ("relu", "tanh", "sigmoid", "swish", "gelu", "selu"):
        ops = costs.af_int_ops(mode, internal_depth(depth, fmt))
        assert costs.af_elementwise(n, mode, depth, fmt).bound() == _bound(
            8.0 * n, float(ops) * n, _INT32)
    ops = costs.softmax_int_ops(internal_depth(depth, fmt))
    assert costs.af_softmax(4 * 50304, depth, fmt).bound() == _bound(
        8.0 * 4 * 50304, float(ops) * 4 * 50304, _INT32)
    for m, k, n in ((4, 2048, 8192), (512, 2048, 8192), (512, 2048, 50304)):
        assert costs.cordic_mac(m, n, k, 1).bound() == _bound(
            m * k + k * n + (m + n) * 4 + m * n * 4, 2.0 * m * n * k, _INT8)


def test_saved_trace_sums_back_to_its_costs(tmp_path):
    _, _, cfg, m, params = _models("olmo-1b")
    an, _ = ca.analyze(m.decode_step, params, _tokens(cfg, B, 1), m.make_cache(B, S), CTX)
    path = str(tmp_path / "t.jsonl.gz")
    ca.save_trace(path, an.records, header=dict(memory=an.memory()))
    header, records = ca.load_trace(path)
    assert header["memory"] == an.memory()
    assert ca.first_difference(records, an.records) is None
    assert dataclasses.asdict(ca.summarize(records)) == dataclasses.asdict(an.costs())
    assert math.isfinite(an.costs().hbm_bytes)
