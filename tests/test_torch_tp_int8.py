"""PyTorch port: kernel 6's split form and the int8 mode and per-call
weights served tensor-parallel.

A row-parallel product splits K across ranks. In the int8 mode and per call
each rank runs the MAC-array kernel's partial-sum instantiation
(``mac_matmul_partial``: the exact int32 dot, no scales), the int32 sums are
added across ranks (wrapping modulo 2**32 in any order) and the epilogue
kernel (``mac_epilogue``: ``(float(acc) * x_scale) * w_scale``, +ReLU) runs
on the sum. On the CPU the wrappers run their plain twins, which must
compose, for K cut into 2 and 4 shards (uneven ones too), bitwise to the
reference's Pallas ``mac_matmul`` (interpret mode) over the whole of K,
FxP16 sums that wrap int32 and ``fuse_relu`` included; and, quantized with
the maxima of the whole K (the all-reduced per-token and per-channel
maxima), bitwise to the reference's ``int8_dot``.

Served on spawned ``gloo`` ranks (one torch thread each; slots 4, max_len
32, burst 4, max_new 6, reduced olmo-1b): the int8 mode prepared and per
call, kernel mode per call, a pinned int8 bank and greedy speculation on
one, at (1,2) and (2,2),
give streams and f32 top-2 margins bitwise the port's ``mesh=None`` ones,
and streams equal to the reference's ``mesh=None`` ones. The CLI's
``--mesh`` with ``--mode int8 --calibrate`` resolves the ``mesh=None``
policy and streams. The card kernels are held against these twins in
``chip_smoke.py`` (``check_tp_kernels``).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.backends.int8 import int8_dot as jax_int8_dot  # noqa: E402
from repro.core.backends.int8 import quantize_weight as jax_quantize_weight  # noqa: E402
from repro.kernels.cordic_mac.kernel import mac_matmul as jax_mac_matmul  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core.backends.int8 import (quantize_tokens, quantize_weight,  # noqa: E402
                                            _drop_bits)
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.kernels.cordic_fused.ref import wrap_int32  # noqa: E402
from repro_torch.kernels.cordic_mac import (mac_epilogue, mac_matmul,  # noqa: E402
                                            mac_matmul_partial)
from repro_torch.kernels.int_dot import to_k_major  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402

import _tp_ranks  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401
from test_torch_tp_serving import numpy_params  # noqa: E402

SPLITS = {"2": (0.5,), "4": (0.25, 0.5, 0.75), "uneven": (0.1, 0.7)}
SHAPES = ((1, 2), (2, 2))
M, K, N = 8, 256, 128  # the reference kernel's tiles: bm 8, bk 128, bn 128


def _cuts(k, fracs):
    edges = [0] + [int(round(k * f)) for f in fracs] + [k]
    return list(zip(edges, edges[1:]))


def _operands(case: str, seed: int = 0):
    """int8 (FxP8) or int16 (FxP16 at full range: the int32 dot wraps)
    operands and positive and negative f32 scales, as numpy."""
    rng = np.random.default_rng(seed)
    lim, dt = (127, np.int8) if case == "fxp8" else (32767, np.int16)
    x_q = rng.integers(-lim, lim + 1, (M, K)).astype(dt)
    w_q = rng.integers(-lim, lim + 1, (K, N)).astype(dt)
    x_scale = (rng.standard_normal((M, 1)) * 0.01).astype(np.float32)
    w_scale = (rng.standard_normal((1, N)) * 0.01).astype(np.float32)
    return x_q, w_q, x_scale, w_scale


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("case", ["fxp8", "fxp16"])
@pytest.mark.parametrize("split", sorted(SPLITS))
def test_split_sum_epilogue_equals_the_reference_mac_matmul(split, case, relu):
    x_q, w_q, x_scale, w_scale = _operands(case)
    want = np.asarray(jax_mac_matmul(jnp.asarray(x_q), jnp.asarray(w_q), jnp.asarray(x_scale),
                                     jnp.asarray(w_scale), bm=8, bn=128, bk=128,
                                     fuse_relu=relu, interpret=True))
    x, w = torch.from_numpy(x_q), torch.from_numpy(w_q)
    parts = [mac_matmul_partial(x[:, a:b].contiguous(), to_k_major(w[a:b]))
             for a, b in _cuts(K, SPLITS[split])]
    assert all(p.dtype == torch.int32 for p in parts)
    acc = wrap_int32(sum(p.to(torch.int64) for p in parts))
    exact = x_q.astype(np.int64) @ w_q.astype(np.int64)
    if case == "fxp16":  # the sums really wrap
        assert np.abs(exact).max() > 2**31
    xs, ws = torch.from_numpy(x_scale), torch.from_numpy(w_scale)
    got = mac_epilogue(acc, xs, ws, fuse_relu=relu)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(mac_matmul(x, to_k_major(w), xs, ws, fuse_relu=relu).numpy(),
                                  want)


@pytest.mark.parametrize("eff_bits", [8, 5])
@pytest.mark.parametrize("weights", ["prepared", "per-call"])
@pytest.mark.parametrize("split", sorted(SPLITS))
def test_split_int8_dot_equals_the_reference(split, weights, eff_bits):
    """Each shard quantized with the whole K's maxima (what the ranks'
    all-reduced MAX gives), its partial int32 dot, the int32 sum and the
    epilogue: bitwise the reference's ``int8_dot`` over the whole of K. A
    prepared bank is quantized whole and sliced."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((5, K)) * np.linspace(0.1, 3.0, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    if weights == "prepared":
        jq, js = jax_quantize_weight(jnp.asarray(w), eff_bits=eff_bits)
        want = jax_int8_dot(jnp.asarray(x), jq, effective_bits=8, w_scale=js)
    else:
        want = jax_int8_dot(jnp.asarray(x), jnp.asarray(w), effective_bits=eff_bits)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    x_max = torch.amax(xt.abs(), dim=-1, keepdim=True)
    w_max = torch.amax(wt.abs(), dim=0, keepdim=True)
    whole_q, whole_s = quantize_weight(wt, eff_bits=eff_bits)
    parts, scales = [], set()
    for a, b in _cuts(K, SPLITS[split]):
        xq, x_scale = quantize_tokens(
            xt[:, a:b], lambda t, d: torch.maximum(torch.amax(t, dim=tuple(d), keepdim=True), x_max))
        if weights == "prepared":
            wq, w_scale = whole_q[a:b], whole_s
        else:
            wq, w_scale = quantize_weight(
                wt[a:b],
                amax=lambda t, d: torch.maximum(torch.amax(t, dim=tuple(d), keepdim=True), w_max))
            if eff_bits < 8:
                wq = _drop_bits(wq, eff_bits)
        scales.add((x_scale.numpy().tobytes(), w_scale.numpy().tobytes()))
        parts.append(mac_matmul_partial(xq, to_k_major(wq)))
    assert len(scales) == 1  # every shard quantizes at the whole K's scales
    acc = wrap_int32(sum(p.to(torch.int64) for p in parts))
    got = mac_epilogue(acc, x_scale, w_scale.reshape(1, -1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_meta_branch_plans_without_launching():
    """On meta tensors the split wrappers take the plan, return empty
    results of the kernel's shape and dtype and count no launch; the costs
    are one formula each."""
    kernels.reset_launch_counts()
    x = torch.zeros((16, 4096), dtype=torch.int8, device="meta")
    w = to_k_major(torch.zeros((4096, 2048), dtype=torch.int8)).to("meta")
    acc = mac_matmul_partial(x, w)
    assert acc.dtype == torch.int32 and tuple(acc.shape) == (16, 2048) and acc.is_meta
    out = mac_epilogue(acc, torch.zeros((16, 1), device="meta"),
                       torch.zeros((1, 2048), device="meta"), fuse_relu=True)
    assert out.dtype == torch.float32 and tuple(out.shape) == (16, 2048)
    assert sum(kernels.launch_counts().values()) == 0
    assert "cordic_mac_partial/narrow" in kernels.launch_counts()
    part = costs.cordic_mac_partial(4, 2048, 4096, 1)
    assert part.hbm_bytes == 4 * 4096 + 4096 * 2048 + 4 * 2048 * 4
    assert part.dot_flops == 2.0 * 4 * 2048 * 4096
    assert part.ops_by_kind() == {"int8": 2.0 * 4 * 2048 * 4096}
    assert costs.cordic_mac_partial(4, 2048, 4096, 2).ops_by_kind() == {
        "int32": 4.0 * 2048 * 4096}
    epi = costs.cordic_mac_epilogue(4, 2048)
    assert epi.hbm_bytes == 8 * 4 * 2048 + (4 + 2048) * 4 and epi.work == ()
    with pytest.raises(ValueError, match="int32"):
        mac_epilogue(torch.zeros((2, 3), device="meta"), torch.zeros((2, 1), device="meta"),
                     torch.zeros((1, 3), device="meta"))


# ---------------------------------------------------------------------------
# served on a mesh
# ---------------------------------------------------------------------------

JOBS = (dict(mode="int8"), dict(mode="int8", per_call=True), dict(mode="kernel", per_call=True),
        dict(mode="int8", bank="pinned"), dict(mode="int8", bank="spec"))


@pytest.fixture(scope="module")
def olmo():
    return numpy_params("olmo-1b")


@pytest.fixture(scope="module")
def meshed(olmo):
    jobs = [dict(job, arch="olmo-1b", params=olmo[1]) for job in JOBS]
    return {shape: spawn(_tp_ranks.run_jobs, shape[0] * shape[1], args=(shape, jobs),
                         timeout=240) for shape in SHAPES}


@pytest.fixture(scope="module")
def bases(olmo):
    return [_tp_ranks.serve(dict(job, arch="olmo-1b", params=olmo[1])) for job in JOBS]


def _reference(model, params, mode, per_call):
    import jax

    from repro.core import EngineContext as JCtx, PrecisionPolicy as JPolicy
    from repro.serve.engine import BatchedServer as JServer, Request as JRequest

    ctx = JCtx(mode=mode, policy=JPolicy.accurate(), compute_dtype=jnp.float32,
               attn_impl="decode_kernel")
    server = JServer(model, ctx, jax.tree.map(jnp.asarray, params), slots=4, max_len=32,
                     burst=4, prepare_weights=not per_call)
    rng = np.random.default_rng(0)
    reqs = [JRequest(i, rng.integers(0, model.cfg.vocab_size, 3 + i).astype(np.int32), 6,
                     seed=10 + i) for i in range(4)]
    return server.run(reqs)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("job", range(len(JOBS)),
                         ids=["int8", "int8-per-call", "kernel-per-call", "int8-pinned-bank",
                              "int8-speculative"])
def test_meshed_streams_and_margins_are_bitwise_mesh_none(meshed, bases, job, shape):
    base = bases[job]
    for rank, jobs in enumerate(meshed[shape]):
        assert jobs[job]["streams"] == base["streams"], (JOBS[job], shape, rank)
        assert jobs[job]["margins"] == base["margins"], (JOBS[job], shape, rank)
    assert len({tuple(v) for v in base["streams"].values()}) > 1


@pytest.mark.parametrize("job", range(3), ids=["int8", "int8-per-call", "kernel-per-call"])
def test_mesh_none_streams_equal_the_reference(olmo, bases, job):
    spec = JOBS[job]
    assert bases[job]["streams"] == _reference(*olmo, spec["mode"], spec.get("per_call", False))


def test_int8_banks_serve_the_prepared_streams(bases):
    """The pinned bank's accurate point is the static int8 tree, and greedy
    speculation verified there streams the same."""
    assert bases[3]["streams"] == bases[0]["streams"]
    assert bases[4]["streams"] == bases[0]["streams"]
    assert bases[4]["rounds"] > 0


def test_cli_mesh_int8_calibrate_and_per_call(tmp_path, capfd):
    """``--mesh 1,2`` with ``--mode int8 --calibrate`` saves the policy of
    the run without ``--mesh`` and serves its streams; so does
    ``--per-call`` in kernel mode."""
    argv = ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--requests", "4",
            "--slots", "2", "--max-new", "4"]
    mesh = ["--mesh", "1,2", "--dist-backend", "gloo"]
    cal = ["--mode", "int8", "--calibrate", "--cycle-reduction", "0.33"]
    want = cli.main(argv + cal + ["--save-policy", str(tmp_path / "p0.json")])
    got = cli.main(argv + cal + mesh + ["--save-policy", str(tmp_path / "p1.json")])
    assert got == want
    p0, p1 = (json.loads((tmp_path / f"p{i}.json").read_text()) for i in range(2))
    assert p0 == p1
    per_call = ["--mode", "kernel", "--per-call"]
    assert cli.main(argv + per_call + mesh) == cli.main(argv + per_call)
    assert capfd.readouterr().out.count("calibration scan:") == 2  # rank 1 prints nothing
