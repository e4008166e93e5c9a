"""PyTorch port: kernel 1's split form for tensor-parallel row products.

A row-parallel product splits K across ranks; each rank runs the partial-sum
instantiation (``fused_dot_partial``: the exact int32 dot, no epilogue), the
int32 sums are added across ranks (wrapping modulo 2**32 in any order) and
the epilogue kernel (``fused_epilogue``) runs on the sum. On the CPU the
wrappers run their plain twins, which must compose, for K cut into 2 and 4
shards (uneven ones too), bitwise to the reference's ``fused_dot_af_ref``
over the whole of K: every ``FUSED_AFS`` mode, FxP8 and FxP16, bf16 rounding
on and off, and through sums that wrap int32. A rank prepares only its
shard of a weight: that must equal the shard of the prepared bank, bit for
bit, in every mode, and a kernel bank's shard is K-major with its own K
padding. The card kernels are held against these twins in ``chip_smoke.py``
(``check_tp_kernels``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.cordic_fused import fused_dot_af_ref as jax_ref  # noqa: E402
from repro.kernels.cordic_fused import make_point as jax_point  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import FXP8, FXP16, PrecisionPolicy  # noqa: E402
from repro_torch.core.backends import PreparedWeight, prepare_params  # noqa: E402
from repro_torch.core.backends.kernel import make_point  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.kernels.cordic_fused import (  # noqa: E402
    FUSED_AFS, fused_dot_af, fused_dot_partial, fused_epilogue)
from repro_torch.kernels.cordic_fused.ref import wrap_int32  # noqa: E402
from repro_torch.kernels.int_dot import is_k_major, padded_k, to_k_major  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from test_torch_cordic_fused import FMTS, UNITS, _operands, _prepared  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

SPLITS = {"2": (0.5,), "4": (0.25, 0.5, 0.75), "uneven": (0.1, 0.7)}


def _cuts(k, fracs):
    edges = [0] + [int(round(k * f)) for f in fracs] + [k]
    return list(zip(edges, edges[1:]))


def _split_sum(x, ints, point, cuts):
    """Each shard's partial int32 dot, summed as the ranks' int32 all-reduce
    sums them (wrapping modulo 2**32)."""
    parts = [fused_dot_partial(x[:, a:b].contiguous(), to_k_major(ints[a:b]), point)
             for a, b in cuts]
    assert all(p.dtype == torch.int32 for p in parts)
    return wrap_int32(sum(p.to(torch.int64) for p in parts))


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("name", sorted(FMTS))
def test_split_sum_epilogue_equals_the_reference_fused_chain(name, split):
    """Every AF mode and bf16 rounding on and off, against the reference's
    fused_dot_af_ref over the whole of K."""
    m, k, n, depth = 5, 300, 40, 6
    x, w = _operands(m, k, n, seed=3)
    grid, ints = _prepared(w, depth, name)
    jfmt, tfmt = FMTS[name]
    point = make_point(depth, tfmt, UNITS[name][1])
    acc = _split_sum(torch.from_numpy(x), ints, point, _cuts(k, SPLITS[split]))
    for af in FUSED_AFS:
        for compute_round in (False, True):
            kw = dict(af_mode=af, af_depth=depth, compute_round=compute_round)
            want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(grid),
                                      jax_point(depth, jfmt, UNITS[name][0]), af_fmt=jfmt, **kw))
            got = fused_epilogue(acc, point, af_fmt=tfmt, **kw).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{af} {compute_round}")
            whole = fused_dot_af(torch.from_numpy(x), ints, point, af_fmt=tfmt, **kw).numpy()
            np.testing.assert_array_equal(got, whole)


def test_split_sums_that_wrap_int32():
    """FxP16 operands at the grid's edge: each shard's partial and their sum
    pass 2**31 and wrap; the wrapped sum's epilogue is still the whole-K
    chain's (which wraps the same way)."""
    m, k, n, depth = 2, 64, 3, 14
    x = np.full((m, k), 7.9, np.float32)
    x[1] *= -1
    w = np.full((k, n), 0.999, np.float32)
    grid, ints = _prepared(w, depth, "fxp16")
    point = make_point(depth, FXP16, UNITS["fxp16"][1])
    parts = [fused_dot_partial(torch.from_numpy(x[:, a:b].copy()), to_k_major(ints[a:b]), point)
             for a, b in _cuts(k, (0.5,))]
    xq = round(7.9 * 2**FXP16.frac)
    assert xq * int(ints[0, 0]) * k / 2 > 2**31  # each shard's dot and their sum wrap
    acc = wrap_int32(sum(p.to(torch.int64) for p in parts))
    for af in ("identity", "sigmoid"):
        want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(grid),
                                  jax_point(depth, FMTS["fxp16"][0], UNITS["fxp16"][0]),
                                  af_mode=af, af_depth=depth, af_fmt=FMTS["fxp16"][0],
                                  compute_round=False))
        got = fused_epilogue(acc, point, af_mode=af, af_depth=depth, af_fmt=FXP16).numpy()
        np.testing.assert_array_equal(got, want)


def test_wrappers_refuse_and_cost():
    x = torch.zeros((2, 8))
    w = to_k_major(torch.zeros((8, 4), dtype=torch.int8))
    point = make_point(6, FXP8, UNITS["fxp8"][1])
    with pytest.raises(ValueError, match="contraction"):
        fused_dot_partial(torch.zeros((2, 7)), w, point)
    with pytest.raises(ValueError, match="af_mode"):
        fused_epilogue(torch.zeros((2, 4), dtype=torch.int32), point, af_mode="tanhh")
    assert fused_dot_partial(x, w, point).dtype == torch.int32
    part = costs.fused_dot_partial(4, 2048, 4096, 1)
    assert part.hbm_bytes == 4 * 4096 * 4 + 4096 * 2048 + 4 * 2048 * 4 + 20
    assert part.ops_by_kind() == {"int8": 2.0 * 4 * 2048 * 4096}
    epi = costs.fused_epilogue(4, 2048, "identity", 7, FXP8)
    assert epi.hbm_bytes == 8 * 4 * 2048 + 20 and epi.work == ()
    assert costs.fused_epilogue(4, 2048, "swish", 7, FXP8).ops_by_kind()["int32"] > 0


def test_wrappers_on_meta_tensors_plan_without_launching():
    from repro_torch import kernels

    kernels.reset_launch_counts()
    w = to_k_major(torch.zeros((64, 32), dtype=torch.int8)).to("meta")
    point = make_point(6, FXP8, UNITS["fxp8"][1]).to("meta")
    out = fused_dot_partial(torch.zeros((3, 64), device="meta"), w, point)
    assert (out.shape, out.dtype, out.device.type) == ((3, 32), torch.int32, "meta")
    out = fused_epilogue(out, point)
    assert (out.shape, out.dtype) == ((3, 32), torch.float32)
    assert sum(kernels.launch_counts().values()) == 0


@pytest.fixture(scope="module")
def olmo():
    model = get_model(reduced(get_config("olmo-1b")))
    raw = model.init(torch.Generator().manual_seed(0))
    return model, raw


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("mode", ["kernel", "carmen"])
@pytest.mark.parametrize("rank", [0, 1, 3])
def test_a_prepared_shard_equals_the_shard_of_the_prepared_bank(olmo, mode, rank):
    """On a (2, 2) mesh: prepare the rank's raw shards, or shard the whole
    prepared bank; the payloads and points agree bit for bit (the
    signed-digit rounding is elementwise), and every integer bank's shard is
    K-major (its 2-D layer views pass the kernels' layout check) with its
    own K padding. (int8's per-channel scale is a max over K, so a K shard's
    own scale is not the bank's: the int8 mode is refused under a mesh.)"""
    model, raw = olmo
    mesh = Mesh({"data": 2, "model": 2}, rank=rank)
    policy = PrecisionPolicy.accurate(FXP16 if mode == "carmen" else FXP8)
    local = prepare_params(partition.shard_params(raw, model.specs(), mesh), policy, mode,
                           specs=model.specs())
    whole = prepare_params(raw, policy, mode, specs=model.specs())
    placed = partition.shard_params(whole, model.specs(), mesh)
    pairs = dict(_leaves(placed))
    n_banks = 0
    for path, a in _leaves(local):
        b = pairs[path]
        if not isinstance(a, PreparedWeight):
            assert torch.equal(a, b), path
            continue
        n_banks += 1
        assert torch.equal(a.data, b.data), path
        for part in ("point", "scale"):
            pa, pb = getattr(a, part), getattr(b, part)
            assert (pa is None) == (pb is None) and (pa is None or torch.equal(pa, pb)), path
        if not a.data.dtype.is_floating_point:
            view = b.data if b.data.ndim == 2 else b.data[0]
            k = view.shape[0] if path[-1] != "wo" else view.shape[0] * view.shape[1]
            two_d = view.reshape(k, -1)
            assert is_k_major(two_d), path
            assert two_d.stride(1) == padded_k(k, two_d.element_size()), path
    assert n_banks == 1 + 7 * 1  # lm_head and one stacked bank a dot
    # the shard of a shard is itself: placement is idempotent
    again = partition.shard_params(placed, model.specs(), mesh)
    assert all(x is y for (_, x), (_, y) in zip(_leaves(placed), _leaves(again)))


def test_sharded_load_equals_the_shard_of_the_load(olmo):
    """``load_numpy_params(mesh=)`` slices each numpy leaf before it becomes a
    tensor; ``init(mesh=)`` draws each leaf whole in the same order and keeps
    the shard: both equal sharding the whole tree."""
    model, raw = olmo
    np_tree = {k: v for k, v in _leaves(raw)}
    nested: dict = {}
    for path, t in np_tree.items():
        node = nested
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.numpy()
    for rank in range(4):
        mesh = Mesh({"data": 2, "model": 2}, rank=rank)
        want = dict(_leaves(partition.shard_params(raw, model.specs(), mesh)))
        loaded = dict(_leaves(model.load_numpy(nested, "cpu", mesh=mesh)))
        drawn = dict(_leaves(model.init(torch.Generator().manual_seed(0), mesh=mesh)))
        for path, t in want.items():
            assert torch.equal(loaded[path], t) and torch.equal(drawn[path], t), path


def test_int8_bank_shards_keep_their_channel_scales(olmo):
    """Sharding a whole int8 bank slices each payload and its keepdims
    per-channel scale together: a column shard takes its channels' scales,
    a row (K) shard keeps them all."""
    model, raw = olmo
    whole = prepare_params(raw, PrecisionPolicy.accurate(FXP8), "int8", specs=model.specs())
    mesh = Mesh({"data": 1, "model": 2}, rank=1)
    placed = partition.shard_params(whole, model.specs(), mesh)
    wq, wo = whole["seg0_dense"]["attn"]["wq"], whole["seg0_dense"]["attn"]["wo"]
    pq, po = placed["seg0_dense"]["attn"]["wq"], placed["seg0_dense"]["attn"]["wo"]
    h = wq.shape[2] // 2
    assert torch.equal(pq.data, wq.data[:, :, h:]) and torch.equal(pq.scale, wq.scale[:, :, h:])
    assert torch.equal(po.data, wo.data[:, h:]) and torch.equal(po.scale, wo.scale)
