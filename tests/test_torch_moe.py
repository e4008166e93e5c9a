"""PyTorch port: the token-choice MoE (``models/blocks.moe_ffn``) against the
reference, single device, prepared kernel mode.

* The routing choice (``top_k_stable``) and the dispatch plan
  (``_dispatch_indices``) are bitwise the reference's, ties included: both
  break ties toward the lower index, as ``lax.top_k`` and the stable
  ``argsort`` do.
* ``moe_ffn``'s output agrees to f32 reduction-order tolerance (the router
  and expert einsums sum in another order), dropless at s <= 64 and with a
  small capacity factor that drops tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config, reduced as ref_reduced  # noqa: E402
from repro.core import EngineContext as JCtx, PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.backends import prepare_params as jax_prepare  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import EngineContext, PrecisionPolicy  # noqa: E402
from repro_torch.core.backends import prepare_params  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.params import load_numpy_params  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

OUT_TOL = dict(rtol=1e-4, atol=1e-4)


def _plan_equal(rows, e, c):
    """The port's batched plan of ``rows`` (B, S, K) equals the reference's
    per-row plan, row by row."""
    got = blocks._dispatch_indices(torch.from_numpy(rows), e, c)
    for r in range(rows.shape[0]):
        want = jax_blocks._dispatch_indices(jnp.asarray(rows[r]), e, c)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[r].numpy(), np.asarray(w))
            assert g.dtype in (torch.bool, torch.int32)


@pytest.mark.parametrize("capacity", [1, 2, 3, 6])
def test_dispatch_indices_bitwise_on_tied_choices(capacity):
    # six tokens, top-2, most of them piling onto experts 1 and 3
    idx = np.array([[1, 3], [3, 1], [1, 0], [3, 2], [1, 3], [2, 1]], np.int32)
    _plan_equal(np.stack([idx, idx[::-1].copy()]), 4, capacity)


def test_dispatch_indices_bitwise_random_rows():
    rng = np.random.default_rng(3)
    for s, k, e, c in [(17, 2, 4, 5), (64, 8, 16, 20), (3, 3, 8, 8)]:
        idx = np.stack([rng.choice(e, k, replace=False) for _ in range(s)]).astype(np.int32)
        _plan_equal(idx[None], e, c)


def test_top_k_breaks_ties_like_lax_top_k():
    probs = np.array([[[0.25, 0.25, 0.1, 0.25, 0.15]], [[0.2, 0.2, 0.2, 0.2, 0.2]]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = blocks.top_k_stable(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.fixture(scope="module")
def moe_layer():
    """One reduced deepseek-v3 MoE block (4 experts, top-2, a shared
    expert), N(0, 0.1^2) weights, prepared in kernel mode by both packages."""
    jcfg = ref_reduced(ref_get_config("deepseek-v3-671b"), layers=4)
    cfg = reduced(get_config("deepseek-v3-671b"), layers=4)
    rng = np.random.default_rng(0)
    specs = {"moe": blocks.moe_specs(cfg)}

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        return (rng.standard_normal(tree.shape) * 0.1).astype(np.float32)

    np_params = draw(specs)
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32)
    jparams = jax_prepare(jax.tree.map(jnp.asarray, np_params), jctx.policy, "kernel",
                          specs={"moe": jax_blocks.moe_specs(jcfg)})["moe"]
    tparams = prepare_params(load_numpy_params(np_params, "cpu", specs=specs),
                             PrecisionPolicy.accurate(), "kernel", specs=specs)["moe"]
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32)
    return jcfg, cfg, jctx, ctx, jparams, tparams


def _routing(x, router, k):
    """Both packages' routing choice from the same inputs."""
    jl = jnp.einsum("bsd,de->bse", jnp.asarray(x), jnp.asarray(router))
    _, want = jax.lax.top_k(jax.nn.softmax(jl, axis=-1), k)
    tl = torch.einsum("bsd,de->bse", torch.from_numpy(x), torch.from_numpy(router))
    _, got = blocks.top_k_stable(torch.softmax(tl, dim=-1), k)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("case", ["dropless_decode", "dropless_block", "dropping"])
def test_moe_ffn_matches_reference(moe_layer, case):
    jcfg, cfg, jctx, ctx, jparams, tparams = moe_layer
    b, s, dropless, factor = {"dropless_decode": (4, 1, True, 1.25),
                              "dropless_block": (2, 9, True, 1.25),
                              "dropping": (2, 24, False, 0.5)}[case]
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=factor))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
    x = np.random.default_rng(s).standard_normal((b, s, cfg.d_model)).astype(np.float32)

    want, jaux = jax_blocks.moe_ffn(jparams, jnp.asarray(x), jcfg, jctx, name="layer.moe",
                                    dropless=dropless)
    with torch.no_grad():
        got, aux = blocks.moe_ffn(tparams, torch.from_numpy(x), cfg, ctx, name="layer.moe",
                                  dropless=dropless)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    np.testing.assert_allclose(aux["lb_loss"].numpy(), np.asarray(jaux["lb_loss"]), rtol=1e-5)

    router = np.array(jparams["router"])
    top_got, top_want = _routing(x, router, cfg.moe.top_k)
    np.testing.assert_array_equal(top_got, top_want)
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    capacity = max(k, int(np.ceil(s * k / e * factor)))
    if dropless:
        capacity = max(capacity, s)
    rank = blocks._dispatch_indices(torch.from_numpy(top_got), e, capacity)[2]
    assert bool((rank >= capacity).any()) == (case == "dropping")
