"""PyTorch port: the Mamba2 / SSD mixer (``models/mamba2.py``) against the
reference's ``repro.models.mamba2``, on the CPU.

``ssd_chunked`` at one chunk (S = 32) and two (S = 64), with one and two
B/C groups, against the reference to f32 reduction-order tolerance
(``SSD_RTOL`` of the output's largest magnitude: torch's and XLA's einsums,
cumsum and exp round differently by a few ulps). The full-sequence
``mamba2_forward`` and the decode step in kernel mode on prepared FxP8
weights (reduced mamba2-780m, seeded numpy weights): the decode step's state
is held to f32 tolerance and its output to ``LOGIT_TOL``; the full-sequence
output passes the fused dot's FxP8 quantizer after the SSD's ulps, so an ulp
that lands on a rounding boundary moves one ``out_proj`` input by a grid step
(``assert_close_up_to_flips``). Also the reference's refusal of a sequence
length that is not a multiple of the chunk, and ``softplus`` above 20, where
``torch.nn.functional.softplus`` would return x itself.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config, reduced as ref_reduced  # noqa: E402
from repro.core import EngineContext as JCtx, PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.backends import prepare_params as jax_prepare  # noqa: E402
from repro.models import get_model as ref_get_model, mamba2 as ref_mamba2  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import EngineContext, PrecisionPolicy  # noqa: E402
from repro_torch.core.backends import prepare_params  # noqa: E402
from repro_torch.models import get_model, mamba2  # noqa: E402
from repro_torch.models.transformer import layer_view  # noqa: E402

SSD_RTOL = 1e-5
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module on one intra-op thread, and restore the count after it.
    Its tensors are small: in a test run of several worker processes, each
    worker's pool of one OpenMP/MKL thread a core oversubscribes the cores
    and slows every worker several times over. Modules that import it get
    it too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def numpy_params(specs, seed=0):
    """Seeded numpy weights for a reference spec tree: the embedding
    0.02 x N(0, 1), leaves initialised to ones (norm scales, the mixer's
    ``norm`` and ``D``) 1 + 0.1 x N(0, 1), every other leaf 0.1 x N(0, 1)
    (the conv bias, ``A_log`` and ``dt_bias`` too, so that no term is
    silent)."""
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if isinstance(spec, dict):
            return {k: make(path + (k,), v) for k, v in spec.items()}
        noise = rng.standard_normal(spec.shape)
        if path[0] == "embed":
            return (noise * 0.02).astype(np.float32)
        if spec.init == "ones":
            return (1.0 + noise * 0.1).astype(np.float32)
        return (noise * 0.1).astype(np.float32)

    return make((), specs)


def build(name, d_model=128):
    """Both models of an arch reduced to ``d_model`` (the same rule on both
    sides), the numpy weights, each package's raw and prepared trees (the
    reference's prepared under ``jax.jit``) and kernel-mode contexts."""
    ref_cfg = ref_reduced(ref_get_config(name), d_model=d_model)
    cfg = reduced(get_config(name), d_model=d_model)
    ref_model, model = ref_get_model(ref_cfg), get_model(cfg)
    np_params = numpy_params(ref_model.specs())
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32,
                attn_impl="decode_kernel")
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl="decode_kernel")
    jraw = jax.tree.map(jnp.asarray, np_params)
    raw = model.load_numpy(np_params, "cpu")
    return dict(name=name, ref_model=ref_model, model=model, jctx=jctx, ctx=ctx, jraw=jraw,
                raw=raw, np_params=np_params,
                jprepared=jax.jit(lambda p: jax_prepare(p, jctx.policy, "kernel",
                                                        specs=ref_model.specs()))(jraw),
                prepared=prepare_params(raw, ctx.policy, "kernel", specs=model.specs()))


def assert_close_up_to_flips(got, want, *, tol=LOGIT_TOL, flip_atol, max_flip_share,
                             argmax=False):
    """``got`` within ``tol`` of ``want`` along every row (the last axis),
    except rows where an FxP8 rounding flipped: those within ``flip_atol``,
    and at most ``max_flip_share`` of the rows. Two implementations whose
    f32 glue differs by reduction-order ulps quantize a value on a rounding
    boundary to neighbouring grid points; that moves the values downstream
    of it by one grid step's effect, not more. With ``argmax`` (logits): the
    argmax is the reference's on every row within ``tol``, and on a flipped
    row the reference's logit at the port's argmax is within ``flip_atol``
    of its maximum (a near-tie that the flip tipped)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    beyond = (diff > tol["atol"] + tol["rtol"] * np.abs(want)).any(axis=-1)
    assert diff.max() <= flip_atol, diff.max()
    assert beyond.mean() <= max_flip_share, (beyond.sum(), beyond.size)
    if argmax:
        pick = got.argmax(-1)
        np.testing.assert_array_equal(pick[~beyond], want.argmax(-1)[~beyond])
        at_pick = np.take_along_axis(want, pick[..., None], -1)[..., 0]
        assert (want.max(-1) - at_pick <= flip_atol).all()


@pytest.fixture(scope="module")
def mamba():
    return build("mamba2-780m")


def _ssd_inputs(l, g, seed):
    rng = np.random.default_rng(seed)
    b, h, p, n = 2, 8, 16, 16
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("l", [32, 64], ids=["one_chunk", "two_chunks"])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_matches_reference(l, g):
    args = _ssd_inputs(l, g, seed=l + g)
    want_y, want_state = ref_mamba2.ssd_chunked(*map(jnp.asarray, args), 32)
    got_y, got_state = mamba2.ssd_chunked(*map(torch.from_numpy, args), 32)
    for got, want in ((got_y, want_y), (got_state, want_state)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= SSD_RTOL * np.abs(want).max()


def test_ssd_chunked_refuses_a_ragged_length():
    """The reference asserts ``l % chunk == 0``; the port raises at the same
    inputs (a forward at S = 300 with chunk 256 fails there)."""
    args = _ssd_inputs(40, 1, seed=0)
    with pytest.raises(AssertionError):
        ref_mamba2.ssd_chunked(*map(jnp.asarray, args), 32)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        mamba2.ssd_chunked(*map(torch.from_numpy, args), 32)


def test_forward_refuses_what_the_reference_refuses(mamba):
    """A full-sequence pass over S > chunk that is not a multiple of it."""
    cfg = mamba["model"].cfg
    x = np.random.default_rng(0).standard_normal((1, 40, cfg.d_model)).astype(np.float32)
    p = layer_view(mamba["prepared"]["seg0_mamba"], 0)["mixer"]
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        mamba2.mamba2_forward(p, torch.from_numpy(x), cfg, mamba["ctx"], name="layer.mixer")


def test_softplus_and_silu_are_the_references():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` at every x; above 20 (the
    torch builtin's threshold, past which it returns x) the port's equals
    the reference's bit for bit."""
    x = np.concatenate([np.linspace(-40, 40, 801), np.linspace(20, 30, 333), [88.0]]).astype(
        np.float32)
    got = mamba2.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    # within a few ulps: torch's and XLA's exp and log1p round differently
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)
    above = x > 20
    np.testing.assert_array_equal(got[above], want[above])
    np.testing.assert_allclose(mamba2.silu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.silu(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("l", [32, 64], ids=["one_chunk", "two_chunks"])
def test_full_sequence_mixer_matches_reference(mamba, l):
    """Layer 0's mixer on seeded inputs, prepared FxP8 in/out projections:
    the output within ``LOGIT_TOL`` (up to out_proj rounding flips) and the
    final SSM state and conv window for a following decode step."""
    cfg = mamba["model"].cfg
    x = np.random.default_rng(l).standard_normal((2, l, cfg.d_model)).astype(np.float32)
    pj = jax.tree.map(lambda a: a[0], mamba["jprepared"]["seg0_mamba"]["mixer"])
    pt = layer_view(mamba["prepared"]["seg0_mamba"], 0)["mixer"]
    want, want_state = ref_mamba2.mamba2_forward(pj, jnp.asarray(x), mamba["ref_model"].cfg,
                                                 mamba["jctx"], name="layer.mixer")
    with torch.no_grad():
        got, state = mamba2.mamba2_forward(pt, torch.from_numpy(x), cfg, mamba["ctx"],
                                           name="layer.mixer")
    # one flipped out_proj input moves an output by 2^-6 x |w| <= 2^-6 x 0.5
    assert_close_up_to_flips(got.numpy(), want, flip_atol=2.0**-6 * 0.5, max_flip_share=0.02)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(state[key].numpy(), np.asarray(want_state[key]), **STATE_TOL)


def test_decode_step_matches_reference(mamba):
    """Four single-token steps from a zero state, the state carried: each
    step's output and the updated conv window and SSM state (written in
    place) against the reference's."""
    cfg = mamba["model"].cfg
    pj = jax.tree.map(lambda a: a[1], mamba["jprepared"]["seg0_mamba"]["mixer"])
    pt = layer_view(mamba["prepared"]["seg0_mamba"], 1)["mixer"]
    jstate = ref_mamba2.init_mamba_state(mamba["ref_model"].cfg, 2, jnp.float32)
    state = mamba2.init_mamba_state(cfg, 2)
    conv_buf, ssm_buf = state["conv"], state["ssm"]
    rng = np.random.default_rng(7)
    for _ in range(4):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jstate = ref_mamba2.mamba2_forward(pj, jnp.asarray(x), mamba["ref_model"].cfg,
                                                 mamba["jctx"], name="layer.mixer",
                                                 state=jstate)
        with torch.no_grad():
            got, state = mamba2.mamba2_forward(pt, torch.from_numpy(x), cfg, mamba["ctx"],
                                               name="layer.mixer", state=state)
        assert state["conv"] is conv_buf and state["ssm"] is ssm_buf  # in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(state[key].numpy(), np.asarray(jstate[key]), **STATE_TOL)


def test_specs_and_state_shapes_match_reference():
    """Stock widths: the mixer's parameter shapes (in_proj 1536 x 6448) and
    the decode state's."""
    cfg, ref_cfg = get_config("mamba2-780m"), ref_get_config("mamba2-780m")
    specs, ref_specs = mamba2.mamba2_specs(cfg), ref_mamba2.mamba2_specs(ref_cfg)
    assert {k: s.shape for k, s in specs.items()} == {k: s.shape for k, s in ref_specs.items()}
    assert specs["in_proj"].shape == (1536, 6448)
    state = mamba2.init_mamba_state(cfg, 3, device="meta")
    ref_state = ref_mamba2.mamba_state_specs(ref_cfg, 3)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: v.shape for k, v in ref_state.items()}
