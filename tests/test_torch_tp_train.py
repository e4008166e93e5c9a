"""PyTorch port: training on a (data, model) mesh (``train/train_loop.py``
on ``ctx.mesh``, the ZeRO-sharded AdamW state, the differentiable
collectives of ``sharding/collectives.py``, ``checkpoint.save/restore(
shardings=)``, ``launch/train.py --mesh``) on spawned ``gloo`` ranks, one
torch thread each, at the reduced configs and shapes of
``test_torch_train.py`` (``SEQ`` 16, ``BATCH`` 4, ``OCFG``).

The reference's step is one program under GSPMD on any mesh (its own
meshed tests cannot run in this container), so a meshed step of the port
is held against two unmeshed ones on the same numpy weights and batch: the
port's ``mesh=None`` step and the reference's (``test_torch_train.
_ref_step``), for reduced olmo-1b (dense, tied embeddings) and
deepseek-v3 (MLA, a dense prefix and an MoE layer with a shared expert), in
exact, carmen, carmen16 and int8, on (1, 2), (2, 1) and (2, 2). The
tolerances are ``test_torch_train``'s, against both: the loss within 1e-5
relative (``FLIP``: carmen at FxP8 on olmo-1b 1e-4), the gradient norm
within ten times the gradient tolerance, each gradient within
``GRAD_TOL[mode]`` (``FLIP``: 2e-2) of its leaf's largest, each updated
parameter within ``2 lr`` (Adam's first step can flip its sign where the
gradient is as small as its error) and within 1e-6 where the gradient is
settled (ten times its tolerance above 1e-6); against the port's
``mesh=None`` step also the moments (``m`` within the gradient tolerance
of its largest, ``v`` within twice that). The meshes move the f32 sums: a
row-parallel product sums f32 partials over ``model``, the data ranks'
losses and gradients are summed, and carmen16's FxP16 grid turns such an
ulp on a rounding boundary into a flipped activation (measured: 3.8e-6 in
the loss and 1.2e-4 in a gradient on olmo-1b at (1, 2)). Where the
forward's sums are int32 (int8 at data extent 1: (1, 2)) the loss is
bitwise the port's ``mesh=None`` loss, and that is pinned; the gradients
are not (the entry ops sum the ranks' partial gradients in f32).

Also: a test that fails without the model's entry ops (the embedding's and
a norm weight's gradient at (1, 2)); the int8 mode's whole-K maxima tied
across ranks (the gradient split as ``jnp.max`` splits it); the MoE's
load-balancing loss over data shards (the global batch's); ``microbatches
= 2`` on (2, 1); remat bitwise on (2, 2); a checkpoint written on (2, 2)
restored bitwise on (1, 2), on ``mesh=None`` and in the reference; a
restart on (1, 2) bitwise the uninterrupted run; two int8 steps on (1, 2),
each from the run's own state, against two on ``mesh=None``; the CLI's ``--mesh``
(trains, checkpoints, resumes; equals the unmeshed CLI) and its
``--production-mesh`` refusal. The spawns: one of 4 ranks for (2, 2), then
one of 2 ranks for (1, 2) and (2, 1) (its restore reads the (2, 2)
checkpoint), each running all of its jobs (``_tp_ranks.train_jobs``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.backends import int8 as jint8  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.train import checkpoint, optimizer as opt  # noqa: E402
from repro_torch.train._tree import tree_leaves  # noqa: E402

import _tp_ranks  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401
from test_torch_train import BATCH, FLIP, GRAD_TOL, MODES, OCFG, SEQ, Arch, _ref_step  # noqa: E402

ARCHS = ("olmo-1b", "deepseek-v3-671b")
SHAPES = ((1, 2), (2, 1), (2, 2))
REMAT = (("olmo-1b", "exact"), ("olmo-1b", "int8"), ("deepseek-v3-671b", "carmen"))
RESTART_STEPS, RESTART_MORE = 2, 2
INT8_STEPS = 2


def _batches(arch, n=1):
    return [{k: v.numpy() for k, v in arch.batches(i)[1].items()} for i in range(n)]


def _job(arch, name, mode, **kw):
    return dict(arch=name, mode=mode, params=arch.np_params, batches=_batches(arch), **kw)


def _names(tree, prefix=""):
    """Leaf paths in flatten order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _int8_case():
    """x (5, 32) and w (32, 12), K split 16 | 16 over a model axis of 2:
    row 1's maximum tied across the halves, row 2's three times (twice in
    the first half), column 2's maximum tied across the halves, row 3 all
    zeros (its scale at the 1e-8 floor)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    w = rng.standard_normal((32, 12)).astype(np.float32)
    x[1, 3], x[1, 20] = -(np.abs(x[1]).max() + 1), np.abs(x[1]).max() + 1
    x[2, 1] = x[2, 5] = x[2, 25] = np.abs(x[2]).max() + 1
    w[4, 2] = w[20, 2] = np.abs(w[:, 2]).max() + 1
    x[3] = 0.0
    return x, w, rng.standard_normal((5, 12)).astype(np.float32)


@pytest.fixture(scope="module")
def archs():
    return {a: Arch(a) for a in ARCHS}


@pytest.fixture(scope="module")
def runs(archs, tmp_path_factory):
    """Every meshed job's result by label: the (2, 2) spawn first, then the
    (1, 2) and (2, 1) one. A ``step`` job's value is every rank's result
    (rank 0 with the whole trees)."""
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt") / "c22")
    four, two = [], []
    for name in ARCHS:
        for mode in MODES:
            for shape in SHAPES:
                (four if shape == (2, 2) else two).append(
                    ((name, mode, shape), _job(archs[name], name, mode, kind="step",
                                               mesh=shape)))
    ds = archs["deepseek-v3-671b"]
    for name, mode in REMAT:
        four.append((("remat", name, mode),
                     _job(archs[name], name, mode, kind="remat", mesh=(2, 2))))
    four.append(("save", _job(ds, "deepseek-v3-671b", "exact", kind="save", mesh=(2, 2),
                              steps=1, dir=ckpt)))
    two += [
        ("no entries", _job(ds, "deepseek-v3-671b", "exact", kind="step", mesh=(1, 2),
                            drop_entries=True)),
        ("restore", _job(ds, "deepseek-v3-671b", "exact", kind="restore", mesh=(1, 2),
                         steps=1, dir=ckpt)),
        ("lb_loss", _job(ds, "deepseek-v3-671b", "exact", kind="lb_loss", mesh=(2, 1))),
        ("microbatches", _job(ds, "deepseek-v3-671b", "exact", kind="step", mesh=(2, 1),
                              microbatches=2)),
        ("microbatches olmo", _job(archs["olmo-1b"], "olmo-1b", "exact", kind="step",
                                   mesh=(2, 1), microbatches=2)),
        ("ties", dict(zip(("x", "w", "g"), _int8_case()), kind="int8_ties", mesh=(1, 2))),
    ]
    olmo = archs["olmo-1b"]
    for name in ARCHS:
        job = _job(archs[name], name, "int8", kind="steps", mesh=(1, 2), steps=INT8_STEPS)
        job["batches"] = _batches(archs[name], INT8_STEPS)
        two.append((("int8 steps", name), job))
    restart = _job(olmo, "olmo-1b", "exact", kind="restart", mesh=(1, 2), steps=RESTART_STEPS,
                   more=RESTART_MORE, dir=str(tmp_path_factory.mktemp("tp_restart")))
    restart["batches"] = _batches(olmo, RESTART_STEPS + RESTART_MORE)
    two.append(("restart", restart))
    out = {"ckpt": ckpt}
    for world, jobs in ((4, four), (2, two)):
        per_rank = spawn(_tp_ranks.train_jobs, world, args=([j for _, j in jobs],),
                         timeout=600)
        for i, (label, _) in enumerate(jobs):
            out[label] = [ranks[i] for ranks in per_rank]
    return out


def _close(got, want, tol, lr, *, moments=None):
    """``got`` (a job's rank-0 result) against ``want`` (loss, grad_norm,
    grads, params as numpy) to the module's tolerances."""
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=tol["loss"])
    assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]),
                                                    rel=10 * tol["grad"])
    for g, jg, p, jp in zip(got["grads"], want["grads"], got["params"], want["params"]):
        if jg is None or g is None:  # torch's missing gradient is JAX's zeros
            assert g is None and (jg is None or not jg.any())
            g = jg = np.zeros(p.shape, np.float32)
        scale = max(np.abs(jg).max(), 1e-30)
        assert np.abs(g - jg).max() <= tol["grad"] * scale
        diff = np.abs(p - jp)
        assert diff.max() <= 2 * lr + 1e-6
        settled = np.abs(jg) > max(1e-6, 10 * tol["grad"] * scale)
        assert diff[settled].max(initial=0) <= 1e-6
    if moments is not None:
        n = len(got["params"])
        step, m, v = got["state"][0], got["state"][1:1 + n], got["state"][1 + n:]
        assert step == moments[0] == 1
        for a, b, k in [(a, b, 1) for a, b in zip(m, moments[1:1 + n])] + \
                [(a, b, 2) for a, b in zip(v, moments[1 + n:])]:
            assert np.abs(a - b).max() <= k * tol["grad"] * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ARCHS)
def test_meshed_step_matches_mesh_none_and_reference(archs, runs, name, mode):
    """One train step on (1, 2), (2, 1) and (2, 2): every rank's loss and
    gradient norm, and the gradients, updated parameters and moments
    gathered whole, against the port's ``mesh=None`` step and the
    reference's step (module docstring)."""
    arch = archs[name]
    base = _tp_ranks.train_step(_job(arch, name, mode))
    jloss, jgrads, jnew, _, jmet = _ref_step(arch, mode)
    ref = dict(loss=jloss, grad_norm=jmet["grad_norm"], params=jax.tree.leaves(jnew),
               grads=[np.asarray(g) for g in jax.tree.leaves(jgrads)])
    ref["params"] = [np.asarray(p) for p in ref["params"]]
    tol = FLIP.get((name, mode), dict(loss=1e-5, grad=GRAD_TOL[mode]))
    lr = float(jmet["lr"])
    for shape in SHAPES:
        reps = runs[(name, mode, shape)]
        full = reps[0]
        for rep in reps:  # every rank reports the global loss and norm
            assert rep["loss"] == full["loss"] and rep["grad_norm"] == full["grad_norm"]
        _close(full, base, tol, lr, moments=base["state"])
        _close(full, ref, tol, lr)
        if mode == "int8" and shape[0] == 1:  # int32 sums: the forward is bitwise
            assert np.array_equal(full["loss"], base["loss"]), (name, shape)


def test_entry_ops_carry_the_residual_gradient(archs, runs):
    """At (1, 2) the gradient of deepseek-v3's embedding and of its first
    layer's attention-norm weight (both whole on every model rank, both
    upstream of every column-parallel product) equal the ``mesh=None``
    ones to 1e-5 of their largest. Without the model's entry ops
    (``collectives.enter_model`` made the identity) the forward is the
    same, bit for bit, and those gradients are wrong: each rank sums only
    its own heads', columns' and experts' part."""
    name = "deepseek-v3-671b"
    arch = archs[name]
    base = _tp_ranks.train_step(_job(arch, name, "exact"))
    names = _names(arch.params())
    good, bad = runs[(name, "exact", (1, 2))][0], runs["no entries"][0]
    assert np.array_equal(good["loss"], bad["loss"])
    for leaf in ("embed", "seg0_dense_prefix/attn_norm/scale"):
        i = names.index(leaf)
        want = base["grads"][i]
        scale = np.abs(want).max()
        assert np.abs(good["grads"][i] - want).max() <= 1e-5 * scale, leaf
        assert np.abs(bad["grads"][i] - want).max() > 1e-2 * scale, leaf


def test_int8_amax_gradient_splits_ties_across_ranks(runs):
    """The int8 mode's row-parallel dot at (1, 2), K split over the model
    axis, with maxima tied across the ranks' halves (and a three-way tie,
    two in one half): the output equals the reference's ``int8_dot`` over
    the whole K bitwise, and the gradients its ``jax.grad`` (the whole-K
    maximum's gradient split evenly among the tied elements, wherever they
    lie; a per-rank split would give the three-way tie 1/4, 1/4, 1/2)."""
    x, w, g = _int8_case()
    rep = runs["ties"][0]
    assert np.array_equal(rep["out"], np.asarray(jint8.int8_dot(x, w)))
    jx, jw = jax.grad(lambda a, b: jnp.sum(jint8.int8_dot(a, b) * g), (0, 1))(x, w)
    for got, want in ((rep["dx"], np.asarray(jx)), (rep["dw"], np.asarray(jw))):
        assert np.array_equal(got != 0, want != 0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.count_nonzero(rep["dx"][1]) == 2 and np.count_nonzero(rep["dx"][2]) == 3
    np.testing.assert_allclose(rep["dx"][2, [1, 5, 25]], rep["dx"][2, 1], rtol=1e-6)


def test_lb_loss_on_data_shards_is_the_global_batch(archs, runs):
    """deepseek-v3's load-balancing loss at (2, 1), each data rank holding
    half of the rows: with the statistics summed over ``data`` it is the
    ``mesh=None`` forward's over the whole batch on every rank (1e-6
    relative); from a rank's own rows it is another value."""
    from repro_torch.launch.train import engine_ctx

    arch = archs["deepseek-v3-671b"]
    _, batch = arch.batches()
    with torch.no_grad():
        _, aux = arch.model.forward(arch.params(), batch, engine_ctx("exact"))
    want = float(aux["lb_loss"])
    for rep in runs["lb_loss"]:
        assert float(rep["global"]) == pytest.approx(want, rel=1e-6)
        assert abs(float(rep["local"]) - want) > 1e-4 * want


def test_microbatches_on_a_mesh(archs, runs):
    """``microbatches=2`` on (2, 1), where a rank's rows of microbatch i are
    the data shard of that microbatch: olmo-1b's step equals the full-batch
    step to ``test_microbatches_match_full_batch``'s tolerances (loss 1e-4
    relative, parameters 2e-5); deepseek-v3's, whose load-balancing loss is
    a product of each microbatch's statistics (so it tells which rows form
    a microbatch), equals the ``mesh=None`` step with 2 microbatches to the
    module's tolerances."""
    olmo, ds = archs["olmo-1b"], archs["deepseek-v3-671b"]
    got = runs["microbatches olmo"][0]
    one = _tp_ranks.train_step(_job(olmo, "olmo-1b", "exact"))
    np.testing.assert_allclose(float(got["loss"]), float(one["loss"]), rtol=1e-4)
    for a, b in zip(got["params"], one["params"]):
        np.testing.assert_allclose(a, b, atol=2e-5)
    two = _tp_ranks.train_step(_job(ds, "deepseek-v3-671b", "exact", microbatches=2))
    _close(runs["microbatches"][0], two, dict(loss=1e-5, grad=GRAD_TOL["exact"]),
           OCFG["lr"] / OCFG["warmup_steps"], moments=two["state"])


@pytest.mark.parametrize("name,mode", REMAT)
def test_remat_on_a_mesh_is_bitwise(runs, name, mode):
    """Remat on (2, 2), which recomputes each layer's collectives in the
    backward, is bitwise remat off on every rank: loss, gradient norm,
    parameters and moments."""
    for rep in runs[("remat", name, mode)]:
        assert rep == {"loss": True, "grad_norm": True, "trees": True}


def test_checkpoint_written_on_2x2_restores_bitwise(archs, runs):
    """deepseek-v3's parameters and moments after a step on (2, 2), saved
    with ``shardings=`` (rank 0 writes whole leaves): restored with
    ``shardings=`` on (1, 2), on ``mesh=None`` (the port) and by the
    reference's ``restore``, every leaf bitwise the (2, 2) trainer's."""
    arch = archs["deepseek-v3-671b"]
    saved, back = runs["save"][0], runs["restore"][0]
    assert back["step"] == 1
    for key in ("params", "state"):
        assert all(np.array_equal(a, b) for a, b in zip(saved[key], back[key]))
    d = runs["ckpt"]
    params = checkpoint.restore(d, 1, arch.params())
    state = checkpoint.restore(d + "/opt", 1, opt.init_state(params))
    got = [t.numpy() for t in tree_leaves(params)] + [t.numpy() for t in tree_leaves(state)]
    assert all(np.array_equal(a, b) for a, b in zip(got, saved["params"] + saved["state"]))
    jp = arch.jparams()
    jparams = jckpt.restore(d, 1, jp)
    jstate = jckpt.restore(d + "/opt", 1, jopt.init_state(jp))
    ref = [np.asarray(a) for a in jax.tree.leaves(jparams) + jax.tree.leaves(jstate)]
    assert all(np.array_equal(a, b) for a, b in zip(ref, saved["params"] + saved["state"]))


def test_meshed_restart_is_bitwise(runs):
    """olmo-1b on (1, 2): a checkpoint after 2 steps, restored with
    ``shardings=`` into a fresh trainer, gives the next 2 steps' losses and
    parameters bitwise the uninterrupted run's, on both ranks."""
    for rep in runs["restart"]:
        assert rep["losses_bitwise"] and rep["params_bitwise"]
        assert all(np.isfinite(rep["losses"]))


@pytest.mark.parametrize("name", ARCHS)
def test_meshed_int8_steps_from_their_own_state_match_mesh_none(archs, runs, name):
    """Two int8 steps on (1, 2), the second from the meshed first step's
    state, against two steps on ``mesh=None``: the first loss bitwise (int32
    sums), the second within the loss tolerance, every parameter within
    ``2 lr`` a step of mesh=None's."""
    job = _job(archs[name], name, "int8", kind="steps", steps=INT8_STEPS)
    job["batches"] = _batches(archs[name], INT8_STEPS)
    base = _tp_ranks.run_steps(job, None)
    for rep in runs[("int8 steps", name)]:
        assert np.array_equal(rep["losses"][0], base["losses"][0])
        assert float(rep["losses"][1]) == pytest.approx(float(base["losses"][1]), rel=1e-5)
    for p, q in zip(runs[("int8 steps", name)][0]["params"], base["params"]):
        assert np.abs(p - q).max() <= 2 * OCFG["lr"] * INT8_STEPS + 1e-6


def test_train_cli_on_a_mesh(tmp_path, capfd):
    """``launch/train.py --mesh 1,2 --dist-backend gloo``: two spawned ranks
    train, checkpoint and resume (rank 0 prints); the losses are the
    unmeshed CLI's to 1e-5. ``--production-mesh`` in a group of 2 ranks
    is refused, naming the 256 ranks its mesh needs."""
    args = ["--arch", "olmo-1b", "--reduced", "--batch", str(BATCH), "--seq", str(SEQ),
            "--device", "cpu", "--ckpt-every", "2"]
    mesh = ["--mesh", "1,2", "--dist-backend", "gloo"]
    losses = train_cli.main(args + mesh + ["--ckpt-dir", str(tmp_path / "m"), "--steps", "4"])
    plain = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "p"), "--steps", "4"])
    np.testing.assert_allclose(losses, plain, rtol=1e-5)
    assert checkpoint.latest_step(str(tmp_path / "m")) == 4
    again = train_cli.main(args + mesh + ["--ckpt-dir", str(tmp_path / "m"), "--steps", "6",
                                          "--resume"])
    out = capfd.readouterr().out
    assert out.count("resumed from step 4") == 1 and "done: 2 steps" in out
    assert len(again) == 2 and np.isfinite(again).all()
    with pytest.raises(RuntimeError, match="needs 256 ranks; the process group has 2"):
        train_cli.main(["--reduced", "--device", "cpu", "--production-mesh"] + mesh)


@pytest.mark.parametrize("name", ARCHS)
def test_zero_state_is_the_parameter_shards(archs, name):
    """ZeRO on (2, 2), for every rank: ``init_state`` on the rank's
    parameter shards (``model.init(mesh=)``) gives ``m`` and ``v`` of the
    shards' shapes, ``abstract_state(shardings=)`` of the whole abstract
    tree the same shapes, and the step whole. The placement reads only the
    mesh's shape and the rank's coordinates, so no process group is made."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.partition import local_shape, train_shardings
    from repro_torch.train._tree import leaves_with_specs

    model = archs[name].model
    for rank in range(4):
        mesh = Mesh({"data": 2, "model": 2}, rank=rank)
        sh = train_shardings(model.serving_specs(), mesh)
        params = model.init(torch.Generator().manual_seed(0), mesh=mesh)
        state = opt.init_state(params)
        meta = opt.abstract_state(model.abstract_params(), sh)
        whole = leaves_with_specs(model.abstract_params(), sh.specs)
        want = [local_shape(p.shape, spec, mesh) for p, spec in whole]
        for tree in (state.m, state.v, meta.m, meta.v, params):
            assert [tuple(t.shape) for t in tree_leaves(tree)] == want
        assert tuple(state.step.shape) == tuple(meta.step.shape) == ()
        assert any(w != tuple(p.shape) for w, (p, _) in zip(want, whole))
