"""PyTorch port: training on a (data, model) mesh for the families beyond
``test_torch_tp_train.py``'s olmo-1b and deepseek-v3, on spawned ``gloo``
ranks at the reduced configs and shapes of ``test_torch_train.py``.

* **mamba2-780m** (the Mamba2 mixer on a rank's heads: ``in_proj``'s
  gathered columns, the whole conv and gated norm, the row-parallel
  ``out_proj``) in exact, carmen, carmen16 and int8 on (1, 2), (2, 1) and
  (2, 2): the loss, gradient norm, gradients, updated parameters and
  moments against the port's ``mesh=None`` step and the reference's step,
  to ``test_torch_tp_train``'s tolerances (``test_torch_train``'s).
* **the other families** in exact mode on (2, 2), against the port's
  ``mesh=None`` step and the reference's step to the same tolerances:
  zamba2-7b (Mamba2 groups and the shared attention block), qwen3-8b
  (``q_norm``/``k_norm``: whole weights acting on a rank's heads),
  qwen2.5-14b (q/k/v biases), llama4-maverick (a dense/MoE pair),
  internvl2-2b (the vision stub's embeddings, split by rows over
  ``data``), yi-9b and seamless-m4t-large-v2 (encoder-decoder).
  seamless's gradients are held to 2e-2 of a leaf's largest: its decoder
  MLP is a ReLU, and a pre-activation within f32 ulps of 0, moved by the
  mesh's sums, flips its unit's gradient (measured: one of 1024 units of
  the first decoder layer, 1.2e-2); against the reference's step, the
  same bar as the others. Its steps, meshed and not, take the
  reference's stub frames (numpy): the reference's pipeline makes them with
  ``erfinv`` ulps apart from the port's, and the adaptive pooling's choice
  turns those into other encoder inputs (0.038 at 0.02 frames), so on each
  side's own frames the two steps could not be compared.

Two spawns, each running all of its jobs: 2 ranks for (1, 2) and (2, 1),
4 ranks for (2, 2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.launch.mesh import spawn  # noqa: E402

import _tp_ranks  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401
from test_torch_tp_train import SHAPES, _close, _job  # noqa: E402
from test_torch_train import GRAD_TOL, MODES, OCFG, Arch, _ref_step  # noqa: E402

OTHERS = ("zamba2-7b", "qwen3-8b", "qwen2.5-14b", "llama4-maverick-400b-a17b", "internvl2-2b",
          "yi-9b", "seamless-m4t-large-v2")
# seamless's ReLU MLP: a flipped unit (module docstring)
TOL = {"seamless-m4t-large-v2": dict(loss=1e-5, grad=2e-2)}
# the families whose steps take the reference's stub frames (module docstring)
REFERENCE_FRAMES = ("seamless-m4t-large-v2",)


@pytest.fixture(scope="module")
def archs():
    return {a: Arch(a) for a in ("mamba2-780m",) + OTHERS}


def _family_job(arch, name, **kw):
    """An exact step's job; seamless's batch is the reference's (numpy)."""
    job = _job(arch, name, "exact", **kw)
    if name in REFERENCE_FRAMES:
        jb, _ = arch.batches()
        job["batches"] = [{k: np.array(v) for k, v in jb.items()}]
    return job


@pytest.fixture(scope="module")
def runs(archs):
    """Every meshed step's rank results by (arch, mode, shape)."""
    two, four = [], []
    for mode in MODES:
        for shape in SHAPES:
            (four if shape == (2, 2) else two).append(
                (("mamba2-780m", mode, shape),
                 _job(archs["mamba2-780m"], "mamba2-780m", mode, kind="step", mesh=shape)))
    for name in OTHERS:
        four.append(((name, "exact", (2, 2)),
                     _family_job(archs[name], name, kind="step", mesh=(2, 2))))
    out = {}
    for world, jobs in ((2, two), (4, four)):
        per_rank = spawn(_tp_ranks.train_jobs, world, args=([j for _, j in jobs],), timeout=600)
        for i, (label, _) in enumerate(jobs):
            out[label] = [ranks[i] for ranks in per_rank]
    return out


def _check_ranks(reps):
    for rep in reps:  # every rank reports the global loss and norm
        assert rep["loss"] == reps[0]["loss"] and rep["grad_norm"] == reps[0]["grad_norm"]
    return reps[0]


@pytest.mark.parametrize("mode", MODES)
def test_mamba2_meshed_step_matches_mesh_none_and_reference(archs, runs, mode):
    """mamba2 on (1, 2), (2, 1) and (2, 2) against its ``mesh=None`` step and
    the reference's (module docstring)."""
    name = "mamba2-780m"
    arch = archs[name]
    base = _tp_ranks.train_step(_job(arch, name, mode))
    jloss, jgrads, jnew, _, jmet = _ref_step(arch, mode)
    ref = dict(loss=jloss, grad_norm=jmet["grad_norm"],
               grads=[np.asarray(g) for g in jax.tree.leaves(jgrads)],
               params=[np.asarray(p) for p in jax.tree.leaves(jnew)])
    tol = dict(loss=1e-5, grad=GRAD_TOL[mode])
    for shape in SHAPES:
        full = _check_ranks(runs[(name, mode, shape)])
        _close(full, base, tol, float(jmet["lr"]), moments=base["state"])
        _close(full, ref, tol, float(jmet["lr"]))


@pytest.mark.parametrize("name", OTHERS)
def test_family_meshed_step_matches_mesh_none(archs, runs, name):
    """One exact step on (2, 2) against the port's ``mesh=None`` step."""
    arch = archs[name]
    base = _tp_ranks.train_step(_family_job(arch, name))
    full = _check_ranks(runs[(name, "exact", (2, 2))])
    tol = TOL.get(name, dict(loss=1e-5, grad=GRAD_TOL["exact"]))
    _close(full, base, tol, OCFG["lr"] / OCFG["warmup_steps"], moments=base["state"])


@pytest.mark.parametrize("name", OTHERS)
def test_family_meshed_step_matches_reference(archs, runs, name):
    """The same exact step on (2, 2) against the reference's unmeshed step:
    the parity that counts, since the reference's step is mesh-agnostic."""
    jloss, jgrads, jnew, _, jmet = _ref_step(archs[name], "exact")
    ref = dict(loss=jloss, grad_norm=jmet["grad_norm"],
               grads=[np.asarray(g) for g in jax.tree.leaves(jgrads)],
               params=[np.asarray(p) for p in jax.tree.leaves(jnew)])
    full = _check_ranks(runs[(name, "exact", (2, 2))])
    _close(full, ref, dict(loss=1e-5, grad=GRAD_TOL["exact"]), float(jmet["lr"]))
