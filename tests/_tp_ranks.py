"""The jobs of the tensor-parallel tests: serving jobs build a
``BatchedServer`` of the port, on a mesh or without one, and serve the
reference's request fixture; training jobs (``train_jobs``) run train
steps, remat pairs, checkpoints and restarts on a mesh and return what
they make gathered whole. The spawned ranks (``launch.mesh.spawn``) import
this module by name, so it imports no JAX; the tests run the same jobs
in-process for the port's ``mesh=None`` side."""
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import FXP8, FXP16, EngineContext, PrecisionPolicy
from repro_torch.launch.mesh import mesh_from_shape
from repro_torch.models import get_model
from repro_torch.serve import BatchedServer, Request


def requests(vocab: int, n: int = 4, *, max_new: int = 6, temperature: float = 0.0):
    """The reference's ``tests/test_sharded_serving._requests``: prompts of
    3 + i tokens from rng seed 0, seed 10 + i."""
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(0, vocab, 3 + i).astype(np.int32), max_new,
                    temperature=temperature, seed=10 + i) for i in range(n)]


def config_of(job: dict):
    """The job's reduced ``arch``, with ``kv_heads`` kv heads if given."""
    cfg = reduced(get_config(job["arch"]))
    if "kv_heads" in job:
        cfg = dataclasses.replace(cfg, num_kv_heads=job["kv_heads"])
    return cfg


def ctx_of(mode: str, fxp16: bool = False) -> EngineContext:
    policy = None if mode == "exact" else PrecisionPolicy.accurate(FXP16 if fxp16 else FXP8)
    return EngineContext(mode=mode, policy=policy, compute_dtype=torch.float32,
                         attn_impl="decode_kernel")


def _flat_ids(tree) -> list:
    from repro_torch.core.backends import PreparedWeight

    if isinstance(tree, dict):
        return [i for v in tree.values() for i in _flat_ids(v)]
    return [id(tree)] if isinstance(tree, PreparedWeight) else []


def _leaf_shapes(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaf_shapes(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tuple(tree.shape)}


def serve(job: dict, mesh=None) -> dict:
    """One job: ``arch`` (reduced), ``mode``, ``params`` (the reference's raw
    numpy tree), optional ``temperature``, ``max_new``, ``max_len``,
    ``bank`` ("pinned" or "spec": a ``mode`` FxP16 ladder pinned at
    accurate, or greedy speculation with draft_len 3), ``fxp16``,
    ``per_call`` (serve the raw weights), ``repeat`` (serve the requests
    again on a second server: its streams are ``again``), ``kv_heads``
    (``config_of``). Returns the streams, margins and, on a mesh, the
    placement and collective record."""
    model = get_model(config_of(job))
    params = model.load_numpy(job["params"], "cpu")
    ctx = ctx_of(job["mode"], job.get("fxp16", False))
    kw = {}
    bank = None
    if job.get("bank"):
        from repro_torch.runtime import ControllerConfig, ModeController, build_bank
        from repro_torch.runtime.bank import default_points

        bank = build_bank(params, job["mode"], default_points(FXP16, hifi_fmt=None),
                          specs=model.specs(), mesh=mesh)
        if job["bank"] == "pinned":
            kw["controller"] = ModeController(bank, ControllerConfig(pin="accurate"))
        else:
            from repro_torch.spec import SpecConfig

            kw.update(bank=bank, speculate=SpecConfig(draft_len=3))
    def make():
        return BatchedServer(model, ctx, params, slots=4, max_len=job.get("max_len", 32),
                             burst=4, device="cpu", mesh=mesh,
                             prepare_weights=not job.get("per_call"), **kw)

    def reqs():
        return requests(model.cfg.vocab_size, max_new=job.get("max_new", 6),
                        temperature=job.get("temperature", 0.0))

    server, run = make(), reqs()
    out = {"streams": server.run(run), "margins": [r.margins for r in run],
           "prefill_steps": server.prefill_steps}
    if job.get("repeat"):
        out["again"] = make().run(reqs())
    if server.spec_telemetry is not None:
        out["rounds"] = server.spec_telemetry.summary()["rounds"]
    if mesh is not None and job.get("record"):
        out["collectives"] = server.collective_snapshot()
        out["report"] = json.loads(json.dumps(server.shardings.snapshot()))
        out["cache_leaves"] = _leaf_shapes(server.cache)
        if "seg0_dense" in server.cache:
            out["cache_shapes"] = {k: tuple(v.shape)
                                   for k, v in server.cache["seg0_dense"].items()}
        out["state_shapes"] = {k: tuple(v.shape) for k, v in server._state.items()}
        out["local_slots"] = server._local_slots
    if bank is not None and mesh is not None:
        ids = [set(_flat_ids(bank.tree(n))) for n in bank.names]
        out["shared_leaves"] = (len(set.intersection(*ids)), bank.shared_leaves)
    return out


def run_jobs(rank: int, world: int, shape, jobs):
    """A spawned rank: the jobs, in order, on one ``shape`` mesh."""
    mesh = mesh_from_shape(shape)
    return [serve(job, mesh) for job in jobs]



def fail_one(rank: int, world: int):
    """Rank 1 raises at once; rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))
    return rank


def count_plain_launches(smoke, sizes: dict):
    """Rehearse ``chip_smoke``'s tp accounting on the CPU: every kernel
    wrapper's plain version counts the launch its wrapper would make (by
    the wrapper's own plan), the card-only calls become no-ops, and the
    smoke's sizes shrink to ``sizes``. Returns the function that undoes it
    all."""
    from repro_torch import kernels
    from repro_torch.kernels.cordic_af import ops as af_ops
    from repro_torch.kernels.cordic_fused import ops as fused_ops
    from repro_torch.kernels.cordic_mac import ops as mac_ops
    from repro_torch.kernels.decode_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.int_dot import PATH_NAMES, plan

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    for name, value in sizes.items():
        patch(smoke, name, value)
    patch(smoke, "nvidia_smi", lambda: "cpu")
    for fn in ("reset_peak_memory_stats", "synchronize", "empty_cache"):
        patch(torch.cuda, fn, lambda *a: None)
    patch(torch.cuda, "max_memory_allocated", lambda *a: 0)

    def dot_path(x, w):
        m = x.reshape(-1, x.shape[-1]).shape[0]
        return PATH_NAMES[plan(m, w.shape[1], w.shape[0], w.element_size(),
                               w.element_size()).path]

    def counted(module, ref_name, wrapper, inst):
        ref = getattr(module, ref_name)

        def run(*a, **kw):
            kernels.count_launch(wrapper, inst(*a))
            return ref(*a, **kw)

        patch(module, ref_name, run)

    counted(fused_ops, "fused_dot_af_ref", fused_ops.fused_dot_af, lambda x, w, p: dot_path(x, w))
    counted(fused_ops, "fused_dot_partial_ref", fused_ops.fused_dot_partial,
            lambda x, w, p: dot_path(x, w))
    counted(fused_ops, "fused_epilogue_ref", fused_ops.fused_epilogue, lambda *a: "elementwise")
    counted(mac_ops, "mac_matmul_ref", mac_ops.mac_matmul, lambda x, w, *a: dot_path(x, w))
    counted(mac_ops, "mac_matmul_partial_ref", mac_ops.mac_matmul_partial,
            lambda x, w: dot_path(x, w))
    counted(mac_ops, "mac_epilogue_ref", mac_ops.mac_epilogue, lambda *a: "elementwise")
    counted(attn_ops, "gqa_decode_attention_ref", attn_ops.gqa_decode_attention,
            lambda q, *a: "tc" if q.shape[1] >= attn_ops.TC_MIN_S else "split")
    counted(attn_ops, "mla_decode_attention_ref", attn_ops.mla_decode_attention,
            lambda *a: "tc")
    counted(flash_ops, "flash_attention_ref", flash_ops.flash_attention, lambda *a: "tc")
    counted(af_ops, "multi_af_ref", af_ops.multi_af, lambda *a: "elementwise")

    def undo():
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
        kernels.reset_launch_counts()

    return undo


def reduced_olmo(layers=None):
    """``chip_smoke.olmo`` for the CPU rehearsals: reduced olmo-1b."""
    return reduced(get_config("olmo-1b"), layers=layers or 2)


def smoke_train_rank(rank: int, world: int, root: str, sizes: dict, runs, ckpt_dir: str):
    """A spawned rank of the rehearsed train_tp phase
    (``chip_smoke.train_tp_rank`` on the CPU, plain versions counting)."""
    import sys

    sys.path.insert(0, root)
    import chip_smoke

    count_plain_launches(chip_smoke, sizes)
    return chip_smoke.train_tp_rank(rank, world, runs, ckpt_dir, device="cpu")


def smoke_rank(rank: int, world: int, root: str, sizes: dict, job: dict):
    """A spawned rank of the rehearsed tp phase (``chip_smoke.tp_serve`` on
    the CPU, plain versions counting)."""
    import sys

    sys.path.insert(0, root)
    import chip_smoke

    count_plain_launches(chip_smoke, sizes)
    kw = {k: job[k] for k in ("lens", "mode", "per_call") if k in job}
    return chip_smoke.tp_serve(job["cfg"], mesh_from_shape(job["mesh"]), "cpu",
                               job.get("forward"), job.get("max_new"), **kw)


# ---------------------------------------------------------------------------
# training on a mesh (tests/test_torch_tp_train.py)
# ---------------------------------------------------------------------------

OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)  # test_torch_train.OCFG


def train_parts(job: dict, mesh=None):
    """The model, the rank's parameters (the job's numpy tree, sharded on a
    mesh), the engine context and the train config of a training job:
    ``arch`` (reduced), ``mode``, ``params``, optional ``remat``,
    ``microbatches``, ``kv_heads``."""
    from repro_torch.launch.train import engine_ctx
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import TrainConfig

    model = get_model(config_of(job))
    params = model.load_numpy(job["params"], "cpu", mesh=mesh)
    ctx = dataclasses.replace(engine_ctx(job["mode"]), mesh=mesh)
    tcfg = TrainConfig(optimizer=opt.AdamWConfig(**OCFG), remat=job.get("remat", False),
                       microbatches=job.get("microbatches", 1))
    return model, params, ctx, tcfg


def _numpy(t):
    return None if t is None else t.detach().numpy().copy()


def whole(tree, shardings):
    """A tree (of this rank's shards on ``shardings``' mesh) as whole numpy
    leaves in flatten order, None for a missing gradient. Every rank of the
    mesh must call it."""
    from repro_torch.sharding.partition import gather_tensor
    from repro_torch.train._tree import leaves_with_specs, tree_leaves

    if shardings is None:
        return [_numpy(t) for t in tree_leaves(tree)]
    return [None if t is None else _numpy(gather_tensor(t, spec, shardings.mesh))
            for t, spec in leaves_with_specs(tree, shardings.specs)]


def _batch(job, step: int = 0):
    return {k: torch.from_numpy(v) for k, v in job["batches"][step].items()}


def _drop_entries(which: str = "all"):
    """Every model module's ``enter_model`` made the plain identity (its
    gradient no longer summed over the model axis), or, ``which="kv"``,
    only where whole K and V (4-d) enter a rank's q heads in
    ``blocks.attention``; returns the undo."""
    from repro_torch.models import blocks, encdec, mamba2, mla, transformer

    mods = (blocks, encdec, mamba2, mla, transformer) if which == "all" else (blocks,)
    saved = [m.enter_model for m in mods]
    for m, f in zip(mods, saved):
        m.enter_model = ((lambda t, mesh: t) if which == "all" else
                         (lambda t, mesh, f=f: t if t.ndim == 4 else f(t, mesh)))

    def undo():
        for m, f in zip(mods, saved):
            m.enter_model = f

    return undo


def train_step(job: dict, mesh=None) -> dict:
    """One train step of a job on its first global batch (``batches[0]``,
    numpy ``tokens``, ``targets``): the loss, the gradient norm and,
    gathered whole, the gradients (``make_grad_fn``), the updated parameters
    and the moments (``apply_updates`` on those gradients: the train step).
    ``drop_entries``: without the model's entry ops (``"kv"``: without
    K's and V's)."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train._tree import leaves_like
    from repro_torch.train.train_loop import make_grad_fn

    drop = job.get("drop_entries")
    undo = _drop_entries("kv" if drop == "kv" else "all") if drop else None
    try:
        model, params, ctx, tcfg = train_parts(job, mesh)
        grads_of, sh = make_grad_fn(model, ctx, tcfg)
        loss, _, grads = grads_of(params, _batch(job))
        new, state, met = opt.apply_updates(params, grads, opt.init_state(params),
                                            tcfg.optimizer, sh)
    finally:
        if undo is not None:
            undo()
    out = {"loss": _numpy(loss), "grad_norm": _numpy(met["grad_norm"]),
           "params": whole(new, sh),
           "state": whole(state, opt.state_shardings(sh) if sh is not None else None)}
    out["grads"] = whole(grads, sh) if sh is not None else \
        [_numpy(g) for g in leaves_like(params, grads)]
    return out


def steps(job: dict, mesh, start: int, stop: int, params=None, state=None):
    """Train steps ``start..stop-1`` of a job through ``make_train_step``
    (from the job's weights and fresh moments unless given): the params,
    the state, the losses, the placement."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import make_train_step

    model, fresh, ctx, tcfg = train_parts(job, mesh)
    params = fresh if params is None else params
    state = opt.init_state(params) if state is None else state
    step_fn = make_train_step(model, ctx, tcfg)
    losses = []
    for i in range(start, stop):
        params, state, met = step_fn(params, state, _batch(job, i))
        losses.append(_numpy(met["loss"]))
    sh = None
    if mesh is not None:
        from repro_torch.sharding.partition import train_shardings

        sh = train_shardings(model.serving_specs(), mesh)
    return params, state, losses, sh


def run_steps(job: dict, mesh) -> dict:
    """``job["steps"]`` train steps on ``mesh`` (``None``: unmeshed), each
    from the run's own state: the losses and the parameters gathered whole."""
    params, _, losses, sh = steps(job, mesh, 0, job["steps"])
    return {"losses": losses, "params": whole(params, sh)}


def remat_pair(job: dict, mesh) -> dict:
    """One train step with remat off and on, on ``mesh``: whether the loss,
    the gradient norm, the parameters and the moments are bitwise equal."""
    import dataclasses

    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import make_train_step

    outs = []
    for remat in (False, True):
        model, params, ctx, tcfg = train_parts(job, mesh)
        tcfg = dataclasses.replace(tcfg, remat=remat)
        outs.append(make_train_step(model, ctx, tcfg)(params, opt.init_state(params),
                                                     _batch(job)))
    (p0, s0, m0), (p1, s1, m1) = outs
    from repro_torch.train._tree import tree_leaves

    same = [torch.equal(a, b) for a, b in zip(tree_leaves((p0, s0)), tree_leaves((p1, s1)))]
    return {"loss": torch.equal(m0["loss"], m1["loss"]),
            "grad_norm": torch.equal(m0["grad_norm"], m1["grad_norm"]), "trees": all(same)}


def save_after(job: dict, mesh) -> dict:
    """``job["steps"]`` train steps on ``mesh``, then the params and moments
    saved with ``shardings=`` under ``job["dir"]`` (``/opt`` for the
    moments); returns them gathered whole."""
    from repro_torch.train import checkpoint, optimizer as opt

    n = job["steps"]
    params, state, _, sh = steps(job, mesh, 0, n)
    checkpoint.save(job["dir"], n, params, shardings=sh)
    checkpoint.save(job["dir"] + "/opt", n, state, background=True,
                    shardings=opt.state_shardings(sh))
    return {"params": whole(params, sh), "state": whole(state, opt.state_shardings(sh))}


def restore_on(job: dict, mesh) -> dict:
    """The checkpoint of ``job["dir"]`` at step ``job["steps"]`` restored
    with ``shardings=`` on ``mesh``; returns it gathered whole."""
    from repro_torch.train import checkpoint, optimizer as opt

    model, like, _, _ = train_parts(job, mesh)
    from repro_torch.sharding.partition import train_shardings

    sh = train_shardings(model.serving_specs(), mesh)
    n = job["steps"]
    params = checkpoint.restore(job["dir"], n, like, shardings=sh)
    state = checkpoint.restore(job["dir"] + "/opt", n, opt.init_state(like),
                               shardings=opt.state_shardings(sh))
    return {"params": whole(params, sh), "state": whole(state, opt.state_shardings(sh)),
            "step": int(state.step)}


def restart(job: dict, mesh) -> dict:
    """``job["steps"]`` steps, a checkpoint, ``job["more"]`` steps on; then a
    fresh trainer restored from the checkpoint with ``shardings=`` runs the
    same steps: whether its losses and parameters are bitwise the
    uninterrupted run's."""
    from repro_torch.train import checkpoint, optimizer as opt
    from repro_torch.train._tree import tree_leaves

    n, more = job["steps"], job["more"]
    params, state, _, sh = steps(job, mesh, 0, n)
    checkpoint.save(job["dir"], n, params, shardings=sh)
    checkpoint.save(job["dir"] + "/opt", n, state, shardings=opt.state_shardings(sh))
    direct, _, losses, _ = steps(job, mesh, n, n + more, params, state)
    _, like, _, _ = train_parts(job, mesh)
    p = checkpoint.restore(job["dir"], n, like, shardings=sh)
    s = checkpoint.restore(job["dir"] + "/opt", n, opt.init_state(like),
                           shardings=opt.state_shardings(sh))
    again, _, losses2, _ = steps(job, mesh, n, n + more, p, s)
    return {"losses": [float(v) for v in losses],
            "losses_bitwise": all(np.array_equal(a, b) for a, b in zip(losses, losses2)),
            "params_bitwise": all(torch.equal(a, b) for a, b in
                                  zip(tree_leaves(direct), tree_leaves(again)))}


def lb_loss(job: dict, mesh) -> dict:
    """The MoE's load-balancing loss of a cache-free forward over this data
    rank's rows of the job's global batch, on ``mesh`` as the train step
    runs it (``batch_shards``) and over the rank's rows alone."""
    import dataclasses

    from repro_torch.sharding.partition import train_shardings
    from repro_torch.train.train_loop import _rows

    model, params, ctx, _ = train_parts(job, mesh)
    sh = train_shardings(model.serving_specs(), mesh)
    ctx = dataclasses.replace(ctx, param_specs=sh.specs)
    batch = {k: _rows(v, 1, 0, mesh) for k, v in _batch(job).items()}
    with torch.no_grad():
        _, aux = model.forward(params, batch, dataclasses.replace(
            ctx, batch_shards=mesh.size("data")))
        _, local = model.forward(params, batch, ctx)
    return {"global": _numpy(aux["lb_loss"]), "local": _numpy(local["lb_loss"])}


def int8_ties(job: dict, mesh) -> dict:
    """The int8 mode's row-parallel dot of ``x`` (M, K) by ``w`` (K, N), K
    split over the model axis, and its gradients, gathered whole."""
    from repro_torch.core import EngineContext, FXP8, PrecisionPolicy
    from repro_torch.sharding.partition import gather_tensor

    ctx = EngineContext(mode="int8", policy=PrecisionPolicy.accurate(FXP8),
                        compute_dtype=torch.float32, mesh=mesh)
    x, w = job["x"], job["w"]
    k = x.shape[1] // mesh.size("model")
    k0 = mesh.coord("model") * k
    xs = torch.tensor(x[:, k0:k0 + k], requires_grad=True)
    ws = torch.tensor(w[k0:k0 + k], requires_grad=True)
    out = ctx.linear(xs, ws, k_sharded=True)
    (out * torch.from_numpy(job["g"])).sum().backward()
    return {"out": _numpy(out), "dx": _numpy(gather_tensor(xs.grad, (None, "model"), mesh)),
            "dw": _numpy(gather_tensor(ws.grad, ("model",), mesh))}


def forward(job: dict, mesh=None) -> dict:
    """The cache-free ``forward`` logits of the job's ``tokens`` (numpy) in
    its ``mode`` (prepared outside exact) with ``attn`` (``"flash"`` or
    ``"xla"``), on ``mesh``'s shards of the job's weights."""
    from repro_torch.core import prepare_params
    from repro_torch.sharding.partition import prepared_shardings, shard_params

    model = get_model(config_of(job))
    params = model.load_numpy(job["params"], "cpu")
    ctx = dataclasses.replace(ctx_of(job["mode"]), attn_impl=job["attn"])
    if mesh is not None:
        params = shard_params(params, model.serving_specs(), mesh)
    if job["mode"] != "exact":
        params = prepare_params(params, ctx.policy, job["mode"], specs=model.specs())
    if mesh is not None:
        ctx = dataclasses.replace(ctx, mesh=mesh, param_specs=prepared_shardings(
            params, model.serving_specs(), mesh))
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": torch.from_numpy(job["tokens"])}, ctx)
    return {"logits": _numpy(logits)}


TRAIN_KINDS = {"step": train_step, "steps": run_steps, "remat": remat_pair, "save": save_after,
               "restore": restore_on, "restart": restart, "lb_loss": lb_loss,
               "int8_ties": int8_ties, "serve": serve, "forward": forward}


def train_jobs(rank: int, world: int, jobs):
    """A spawned rank: each training job (``kind``, ``mesh``: its shape over
    this spawn's ranks) in order; returns their results."""
    meshes = {}
    out = []
    for job in jobs:
        shape = tuple(job["mesh"])
        if shape not in meshes:
            meshes[shape] = mesh_from_shape(shape)
        rep = TRAIN_KINDS[job["kind"]](job, meshes[shape])
        if rank:  # the whole trees come back from rank 0 alone
            rep = {k: v for k, v in rep.items() if k not in ("grads", "params", "state")}
        out.append(rep)
    return out
