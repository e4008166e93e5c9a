"""The serving jobs of the tensor-parallel tests: each builds a
``BatchedServer`` of the port, on a mesh or without one, and serves the
reference's request fixture. The spawned ranks (``launch.mesh.spawn``)
import this module by name, so it imports no JAX; the tests run the same
jobs in-process for the port's ``mesh=None`` side."""
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


def ctx_of(mode: str, fxp16: bool = False) -> EngineContext:
    policy = None if mode == "exact" else PrecisionPolicy.accurate(FXP16 if fxp16 else FXP8)
    return EngineContext(mode=mode, policy=policy, compute_dtype=torch.float32,
                         attn_impl="decode_kernel")


def _flat_ids(tree) -> list:
    from repro_torch.core.backends import PreparedWeight

    if isinstance(tree, dict):
        return [i for v in tree.values() for i in _flat_ids(v)]
    return [id(tree)] if isinstance(tree, PreparedWeight) else []


def serve(job: dict, mesh=None) -> dict:
    """One job: ``arch`` (reduced), ``mode``, ``params`` (the reference's raw
    numpy tree), optional ``temperature``, ``max_new``, ``max_len``,
    ``bank`` ("pinned" or "spec": a carmen FxP16 ladder pinned at accurate,
    or greedy speculation with draft_len 3), ``fxp16``. Returns the streams,
    margins and, on a mesh, the placement and collective record."""
    model = get_model(reduced(get_config(job["arch"])))
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
    server = BatchedServer(model, ctx, params, slots=4, max_len=job.get("max_len", 32),
                           burst=4, device="cpu", mesh=mesh, **kw)
    reqs = requests(model.cfg.vocab_size, max_new=job.get("max_new", 6),
                    temperature=job.get("temperature", 0.0))
    out = {"streams": server.run(reqs), "margins": [r.margins for r in reqs]}
    if server.spec_telemetry is not None:
        out["rounds"] = server.spec_telemetry.summary()["rounds"]
    if mesh is not None and job.get("record"):
        out["collectives"] = server.collective_snapshot()
        out["report"] = json.loads(json.dumps(server.shardings.snapshot()))
        out["cache_shapes"] = {k: tuple(v.shape) for k, v in server.cache["seg0_dense"].items()}
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


def smoke_rank(rank: int, world: int, root: str, sizes: dict, job: dict):
    """A spawned rank of the rehearsed tp phase (``chip_smoke.tp_serve`` on
    the CPU, plain versions counting)."""
    import sys

    sys.path.insert(0, root)
    import chip_smoke

    count_plain_launches(chip_smoke, sizes)
    return chip_smoke.tp_serve(job["cfg"], mesh_from_shape(job["mesh"]), "cpu",
                               job.get("forward"), job.get("max_new"))
