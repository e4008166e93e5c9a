"""End-to-end training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
        --steps 50 --batch 8 --seq 64 --mode exact --ckpt-dir /tmp/ckpt --device cpu

Trains on the card by default (``--device cuda``); ``--device cpu`` runs
the kernels' plain versions. Every flag of the reference: the deterministic
synthetic pipeline (``data/pipeline.TokenPipeline``), the engine modes
(``exact``; ``carmen`` and ``carmen16``, the straight-through QAT product
at FxP8 and FxP16; ``int8``, the MAC-array kernel), gradient accumulation
over ``--microbatches``, a warm-up of 10 steps then cosine decay of
``--lr``, activation checkpointing (``remat``) unless ``--reduced``, and
checkpoint/restart (``--ckpt-dir``, ``--ckpt-every``, ``--resume``; the
reference's layout, so either package resumes the other's run).

Weights are the port's own random init (``models/params.init``, seed 0),
in f32 at every size: the port runs its full-width models in f32, as it
serves them.

Training on a mesh, as the reference trains on its devices: in a process
group the mesh is ``make_host_mesh()`` over its ranks, and
``--production-mesh`` the 16x16 (data, model) mesh, which needs 256 ranks
(another group size is refused). ``--mesh DATA,MODEL --dist-backend
gloo|nccl`` starts DATA x MODEL ranks itself (``launch.mesh.spawn``, as
``launch/serve.py --mesh``): gloo for ranks that share a card or run on
the CPU, nccl for one card a rank. Each rank holds its shards of the
parameters and of the AdamW moments (``partition.train_shardings``) and
runs the train step on its rows of the global batch
(``train/train_loop.py``); rank 0 prints and writes the checkpoints, which
hold whole leaves in the reference's layout, and ``--resume`` restores
them with ``shardings=`` (on any mesh, or none).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
        --device cpu --mesh 1,2 --dist-backend gloo --steps 6 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import time

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS, get_config, reduced as reduce_cfg
from repro_torch.core import FXP8, FXP16, EngineContext, PrecisionPolicy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, mesh_from_shape
from repro_torch.models import get_model
from repro_torch.sharding import partition
from repro_torch.train import checkpoint, optimizer as opt
from repro_torch.train.train_loop import TrainConfig, make_train_step

MODES = ("exact", "carmen", "carmen16", "int8")


def engine_ctx(mode: str) -> EngineContext:
    """The f32 engine context of a ``--mode``: ``carmen16`` is carmen at
    FxP16, the others at the accurate FxP8 policy (``exact``: none)."""
    if mode == "exact":
        return EngineContext(mode="exact", compute_dtype=torch.float32)
    fmt = FXP16 if mode.endswith("16") else FXP8
    return EngineContext(mode=mode.replace("16", ""), policy=PrecisionPolicy.accurate(fmt),
                         compute_dtype=torch.float32)


PRODUCTION_RANKS = 256  # the 16 x 16 (data, model) mesh


def _mesh_rank(rank: int, world: int, argv, shape):
    """One rank of ``--mesh``: this CLI on the rank's mesh; only rank 0
    prints."""
    mesh = mesh_from_shape(shape)
    out = contextlib.nullcontext() if rank == 0 else contextlib.redirect_stdout(io.StringIO())
    with out:
        return main(argv, mesh=mesh)


def _launch_mesh(args, argv):
    """Spawn the ranks of ``--mesh`` and return rank 0's losses."""
    from repro_torch.launch.mesh import parse_mesh, spawn

    if args.dist_backend is None:
        raise SystemExit("--mesh needs --dist-backend gloo|nccl: gloo for ranks that share a "
                         "card or run on the CPU, nccl for one card a rank")
    on_card = args.device is None or args.device.startswith("cuda")
    shape = parse_mesh(args.mesh, world=torch.cuda.device_count() if on_card else 1)
    if on_card:
        resolve_device(args.device)
        device = "cuda" if args.dist_backend == "nccl" else "cuda:0"
    else:
        device = "cpu"
    return spawn(_mesh_rank, shape[0] * shape[1], args=(argv, shape),
                 backend=args.dist_backend, device=device, timeout=24 * 3600)[0]


def _mesh(args, mesh):
    """The run's mesh: ``mesh`` (a ``--mesh`` rank's), the production mesh,
    or the host mesh over an initialized process group; None on one
    process."""
    if args.production_mesh:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != PRODUCTION_RANKS:
            raise SystemExit(f"--production-mesh builds the 16x16 (data, model) mesh, which "
                             f"needs {PRODUCTION_RANKS} ranks; the process group has {world} "
                             "(use --mesh DATA,MODEL for another shape)")
        return make_production_mesh()
    if mesh is None and dist.is_initialized():
        return make_host_mesh()
    return mesh


def main(argv=None, mesh=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="olmo-1b")
    ap.add_argument("--reduced", action="store_true", help="small-config run")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mode", choices=MODES, default="exact")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help=f"train on the 16x16 (data, model) mesh ({PRODUCTION_RANKS} ranks)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL|auto",
                    help="spawn DATA x MODEL ranks and train on their mesh (auto: one rank a "
                         "card); needs --dist-backend")
    ap.add_argument("--dist-backend", choices=("gloo", "nccl"), default=None,
                    help="the ranks' torch.distributed backend (with --mesh)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.mesh is not None and mesh is None:
        return _launch_mesh(args, argv)
    mesh = _mesh(args, mesh)
    device = resolve_device(args.device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(args.arch)
    cfg = reduce_cfg(cfg) if args.reduced else dataclasses.replace(cfg, dtype="float32")
    model = get_model(cfg)
    ctx = dataclasses.replace(engine_ctx(args.mode), mesh=mesh)
    tcfg = TrainConfig(
        optimizer=opt.AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps),
        microbatches=args.microbatches,
        remat=not args.reduced,
    )
    pipe = TokenPipeline(cfg, args.seq, args.batch, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0), torch.float32, mesh=mesh)
    opt_state = opt.init_state(params)
    param_sh = state_sh = None
    if mesh is not None:
        param_sh = partition.train_shardings(model.serving_specs(), mesh)
        state_sh = opt.state_shardings(param_sh)
    start_step = 0
    if args.resume and args.ckpt_dir:
        latest = checkpoint.latest_step(args.ckpt_dir)
        if latest is not None:
            params = checkpoint.restore(args.ckpt_dir, latest, params, device=device,
                                        shardings=param_sh)
            opt_state = checkpoint.restore(args.ckpt_dir + "/opt", latest, opt_state,
                                           device=device, shardings=state_sh)
            start_step = latest
            print(f"resumed from step {latest}")

    step_fn = make_train_step(model, ctx, tcfg)
    writers = []
    t0, losses = time.time(), []
    for step in range(start_step, args.steps):
        batch = pipe.batch(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            writers.append(checkpoint.save(args.ckpt_dir, step + 1, params, background=True,
                                           shardings=param_sh))
            checkpoint.save(args.ckpt_dir + "/opt", step + 1, opt_state, shardings=state_sh)
    for w in writers:
        if w is not None:
            w.join()
    dt = time.time() - t0
    done = args.steps - start_step
    tok_s = args.batch * args.seq * done / max(dt, 1e-9)
    if losses:
        print(f"done: {done} steps in {dt:.1f}s ({tok_s:.0f} tok/s), "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
