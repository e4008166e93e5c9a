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
serves them. ``--production-mesh`` needs the port's tensor parallel, which
is not ported yet, and raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS, get_config, reduced as reduce_cfg
from repro_torch.core import FXP8, FXP16, EngineContext, PrecisionPolicy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import get_model
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


def main(argv=None):
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
                    help="not ported yet (needs the port's tensor parallel)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise SystemExit("--production-mesh needs the port's tensor parallel "
                         "(sharding/partition.py, launch/mesh.py), which is not ported yet")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    cfg = reduce_cfg(cfg) if args.reduced else dataclasses.replace(cfg, dtype="float32")
    model = get_model(cfg)
    ctx = engine_ctx(args.mode)
    tcfg = TrainConfig(
        optimizer=opt.AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps),
        microbatches=args.microbatches,
        remat=not args.reduced,
    )
    pipe = TokenPipeline(cfg, args.seq, args.batch, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0), torch.float32)
    opt_state = opt.init_state(params)
    start_step = 0
    if args.resume and args.ckpt_dir:
        latest = checkpoint.latest_step(args.ckpt_dir)
        if latest is not None:
            params = checkpoint.restore(args.ckpt_dir, latest, params, device=device)
            opt_state = checkpoint.restore(args.ckpt_dir + "/opt", latest, opt_state,
                                           device=device)
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
            writers.append(checkpoint.save(args.ckpt_dir, step + 1, params, background=True))
            checkpoint.save(args.ckpt_dir + "/opt", step + 1, opt_state)
    for w in writers:
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
