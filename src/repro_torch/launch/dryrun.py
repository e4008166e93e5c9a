"""Dry run: one (arch x shape) cell's step on meta tensors, costed, for one
card (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k \\
        --mode kernel --prepared
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mode kernel

The reference lowers and compiles each cell on a fake 512-device mesh and
reads the compiled HLO. The port runs each cell's step eagerly on meta
tensors, which move no data and need no card, under the cost analyzer
(``launch/cost_analysis.py``), and records what it reads into
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__mode][__tag].json`` with
the reference's keys (``status``, ``flops_dev``, ``hbm_bytes_dev``,
``hbm_bytes_upper_dev``, ``coll_bytes_dev``, ``coll_by_kind``, ``memory``),
the port's ``ops_by_kind`` and ``kernels``, and ``fits_one_card``: the
arguments and the peak of the step's live bytes within one 80 GiB card. The
op trace goes beside it (``ops/<stem>.jsonl.gz``), which
``launch/reanalyze.py`` sums again.

A cell is the port's step at full width, in f32 (parameters, caches and
compute), as the port serves and trains every full-width model:

* train cells run ``train_loop.make_train_step`` with remat (one AdamW step
  on the abstract state);
* prefill cells run the cache-free ``forward`` (``--attn``: ``xla`` the
  plain chains, ``flash`` the flash kernels);
* decode cells run one token a row against a ``seq_len`` cache.

``--mode`` takes the reference's ``exact``, ``carmen`` and ``int8``, and
``kernel``: the only mode whose dots are the hand-written kernels; its
attention runs on the kernels too, whatever ``--attn`` says (the
cache-decode kernels at decode, as the port serves, and flash in prefill
cells). Kernel mode has no backward, so its train cells skip.
``--prepared`` runs ``prepare_params`` on meta for inference cells.
``--mesh`` takes only ``none``: a meshed dry run (and real collectives in
``topcolls``) is ROADMAP Queue 1; meshed serving runs (``serve --mesh``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import ALL_SHAPES, ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.core import FXP8, EngineContext, PrecisionPolicy, prepare_params
from repro_torch.data.pipeline import input_specs
from repro_torch.launch import cost_analysis
from repro_torch.models import get_model
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import TrainConfig, make_train_step

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                         "dryrun_torch")
MODES = ("exact", "carmen", "int8", "kernel")
MESHES = ("none",)
CARD_BYTES = 80 * 2**30  # one H100's device memory


def engine_ctx(mode: str, attn: str = "xla", decode: bool = False) -> EngineContext:
    """The f32 engine context of a cell: the reference's (accurate FxP8
    policy outside exact); kernel mode's attention on the kernels (the
    cache-decode kernels at decode, flash otherwise)."""
    if mode == "kernel":
        attn = "decode_kernel" if decode else "flash"
    if mode == "exact":
        return EngineContext(mode="exact", attn_impl=attn, compute_dtype=torch.float32)
    return EngineContext(mode=mode, policy=PrecisionPolicy.accurate(FXP8), attn_impl=attn,
                         compute_dtype=torch.float32)


def build_cell(arch: str, shape_name: str, mode: str = "exact", attn: str = "xla",
               microbatches: int = 1, prepared: bool = False):
    """``(step_fn, args)`` of a cell, every tensor on the meta device."""
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    shape = SHAPES[shape_name]
    model = get_model(cfg)
    ctx = engine_ctx(mode, attn, decode=shape.is_decode)
    params = model.abstract_params(torch.float32)
    if prepared and mode != "exact" and shape.kind != "train":
        params = prepare_params(params, ctx.policy, mode, specs=model.specs())
    batch = input_specs(cfg, shape)

    if shape.kind == "train":
        step = make_train_step(model, ctx, TrainConfig(remat=True, microbatches=microbatches))
        return step, (params, opt.abstract_state(params), batch)

    if shape.kind == "prefill":
        def prefill(params, batch):
            logits, _ = model.forward(params, batch, ctx)
            return logits
        return prefill, (params, batch)

    # decode: one token against a seq_len cache
    cache = model.make_cache(shape.global_batch, shape.seq_len, torch.float32, device="meta")

    def decode(params, tokens, cache):
        return model.decode_step(params, tokens, cache, ctx)

    return decode, (params, batch["tokens"], cache)


def stem(rec: Dict) -> str:
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    mode = f"__{rec['mode']}" if rec.get("mode", "exact") != "exact" else ""
    return f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{mode}{tag}"


def record_costs(rec: Dict, costs: cost_analysis.Costs) -> Dict:
    """The cost keys of a record, from an analyzer's :class:`Costs`."""
    rec.update(
        flops_dev=costs.dot_flops,
        hbm_bytes_dev=costs.hbm_bytes,
        hbm_bytes_upper_dev=costs.hbm_bytes_upper,
        coll_bytes_dev=costs.collective_bytes,
        coll_by_kind={k: float(v) for k, v in costs.collective_by_kind.items()},
        ops_by_kind=dict(costs.ops_by_kind),
        kernels=dict(costs.kernels),
    )
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str = "none", mode: str = "exact",
             out_dir: Optional[str] = None, tag: str = "", attn: str = "xla",
             microbatches: int = 1, prepared: bool = False) -> Dict:
    if mesh_kind not in MESHES:
        raise ValueError(f"mesh {mesh_kind!r} waits for a meshed dry run (ROADMAP Queue 1: "
                         f"dryrun --mesh, real collectives in topcolls); --mesh takes {MESHES}")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if prepared and not tag:
        tag = "prepared"
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "mode": mode, "tag": tag,
                 "prepared": prepared, "attn": attn, "dtype": "float32"}
    if ok and mode == "kernel" and shape.kind == "train":
        ok, why = False, "kernel mode has no backward (QAT trains in carmen or int8 mode)"
    if not ok:
        rec.update(status="skip", reason=why)
        return _emit(rec, out_dir)

    t0 = time.time()
    try:
        step, args = build_cell(arch, shape_name, mode, attn=attn, microbatches=microbatches,
                                prepared=prepared)
        an, _ = cost_analysis.analyze(step, *args)
        del step, args
        t_run = time.time() - t0
        costs = an.costs()
        out_dir = out_dir or ARTIFACTS
        ops_dir = os.path.join(out_dir, "ops")
        os.makedirs(ops_dir, exist_ok=True)
        mem = an.memory()
        rec.update(status="ok", trace_s=round(t_run, 1), memory=mem, ops=len(an.records),
                   fits_one_card=mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                   <= CARD_BYTES)
        record_costs(rec, costs)
        cost_analysis.save_trace(os.path.join(ops_dir, stem(rec) + ".jsonl.gz"), an.records,
                                 header=dict(cell=stem(rec), memory=mem))
        print(f"[ok] {arch} x {shape_name} ({mode}{'/' + tag if tag else ''}): {t_run:.0f}s "
              f"flops {costs.dot_flops:.3e} hbm {costs.hbm_bytes / 1e9:.2f} GB "
              f"fits one card: {rec['fits_one_card']}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep the sweep going
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[FAIL] {arch} x {shape_name}: {type(e).__name__}: {e}")
    return _emit(rec, out_dir)


def _emit(rec: Dict, out_dir: Optional[str]) -> Dict:
    out_dir = out_dir or ARTIFACTS
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, stem(rec) + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=[s.name for s in ALL_SHAPES], default=None)
    ap.add_argument("--mesh", default="none",
                    help=f"{MESHES}: a meshed dry run is ROADMAP Queue 1")
    ap.add_argument("--mode", choices=MODES, default="exact")
    ap.add_argument("--tag", default="", help="artifact suffix for perf experiments")
    ap.add_argument("--attn", choices=["xla", "flash"], default="xla")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation microbatches inside train_step")
    ap.add_argument("--prepared", action="store_true",
                    help="inference cells on prepared weight banks (prepare_params; "
                         "ignored for train shapes and exact mode)")
    ap.add_argument("--all", action="store_true", help="sweep every cell")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.mesh not in MESHES:
        ap.error(f"--mesh {args.mesh!r} waits for a meshed dry run (ROADMAP Queue 1); "
                 f"--mesh takes {MESHES}")
    archs = sorted(ARCHS) if args.arch is None else [args.arch]
    shapes = [s.name for s in ALL_SHAPES] if args.shape is None else [args.shape]
    if not args.all and args.arch is None and args.shape is None:
        ap.error("pass --arch/--shape or --all")

    failures = 0
    for arch in archs:
        for shape in shapes:
            rec = run_cell(arch, shape, args.mesh, args.mode, args.out, args.tag,
                           attn=args.attn, microbatches=args.microbatches,
                           prepared=args.prepared)
            failures += rec["status"] == "fail"
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
