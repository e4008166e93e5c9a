#!/usr/bin/env python3
"""Times the PyTorch port's CORDIC row-softmax kernel of one source tree on an H100.

    python3 benchmarks/softmax_probe.py [--src DIR] [--label NAME] [--variants]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (default:
this checkout's), so that two trees (say, a commit and its parent unpacked
under ``build/``) can be timed in turns in one run on one card:

    python3 benchmarks/softmax_probe.py --src build/parent/src --label parent
    python3 benchmarks/softmax_probe.py --label change

Rows: ``af_softmax`` at full CORDIC depth, FxP8 and FxP16, on the shapes of
``chip_smoke.check_softmax`` (seeded N(0, 9) inputs, f32). Each row holds
whether the kernel is bitwise equal to ``af_softmax_ref`` and the device ms
per call by CUDA-graph replay; on a tree with ``ops.launch_plan`` also the
plan (cluster size, slice, threads, path). ``--variants`` (such trees only)
times other plans of each shape, launched through the library's C entry
directly: every cluster size that leaves a CTA a warp's worth of elements,
at the plan's thread rule and at 1024 threads; then the few-row shapes at
depth 2 (the CORDIC loops' share of the time), and a near-empty launch
(4 rows of 512, depth 2, one warp a CTA) at every cluster size (the fixed
cost of a launch, its cluster barriers and DSMEM reads). Prints one JSON
line with the card's name and power limit; needs a CUDA card and no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((64, 512), (5, 300), (4, 50304), (1, 50304), (4096, 64), (7, 17), (2, 1_000_000))
VARIANT_SHAPES = ((4, 50304), (1, 50304))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--variants", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # timing helpers only: graph_ms, nvidia_smi
    import torch

    if not torch.cuda.is_available():
        print("softmax_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(opts.src).resolve()))
    from repro_torch.core import FXP8, FXP16
    from repro_torch.core.activations import internal_fmt, softmax_shift
    from repro_torch.core.cordic import full_depth
    from repro_torch.kernels import _build
    from repro_torch.kernels.af_table import af_table_on
    from repro_torch.kernels.cordic_af import af_softmax, af_softmax_ref, ops

    dev = torch.device("cuda")
    _build.build_all()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def run_plan(x, depth, fmt, plan):
        out = torch.empty_like(x)
        tab = af_table_on(dev, depth, fmt)
        shift = softmax_shift(x.shape[1], internal_fmt(fmt).frac)

        def launch():
            status = ops._lib().af_softmax_launch(
                x.data_ptr(), out.data_ptr(), tab.data_ptr(), plan.rows, plan.n, plan.cluster,
                plan.slice, plan.threads, plan.smem_bytes, int(plan.path == "staged"), shift,
                torch.cuda.current_stream().cuda_stream)
            _build.check(status, "af_softmax_launch")
        return out, launch

    def variant(x, depth, fmt, plan, **extra):
        out, launch = run_plan(x, depth, fmt, plan)
        launch()
        return dict(cluster=plan.cluster, threads=plan.threads, depth=depth, fmt=str(fmt),
                    bitwise_equal=torch.equal(out, af_softmax_ref(x, depth=depth, fmt=fmt)),
                    ms=chip_smoke.graph_ms(launch, 20 if x.numel() > 1e6 else 100), **extra)

    def forced(shape, c, threads=None):
        """The shape's plan at cluster size ``c`` (shared path where it fits)."""
        base = ops.softmax_plan(*shape)
        sl = -(-shape[1] // c)
        shared = sl * 4 <= ops.SLICE_BYTES_CAP
        return dataclasses.replace(base, cluster=c, slice=sl,
                                   threads=threads or ops.slice_threads(sl),
                                   smem_bytes=4 * sl if shared else 0,
                                   path="shared" if shared else "staged")

    for shape in SHAPES:
        x = torch.randn(shape, generator=gen, device=dev) * 3.0
        for fmt in (FXP8, FXP16):
            depth = full_depth(fmt)
            equal = torch.equal(af_softmax(x, depth=depth, fmt=fmt),
                                af_softmax_ref(x, depth=depth, fmt=fmt))
            ms = chip_smoke.graph_ms(lambda: af_softmax(x, depth=depth, fmt=fmt),
                                     20 if x.numel() > 1e6 else 100)
            row = dict(shape=list(shape), fmt=str(fmt), bitwise_equal=equal, ms=ms)
            if hasattr(ops, "launch_plan"):
                plan = ops.launch_plan(*shape, dev)
                row.update(cluster=plan.cluster, planned_cluster=plan.planned_cluster,
                           slice=plan.slice, threads=plan.threads, path=plan.path)
                if opts.variants:
                    row["variants"] = [
                        variant(x, depth, fmt, forced(shape, c, threads))
                        for c in ops.CLUSTER_SIZES if -(-shape[1] // c) >= 32
                        for threads in (None, 1024)]
                    if shape in VARIANT_SHAPES:
                        row["variants"].append(variant(x, 2, fmt, plan))
            rows.append(row)
            print(f"{opts.label} {shape} {fmt}: {ms:.4f} ms equal={equal}", file=sys.stderr)
    if opts.variants and hasattr(ops, "launch_plan"):
        x = torch.randn((4, 512), generator=gen, device=dev) * 3.0
        rows.append(dict(shape=[4, 512], fmt=str(FXP8), row="fixed cost", variants=[
            variant(x, 2, FXP8, forced((4, 512), c, 32)) for c in ops.CLUSTER_SIZES]))
    print(json.dumps(dict(
        label=opts.label, nvidia_smi=chip_smoke.nvidia_smi(),
        device=torch.cuda.get_device_name(0), torch=torch.__version__,
        ptxas=_build.ptxas_summary("cordic_af"), rows=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
