#!/usr/bin/env python3
"""Times captured full-width serving of the rmsnorm and MLA/MoE archs and
the row-stable pieces under them, for one source tree of the PyTorch port
on an H100.

    python3 benchmarks/row_probe.py [--src DIR] [--label NAME] [--repeats 2]
        [--archs deepseek-v3-671b,qwen3-8b]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (default:
this checkout's), so that a commit and its parent (unpacked under
``build/``) can be timed in turns in one run on one card.

Rows: for each arch (``chip_smoke.py``'s depth cut, f32, seeded random
weights, prepared kernel mode, accurate FxP8, the six requests on 4 slots,
max_len 512, burst 8, every program a captured CUDA graph) the steady runs'
tokens/s and ms per decode step after a first run that captures the graphs;
the rmsnorm at d 7168 over 1, 4, 5, 20 and 512 rows (device ms by CUDA-graph
replay, and the kernels it launches with their grids, from the profiler's
trace); the MLA cache attention at a decode step (B4 S1) and a verify (B4
S5) at deepseek-v3's widths, every slot at row 300. Prints one JSON line
with the card's name and power limit; needs a CUDA card and no JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def kernel_grids(fn) -> list:
    """(name, grid, block) of every kernel ``fn`` launches, from the
    profiler's chrome trace."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.load(open(f.name)).get("traceEvents", [])
    return [(e["name"][:80], e.get("args", {}).get("grid"), e.get("args", {}).get("block"))
            for e in events if e.get("cat") == "kernel"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--archs", default="deepseek-v3-671b,qwen3-8b")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("row_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(opts.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke  # timing helpers, configs and requests; imports the tree above
    from repro_torch.core.normalization import rmsnorm
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import mla_decode_attention
    from repro_torch.models import get_model
    from repro_torch.serve.engine import BatchedServer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    serving = {}
    for name in opts.archs.split(","):
        cfg = chip_smoke.deepseek() if name == "deepseek-v3-671b" else chip_smoke.arch_config(name)
        model = get_model(cfg)
        server = BatchedServer(model, chip_smoke.kernel_ctx(),
                               model.init(torch.Generator(device=dev).manual_seed(chip_smoke.SEED)),
                               slots=chip_smoke.SLOTS, max_len=chip_smoke.MAX_LEN,
                               burst=chip_smoke.BURST, device=dev)
        _, first = chip_smoke.timed_run(server, chip_smoke.requests(cfg))
        runs = [chip_smoke.timed_run(server, chip_smoke.requests(cfg))[1]
                for _ in range(opts.repeats)]
        serving[name] = dict(
            layers=cfg.num_layers, first_run_tokens_per_s=first["tokens_per_s"],
            tokens_per_s=[r["tokens_per_s"] for r in runs],
            tokens_per_s_median=statistics.median(r["tokens_per_s"] for r in runs),
            decode_ms_per_step=[r["decode_ms_per_step"] for r in runs])
        del server, model
        chip_smoke.free_card()
    gen = torch.Generator(device=dev).manual_seed(1)
    d = 7168
    w = torch.randn((d,), generator=gen, device=dev)
    norm = {}
    for rows in (1, 4, 5, 20, 512):
        x = torch.randn((rows, d), generator=gen, device=dev)
        norm[str(rows)] = dict(ms=chip_smoke.graph_ms(lambda: rmsnorm(x, w), 200),
                               kernels=kernel_grids(lambda: rmsnorm(x, w)))
    mla = {}
    b, h, r, rd, t = chip_smoke.SLOTS, 128, 512, 64, chip_smoke.MAX_LEN
    ck = torch.randn((b, t, r), generator=gen, device=dev)
    kr = torch.randn((b, t, rd), generator=gen, device=dev)
    for s in (1, chip_smoke.DRAFT_LEN + 1):
        ql = torch.randn((b, s, h, r), generator=gen, device=dev)
        qr = torch.randn((b, s, h, rd), generator=gen, device=dev)
        pos = (300 + torch.arange(s, device=dev)[None].expand(b, s)).to(torch.int32).contiguous()
        mla[f"B{b} S{s}"] = chip_smoke.graph_ms(
            lambda: mla_decode_attention(ql, qr, ck, kr, pos, scale=1.0 / math.sqrt(128 + rd)),
            200)
    print(json.dumps(dict(
        label=opts.label, src=opts.src, device=torch.cuda.get_device_name(0),
        nvidia_smi=chip_smoke.nvidia_smi(), serving=serving, rmsnorm_d7168=norm,
        mla_decode_ms=mla)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
