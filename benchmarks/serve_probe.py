#!/usr/bin/env python3
"""Times full-width olmo-1b serving and two of its per-step pieces for one
source tree of the PyTorch port on an H100.

    python3 benchmarks/serve_probe.py [--src DIR] [--label NAME] [--repeats 3]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (default:
this checkout's), so that two trees (say, a commit and its parent unpacked
under ``build/``) can be timed in turns in one run on one card:

    python3 benchmarks/serve_probe.py --src build/parent/src --label parent
    python3 benchmarks/serve_probe.py --label change

Rows (16 layers, f32, seeded random weights, prepared kernel mode, accurate
FxP8; ``chip_smoke.py``'s six requests on 4 slots, max_len 512, burst 8,
every program a captured CUDA graph): the steady runs' tokens/s and ms per
decode step (after a first run that captures the graphs), the nonparametric
layernorm at decode (4 x 1 rows) and at a speculative verify (4 x 5 rows) of
d_model 2048, and the GQA cache attention at decode (B4 S1 H16 T512) with
every slot at one position (40, 100, 300, 511). Device ms by CUDA-graph
replay. Prints one JSON line with the card's name and power limit; needs a
CUDA card and no JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--repeats", type=int, default=3)
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("serve_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(opts.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke  # timing helpers, configs and requests; imports the tree above
    from repro_torch.core.normalization import nonparametric_ln
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import gqa_decode_attention
    from repro_torch.models import get_model
    from repro_torch.serve.engine import BatchedServer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    cfg = chip_smoke.olmo()
    model = get_model(cfg)
    server = BatchedServer(model, chip_smoke.kernel_ctx(),
                           model.init(torch.Generator(device=dev).manual_seed(chip_smoke.SEED)),
                           slots=chip_smoke.SLOTS, max_len=chip_smoke.MAX_LEN,
                           burst=chip_smoke.BURST, device=dev)
    _, first = chip_smoke.timed_run(server, chip_smoke.requests(cfg))
    runs = [chip_smoke.timed_run(server, chip_smoke.requests(cfg))[1]
            for _ in range(opts.repeats)]
    gen = torch.Generator(device=dev).manual_seed(1)
    norm = {}
    for rows in (1, 5):
        x = torch.randn((chip_smoke.SLOTS, rows, cfg.d_model), generator=gen, device=dev)
        norm[f"4x{rows}"] = chip_smoke.graph_ms(lambda: nonparametric_ln(x), 200)
    attn = {}
    b, h, hd, t = chip_smoke.SLOTS, 16, 128, chip_smoke.MAX_LEN
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev)
    ck = torch.randn((b, t, h, hd), generator=gen, device=dev)
    cv = torch.randn((b, t, h, hd), generator=gen, device=dev)
    for p in (40, 100, 300, 511):
        pos = torch.full((b, 1), p, dtype=torch.int32, device=dev)
        attn[str(p)] = chip_smoke.graph_ms(
            lambda: gqa_decode_attention(q, ck, cv, pos, scale=1.0 / math.sqrt(hd)), 200)
    print(json.dumps(dict(
        label=opts.label, src=opts.src, device=torch.cuda.get_device_name(0),
        nvidia_smi=chip_smoke.nvidia_smi(), first_run_tokens_per_s=first["tokens_per_s"],
        tokens_per_s=[r["tokens_per_s"] for r in runs],
        tokens_per_s_median=statistics.median(r["tokens_per_s"] for r in runs),
        decode_ms_per_step=[r["decode_ms_per_step"] for r in runs],
        layernorm_ms=norm, gqa_decode_ms_by_position=attn)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
