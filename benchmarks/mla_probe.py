#!/usr/bin/env python3
"""Times the PyTorch port's MLA attention kernels of one source tree on an H100.

    python3 benchmarks/mla_probe.py [--src DIR] [--label NAME] [--split-targets 132,264]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (default:
this checkout's), so that two trees (say, a commit and its parent unpacked
under ``build/``) can be timed in turns in one run on one card:

    python3 benchmarks/mla_probe.py --src build/parent/src --label parent
    python3 benchmarks/mla_probe.py --label change

Rows, at deepseek-v3 widths (H 128, R 512, r 64; f32, seeded inputs): the
cache attention (``mla_decode_attention``) at decode (B4 S1 over T 512, each
slot at the cache's last row) and at the serving prefill buckets 4, 16, 64
and 512 from row 0 (T 512), and the cache-free MLA flash attention at B1
S512, causal. Each row holds the largest |kernel - plain| and the device ms
per call by CUDA-graph replay. With ``--split-targets`` the decode row is
timed again with the key splits aimed at each number of blocks (trees whose
``decode_attention.ops`` has ``_MLA_TARGET_BLOCKS``). Prints one JSON line
with the card's name and power limit; needs a CUDA card and no JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--split-targets", default="")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # timing helpers only: graph_ms, nvidia_smi
    import torch

    if not torch.cuda.is_available():
        print("mla_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(opts.src).resolve()))
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import (mla_decode_attention,
                                                      mla_decode_attention_ref, ops)
    from repro_torch.kernels.mla_flash import mla_flash_attention, mla_flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    h, r, rd, t = 128, 512, 64, 512
    scale = 1.0 / math.sqrt(128 + rd)  # deepseek-v3: 1 / sqrt(qk_nope + qk_rope)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def cache_row(b, s, name, **extra):
        ql = torch.randn((b, s, h, r), generator=gen, device=dev)
        qr = torch.randn((b, s, h, rd), generator=gen, device=dev)
        ck = torch.randn((b, t, r), generator=gen, device=dev)
        kr = torch.randn((b, t, rd), generator=gen, device=dev)
        pos = (torch.full((b, 1), t - 1, dtype=torch.int32, device=dev) if s == 1 else
               torch.arange(s, dtype=torch.int32, device=dev)[None].repeat(b, 1))
        args = (ql, qr, ck, kr, pos)
        err = (mla_decode_attention(*args, scale=scale)
               - mla_decode_attention_ref(*args, scale=scale)).abs().max().item()
        ms = chip_smoke.graph_ms(lambda: mla_decode_attention(*args, scale=scale),
                                 100 if s <= 64 else 20)
        rows.append(dict(row=name, B=b, S=s, T=t, splits=ops.mla_splits(b, s, h, t),
                         max_abs_err=err, ms=ms, **extra))

    cache_row(4, 1, "cache decode")
    for target in [int(x) for x in opts.split_targets.split(",") if x]:
        if hasattr(ops, "_MLA_TARGET_BLOCKS"):
            planned, ops._MLA_TARGET_BLOCKS = ops._MLA_TARGET_BLOCKS, target
            try:
                cache_row(4, 1, "cache decode", split_target=target)
            finally:
                ops._MLA_TARGET_BLOCKS = planned
    for s in (4, 16, 64, 512):
        cache_row(1, s, "cache prefill from row 0")
    s = 512
    ql = torch.randn((1, s, h, r), generator=gen, device=dev)
    qr = torch.randn((1, s, h, rd), generator=gen, device=dev)
    ck = torch.randn((1, s, r), generator=gen, device=dev)
    kr = torch.randn((1, s, rd), generator=gen, device=dev)
    args = (ql, qr, ck, kr)
    err = (mla_flash_attention(*args, scale=scale)
           - mla_flash_attention_ref(*args, scale=scale)).abs().max().item()
    ms = chip_smoke.graph_ms(lambda: mla_flash_attention(*args, scale=scale), 20)
    rows.append(dict(row="flash causal", B=1, S=s, max_abs_err=err, ms=ms))
    print(json.dumps(dict(
        label=opts.label, nvidia_smi=chip_smoke.nvidia_smi(),
        device=torch.cuda.get_device_name(0), torch=torch.__version__,
        ptxas={name: _build.ptxas_summary(name) for name in ("decode_attention", "mla_flash")},
        rows=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
