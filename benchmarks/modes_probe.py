#!/usr/bin/env python3
"""Where full-width olmo-1b serving spends the card's time in each engine
mode of the PyTorch port on an H100.

    python3 benchmarks/modes_probe.py [--modes exact,carmen,int8,kernel] [--max-new 9]

For each mode: a server of full-width olmo-1b (16 layers, f32, seeded random
weights, accurate FxP8 where the mode has a policy; ``chip_smoke.py``'s six
requests on 4 slots, max_len 512, burst 8, every program a captured CUDA
graph) serves the requests once (capturing its graphs), once more timed,
and once more under ``torch.profiler`` for ``--max-new`` tokens a request.
Prints one JSON line a mode: tokens/s and ms per decode step of the timed
run, and from the profile the device's busy share and its device ms per
model forward by kind of kernel (the port's kernels, library matmuls, other
PyTorch kernels), with the top kernels and their launches per forward;
writes them all to ``chiprun_out/modes_probe.json``. Needs a CUDA card and
no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def kind(name: str, port: tuple, gemm: tuple) -> str:
    if any(p in name for p in port):
        return "port kernels"
    if any(g in name.lower() for g in gemm):
        return "library matmul"
    return "other torch kernels"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default="exact,carmen,int8,kernel")
    ap.add_argument("--max-new", type=int, default=9)
    opts = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("modes_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke  # configs, requests, timing and profile helpers
    from repro_torch.kernels import _build
    from repro_torch.models import get_model
    from repro_torch.serve.engine import BatchedServer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    cfg = chip_smoke.olmo()
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(chip_smoke.SEED))
    gemm = chip_smoke.GEMM_KERNELS + ("gemv",)
    out = []
    for mode in opts.modes.split(","):
        server = BatchedServer(model, chip_smoke.mode_ctx(mode), params, slots=chip_smoke.SLOTS,
                               max_len=chip_smoke.MAX_LEN, burst=chip_smoke.BURST, device=dev)
        server.run(chip_smoke.requests(cfg))  # captures the graphs
        _, timed = chip_smoke.timed_run(server, chip_smoke.requests(cfg))
        reqs = chip_smoke.requests(cfg, max_new=opts.max_new)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            server.run(reqs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        forwards = chip_smoke.model_forwards(server)
        rows = chip_smoke.kernel_breakdown(prof)
        by_kind = {}
        for us, name, _ in rows:
            k = kind(name, chip_smoke.PORT_KERNELS, gemm)
            by_kind[k] = by_kind.get(k, 0.0) + us / 1e3 / forwards
        busy_ms = sum(r[0] for r in rows) / 1e3
        rep = dict(mode=mode, card=card, tokens_per_s=timed["tokens_per_s"],
                   decode_ms_per_step=timed["decode_ms_per_step"],
                   profiled=dict(requests=len(reqs), max_new=opts.max_new, forwards=forwards,
                                 wall_ms=wall_ms, device_busy_ms=busy_ms,
                                 device_busy_share=busy_ms / wall_ms,
                                 launches_per_forward=sum(r[2] for r in rows) / forwards),
                   device_ms_per_forward=by_kind,
                   top_kernels=[dict(name=n[:90], device_ms_per_forward=us / 1e3 / forwards,
                                     launches_per_forward=c / forwards)
                                for us, n, c in rows[:10]])
        print(json.dumps(rep), flush=True)
        out.append(rep)
        del server
        chip_smoke.free_card()
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "modes_probe.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
