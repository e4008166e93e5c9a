"""Roofline report of the dry run's cells on one H100 (port of
``repro.launch.roofline``):

    compute term = sum over kinds of ops_by_kind[kind] / peak[kind]   [s]
    memory term  = hbm_bytes_dev / 3.35 TB/s                         [s]
    link term    = coll_bytes_dev / NVLink's 450 GB/s a direction     [s]

The reference charges every FLOP at one bf16 peak. The port's work runs on
units whose rates differ 30x (int8 tensor cores, int32 and f32 CUDA cores,
TF32 and bf16 tensor cores), so the compute term sums each kind of
operation at its own peak (``kernels/costs.py``). ``flops_dev`` and the
rest come from the cost analyzer (``launch/cost_analysis.py``) through the
dry run (``launch/dryrun.py``).

MODEL_FLOPS = 6*N_active*D (train), 2*N_active*D (prefill) or 2*N_active*B
(decode): the useful-compute yardstick; its ratio to the analyzed flops
exposes remat and padding. :func:`measured_share` is MODEL_FLOPS over a
measured step time and the peak of the mode's dot kind: the share of the
card's dot rate the step turns into useful work.

Usage: python -m repro_torch.launch.roofline [--dir artifacts/dryrun_torch] [--mode kernel]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.kernels.costs import HBM_BYTES_PER_S, NVLINK_BYTES_PER_S, PEAKS, peak_seconds
from repro_torch.models import get_model

# the rate each engine mode's dots run at: the kernels and the MAC-array
# kernel on the int8 tensor cores (FxP8 banks), the exact and carmen modes'
# f32 products on the CUDA cores (TF32 off)
DOT_KIND = {"kernel": "int8", "int8": "int8", "exact": "f32", "carmen": "f32"}
CHIPS = {"none": 1}


def routed_expert_params(cfg) -> int:
    if not cfg.moe:
        return 0
    m = cfg.moe
    n_moe_layers = (cfg.num_layers - m.first_dense_layers) // m.moe_every
    return n_moe_layers * m.num_experts * 3 * cfg.d_model * m.d_ff_expert


def active_params(cfg) -> int:
    """Params touched per token: total - embedding-table lookups - inactive experts."""
    total = get_model(cfg).count_params()
    embed = cfg.vocab_size * cfg.d_model  # lookup, not matmul
    routed = routed_expert_params(cfg)
    active_routed = routed * (cfg.moe.top_k / cfg.moe.num_experts) if cfg.moe else 0
    return int(total - embed - routed + active_routed)


def model_flops(cfg, shape) -> float:
    n = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per row


def attn_flops(cfg, shape) -> float:
    """Quadratic attention score+value flops (reported alongside, not in 6ND)."""
    if not cfg.num_heads:
        return 0.0
    d_attn = cfg.num_heads * cfg.head_dim
    b, s = shape.global_batch, shape.seq_len
    layers = cfg.num_layers
    if shape.kind == "train":
        return 3 * 4.0 * b * s * s * d_attn * layers / 2  # causal half, fwd+bwd
    if shape.kind == "prefill":
        return 4.0 * b * s * s * d_attn * layers / 2
    return 4.0 * b * s * d_attn * layers  # decode: 1 x S per layer


def load_records(art_dir: str, mesh: Optional[str] = None, mode: str = "exact", tag: str = ""):
    recs = []
    for path in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if mesh and r.get("mesh") != mesh:
            continue
        if r.get("mode", "exact") != mode or r.get("tag", "") != tag:
            continue
        recs.append(r)
    return recs


def cell_shape(rec: Dict) -> ShapeConfig:
    """A record's shape: a named cell's, or the ``seq_len``, ``global_batch``
    and ``kind`` a record of another step carries."""
    if rec["shape"] in SHAPES:
        return SHAPES[rec["shape"]]
    return ShapeConfig(rec["shape"], rec["seq_len"], rec["global_batch"], rec["kind"])


def terms(rec: Dict) -> Dict:
    cfg = get_config(rec["arch"])
    shape = cell_shape(rec)
    chips = CHIPS[rec["mesh"]]
    t_c = peak_seconds(rec["ops_by_kind"])
    t_m = rec["hbm_bytes_dev"] / HBM_BYTES_PER_S
    t_x = rec["coll_bytes_dev"] / NVLINK_BYTES_PER_S
    dom = max(("compute", t_c), ("memory", t_m), ("link", t_x), key=lambda kv: kv[1])
    mf = model_flops(cfg, shape)
    analyzed = rec["flops_dev"] * chips
    peak = PEAKS[DOT_KIND[rec["mode"]]]
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "link_s": t_x,
        "bottleneck": dom[0],
        "step_s": dom[1],
        "model_flops": mf,
        "attn_flops": attn_flops(cfg, shape),
        "flops_global": analyzed,
        "useful_ratio": mf / analyzed if analyzed else 0.0,
        "roofline_frac": (mf / chips / peak) / dom[1] if dom[1] else 0.0,
    }


def measured_share(rec: Dict, step_s: float) -> float:
    """MODEL_FLOPS over a measured step time and the peak of the mode's dot
    kind (int8 for the kernel and int8 modes, f32 for exact and carmen)."""
    cfg = get_config(rec["arch"])
    return model_flops(cfg, cell_shape(rec)) / (step_s * PEAKS[DOT_KIND[rec["mode"]]])


def render(recs: List[Dict]) -> str:
    hdr = (
        "| arch | shape | mode | compute s | memory s | link s | bottleneck | "
        "MODEL TF | useful (model/analyzed) | roofline frac | fits one 80 GB card |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for r in recs:
        if r["status"] == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mode']} | — | — | — "
                        f"| SKIP: {r['reason'][:40]} | | | | |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mode']} | — | — | — "
                        f"| FAIL: {r.get('error', '')[:40]} | | | | |")
            continue
        t = terms(r)
        fits = "yes" if r["fits_one_card"] else "no"
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mode']} "
            f"| {t['compute_s']:.4g} | {t['memory_s']:.4g} | {t['link_s']:.4g} "
            f"| **{t['bottleneck']}** | {t['model_flops'] / 1e12:.1f} "
            f"| {t['useful_ratio']:.2f} | {t['roofline_frac']:.3g} | {fits} |"
        )
    return hdr + "\n".join(rows) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    default_dir = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                               "dryrun_torch")
    ap.add_argument("--dir", default=default_dir)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--mode", default="exact")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    recs = load_records(args.dir, args.mesh, args.mode, args.tag)
    md = render(recs)
    print(md)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)


if __name__ == "__main__":
    main()
