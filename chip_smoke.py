#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Builds both CUDA kernels from the checkout's sources, then:

1. prints the device, the toolchain and each kernel's registers and shared
   memory (``nvcc -Xptxas -v``);
2. holds each kernel against its plain PyTorch version on the card at the
   serving path's full-width olmo-1b shapes — the fused CORDIC dot+AF must be
   bitwise equal, the GQA decode attention within its stated tolerance — and
   times kernel, plain version, a library yardstick and the roofline bound;
3. serves full-width olmo-1b (16 layers, ``dtype="float32"``, seeded random
   weights) through ``BatchedServer`` in prepared kernel mode, checks both
   kernels' launch counts against what the shapes imply, and checks that a
   repeat run and a ``burst=1`` run give identical greedy streams;
4. serves the same widths at 2 layers on the card and on the CPU (plain
   versions) with the same weights, and checks the streams are identical.

It imports nothing of JAX. It exits non-zero on any failure, and when no CUDA
device is present. A full JSON report goes to ``chiprun_out/chip_smoke.json``.
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 tensor ops/s,
# f32 CUDA-core flop/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
F32_FLOPS_PER_S = 67e12

SLOTS, MAX_LEN, BURST, BUCKET = 4, 512, 8, 512
PROMPT_LENS = (3, 17, 60, 130, 300, 9)
MAX_NEW = 32
SEED = 0
FUSED_SHAPES = ((2048, 2048), (2048, 8192), (8192, 2048), (2048, 50304))  # (K, N)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` calls, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's time between launches is not counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, ops_per_s: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# name fragments of library matmul / attention kernels, none of which the
# port's serving path may launch
LIBRARY_KERNELS = ("gemm", "cublas", "cutlass", "fmha", "flash", "attention_kernel", "sdpa")


def kernel_breakdown(prof):
    """``(device_us, kernel name, calls)`` of every device kernel in a
    ``torch.profiler`` run, largest first."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # host ops carry their kernels' time too
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    return sorted(rows, reverse=True)


def library_kernels(rows) -> list:
    """The names in a breakdown that belong to library matmul/attention kernels."""
    return [k for _, k, _ in rows if any(f in k.lower() for f in LIBRARY_KERNELS)]


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def prepared_weight(k: int, n: int, fmt, gen, device, copies: int = 1):
    """Signed-digit weight integers + point for a random (K, N) weight, as
    ``prepare_params`` makes them; ``copies`` distinct banks for cold-cache
    timing."""
    import torch

    from repro_torch.core import PrecisionPolicy
    from repro_torch.core.backends.kernel import KernelBackend

    lp = PrecisionPolicy.accurate(fmt).default
    banks = []
    for _ in range(copies):
        w = torch.randn((k, n), generator=gen, device=device) * 0.3
        banks.append(KernelBackend().prepare(w, lp))
    return banks


def check_fused(device):
    import torch

    from repro_torch.core import FXP8, FXP16
    from repro_torch.kernels.cordic_fused import FUSED_AFS, fused_dot_af, fused_dot_af_ref

    gen = torch.Generator(device=device).manual_seed(SEED)
    rows, max_err = [], 0.0
    for k, n in FUSED_SHAPES:
        banks = prepared_weight(k, n, FXP8, gen, device,
                                copies=max(1, min(48, math.ceil(3e8 / (k * n)))))
        for m in (SLOTS, BUCKET):
            x = torch.randn((m, k), generator=gen, device=device)
            for af in ("identity", "swish"):
                w = banks[0]
                kw = dict(af_mode=af, af_depth=FXP8.frac + 1, af_fmt=FXP8)
                got = fused_dot_af(x, w.data, w.point, **kw)
                want = fused_dot_af_ref(x, w.data, w.point, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    bad = (got != want).sum().item()
                    raise AssertionError(f"fused_dot_af != plain at M={m} K={k} N={n} af={af}: "
                                         f"{bad} elements differ")
                err = (got - want).abs().max().item()
                max_err = max(max_err, err)
                it = iter(range(1 << 30))
                call = lambda: fused_dot_af(  # noqa: E731
                    x, banks[next(it) % len(banks)].data, banks[0].point, **kw)
                iters = 60 if m <= 32 else 20
                ms = graph_ms(call, iters)
                eager_ms = timed_ms(call, iters)
                plain_ms = timed_ms(lambda: fused_dot_af_ref(x, w.data, w.point, **kw),
                                    iters=5, warmup=1)
                lib_ms = None
                if af == "identity" and m > 16 and k % 8 == 0 and n % 8 == 0:
                    xq = torch.clamp(torch.round(x * 64), -128, 127).to(torch.int8)
                    lib_ms = graph_ms(lambda: torch._int_mm(
                        xq, banks[next(it) % len(banks)].data), iters)
                b_ms, b_by = bound(m * k * 4 + k * n + m * n * 4 + 20, 2.0 * m * n * k,
                                   INT8_OPS_PER_S)
                rows.append(dict(M=m, K=k, N=n, af=af, fmt="fxp8", bitwise_equal=True,
                                 max_abs_err=err, ms=ms, eager_ms=eager_ms,
                                 plain_ms=plain_ms, int_mm_ms=lib_ms, bound_ms=b_ms,
                                 bound_by=b_by))
                log(f"fused M={m} K={k} N={n} {af}: {ms:.4f} ms (eager {eager_ms:.4f}, "
                    f"plain {plain_ms:.3f}, int_mm {lib_ms}, bound {b_ms:.4f} {b_by})")
    # every AF mode, both formats, compute_round, at one shape
    m, k, n = SLOTS, 2048, 2048
    x = torch.randn((m, k), generator=gen, device=device) * 2.0
    for fmt in (FXP8, FXP16):
        w = prepared_weight(k, n, fmt, gen, device)[0]
        for af in FUSED_AFS:
            for compute_round in (False, True):
                kw = dict(af_mode=af, af_depth=fmt.frac + 1, af_fmt=fmt,
                          compute_round=compute_round)
                got = fused_dot_af(x, w.data, w.point, **kw)
                want = fused_dot_af_ref(x, w.data, w.point, **kw)
                if not torch.equal(got, want):
                    raise AssertionError(f"fused_dot_af != plain: {fmt} {af} "
                                         f"compute_round={compute_round}")
        rows.append(dict(M=m, K=k, N=n, af="all 7", fmt=str(fmt), compute_round="both",
                         bitwise_equal=True))
    torch.cuda.synchronize()
    return rows, max_err


def check_attention(device):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        TOLERANCE, gqa_decode_attention, gqa_decode_attention_ref)

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    cases = [  # (B, S, T, H, KV, hd)
        (SLOTS, 1, MAX_LEN, 16, 16, 128),
        (1, BUCKET, MAX_LEN, 16, 16, 128),
        (SLOTS, 1, MAX_LEN, 16, 8, 128),
        (2, 4, MAX_LEN, 16, 8, 128),
    ]
    rows, max_err = [], 0.0
    for b, s, t, h, kv, hd in cases:
        q = torch.randn((b, s, h, hd), generator=gen, device=device)
        ck = torch.randn((b, t, kv, hd), generator=gen, device=device)
        cv = torch.randn((b, t, kv, hd), generator=gen, device=device)
        if s == 1:
            pos = torch.full((b, 1), t - 1, dtype=torch.int32, device=device)
        else:
            start = torch.randint(0, t - s + 1, (b, 1), generator=gen, device=device)
            pos = (start + torch.arange(s, device=device)[None]).to(torch.int32)
        scale = 1.0 / math.sqrt(hd)
        got = gqa_decode_attention(q, ck, cv, pos, scale=scale)
        want = gqa_decode_attention_ref(q, ck, cv, pos, scale=scale)
        err = (got - want).abs().max().item()
        if not err <= TOLERANCE:
            raise AssertionError(f"gqa_decode_attention vs plain: max|diff| {err} > {TOLERANCE} "
                                 f"at B={b} S={s} T={t} H={h} KV={kv}")
        max_err = max(max_err, err)
        call = lambda: gqa_decode_attention(q, ck, cv, pos, scale=scale)  # noqa: E731
        ms = graph_ms(call, 100)
        eager_ms = timed_ms(call, 100)
        plain_ms = timed_ms(lambda: gqa_decode_attention_ref(q, ck, cv, pos, scale=scale),
                            iters=20)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, ck, cv))
        if kv != h:
            kt, vt = kt.repeat_interleave(h // kv, 1), vt.repeat_interleave(h // kv, 1)
        mask = (torch.arange(t, device=device)[None, None, :] <= pos[:, :, None])[:, None]
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                 scale=scale), 100)
        # the keys this run's positions need: each batch row's K/V up to its
        # last query position, each query row's scores up to its own
        rows_needed = (pos.max(dim=1).values + 1).clamp(max=t).sum().item()
        kv_bytes = rows_needed * kv * hd * 4 * 2
        flops = 4.0 * h * hd * (pos.long() + 1).clamp(max=t).sum().item()
        b_ms, b_by = bound(kv_bytes + 2 * q.numel() * 4 + pos.numel() * 4, flops,
                           F32_FLOPS_PER_S)
        rows.append(dict(B=b, S=s, T=t, H=h, KV=kv, hd=hd, tolerance=TOLERANCE,
                         max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                         sdpa_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by))
        log(f"attn B={b} S={s} T={t} H={h} KV={kv}: {ms:.4f} ms (eager {eager_ms:.4f}, "
            f"plain {plain_ms:.3f}, "
            f"sdpa {lib_ms:.4f}, bound {b_ms:.4f} {b_by}) err {err:.2e}")
    return rows, max_err


# ---------------------------------------------------------------------------
# phases 3-4: serving
# ---------------------------------------------------------------------------


def olmo(layers=None):
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("olmo-1b"), dtype="float32")
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def kernel_ctx():
    import torch

    from repro_torch.core import FXP8, EngineContext, PrecisionPolicy

    return EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(FXP8),
                         compute_dtype=torch.float32, attn_impl="decode_kernel")


def requests(cfg, lens=None, max_new=None):
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(SEED)
    return [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new or MAX_NEW) for i, n in enumerate(lens or PROMPT_LENS)]


def serve_full_width(device):
    import torch

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.cordic_fused import fused_dot_af
    from repro_torch.kernels.decode_attention import gqa_decode_attention
    from repro_torch.models import get_model
    from repro_torch.serve.engine import BatchedServer

    cfg = olmo()
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    server = BatchedServer(model, kernel_ctx(), params, slots=SLOTS, max_len=MAX_LEN,
                           burst=BURST, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts zeroed just before, read just after
    fused_dot_af.launches = 0
    gqa_decode_attention.launches = 0
    t0 = time.perf_counter()
    first = server.run(requests(cfg))
    wall = time.perf_counter() - t0
    launches = {"fused_dot_af": fused_dot_af.launches,
                "gqa_decode_attention": gqa_decode_attention.launches}
    forwards = server.prefill_calls + server.decode_steps
    per_forward = {"fused_dot_af": 7 * cfg.num_layers + 1, "gqa_decode_attention": cfg.num_layers}
    for name, count in launches.items():
        want = per_forward[name] * forwards
        if count == 0 or count != want:
            raise AssertionError(f"{name}: {count} launches on the main path, shapes imply {want}")
    tokens = sum(len(v) for v in first.values())
    report = dict(
        config="olmo-1b full width, 16 layers, dtype float32, kernel mode, FxP8 accurate, "
               "attn_impl=decode_kernel",
        slots=SLOTS, max_len=MAX_LEN, burst=BURST, prompt_lens=list(PROMPT_LENS),
        max_new=MAX_NEW, tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        prefill_s=server.prefill_seconds, decode_s=server.decode_seconds,
        prefill_calls=server.prefill_calls, decode_steps=server.decode_steps,
        decode_ms_per_step=server.decode_seconds / max(server.decode_steps, 1) * 1e3,
        host_transfers=server.host_transfers,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches, launches_per_forward=per_forward,
    )
    for name, tok in first.items():
        if len(tok) != MAX_NEW:
            raise AssertionError(f"request {name} produced {len(tok)} tokens")
    # the repeat run, under the profiler: what ran on the card
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = server.run(requests(cfg))
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    if again != first:
        raise AssertionError("full-width greedy streams differ between two runs")
    rows = kernel_breakdown(prof)
    foreign = library_kernels(rows)
    if foreign:
        raise AssertionError(f"library matmul/attention kernels ran on the main path: {foreign}")
    busy_ms = sum(r[0] for r in rows) / 1e3
    report["profiled_repeat"] = dict(
        wall_ms=profiled_wall * 1e3, device_busy_ms=busy_ms,
        device_busy_share=busy_ms / (profiled_wall * 1e3),
        device_launches_per_forward=sum(r[2] for r in rows) / forwards,
        library_kernels=foreign,
        top_kernels=[dict(name=k[:100], device_ms=us / 1e3, calls=n)
                     for us, k, n in rows[:12]])
    one = BatchedServer(model, kernel_ctx(), params, slots=SLOTS, max_len=MAX_LEN, burst=1,
                        device=device).run(requests(cfg))
    if one != first:
        raise AssertionError("full-width greedy streams differ between burst=8 and burst=1")
    report["repeat_identical"] = True
    report["burst1_identical"] = True
    report["streams_head"] = {rid: toks[:8] for rid, toks in first.items()}
    return report


def card_vs_cpu(device):
    import torch

    from repro_torch.models import get_model
    from repro_torch.serve.engine import BatchedServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = olmo(layers=2)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cpu").manual_seed(SEED))
    reqs = lambda: requests(cfg, lens=(5, 11), max_new=8)  # noqa: E731
    out, logits = {}, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        server = BatchedServer(model, kernel_ctx(), params, slots=2, max_len=64, burst=4,
                               device=dev)
        out[where] = server.run(reqs())
        prompt = torch.as_tensor(reqs()[1].prompt[None], device=dev)
        row = model.make_cache(1, 64, device=dev)
        with torch.no_grad():
            lg, _ = model.decode_step(server.params, prompt, row, server.ctx)
        logits[where] = lg.cpu()
    if out["card"] != out["cpu"]:
        raise AssertionError(f"2-layer streams differ card vs CPU: {out}")
    diff = (logits["card"] - logits["cpu"]).abs().max().item()
    return dict(layers=2, streams_identical=True, prefill_logits_max_abs_diff=diff,
                streams=out["card"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    _build.build_all()
    device_line = dict(
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=_build.build_info["seconds"],
        ptxas={name: _build.ptxas_summary(name) for name in _build.build_info["ptxas"]},
    )
    emit({"device": device_line})

    fused_rows, fused_err = check_fused(device)
    attn_rows, attn_err = check_attention(device)
    emit({"kernel_checks": {"fused_dot_af": fused_rows, "gqa_decode_attention": attn_rows}})

    serving = serve_full_width(device)
    emit({"serving": serving})
    parity = card_vs_cpu(device)
    emit({"card_vs_cpu": parity})

    rep_f = next(r for r in fused_rows if (r["M"], r["K"], r["N"], r["af"]) ==
                 (SLOTS, 2048, 8192, "identity"))
    rep_a = attn_rows[0]
    kernels = [
        dict(name="fused_dot_af", route="cuda",
             source="src/repro_torch/kernels/cordic_fused/csrc/cordic_fused.cu",
             replaces="src/repro/kernels/cordic_fused/kernel.py:104",
             launches=serving["launches"]["fused_dot_af"], max_abs_err=fused_err,
             ms=rep_f["ms"], plain_ms=rep_f["plain_ms"], bound_ms=rep_f["bound_ms"],
             bound_by=rep_f["bound_by"], library_ms=None),
        dict(name="gqa_decode_attention", route="cuda",
             source="src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:40",
             launches=serving["launches"]["gqa_decode_attention"], max_abs_err=attn_err,
             ms=rep_a["ms"], plain_ms=rep_a["plain_ms"], bound_ms=rep_a["bound_ms"],
             bound_by=rep_a["bound_by"], library_ms=rep_a["sdpa_ms"]),
    ]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        device=device_line, kernel_checks={"fused_dot_af": fused_rows,
                                           "gqa_decode_attention": attn_rows},
        serving=serving, card_vs_cpu=parity, kernels=kernels), indent=1))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
