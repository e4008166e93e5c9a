#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Builds every CUDA kernel library from the checkout's sources (the fused
CORDIC dot+AF, the MAC-array matmul, the GQA and MLA cache-decode
attentions, the standalone multi-AF block and its row softmax, the
cache-free flash and MLA flash attentions), then:

1. prints the device, the toolchain and each kernel's registers and shared
   memory (``nvcc -Xptxas -v``);
2. holds each kernel against its plain PyTorch version on the card at the
   serving paths' full-width shapes (olmo-1b, deepseek-v3 and, for the
   fused dot, the GQA cache attention and flash, the other archs' new
   shapes: odd and wide vocabularies, 5 and 8 head groups) — the fused
   CORDIC dot+AF, the MAC-array matmul, the multi-AF block and the softmax
   must be bitwise equal, the two decode attentions within their stated
   tolerance, the two flash attentions within it — and times kernel, plain
   version, a library yardstick and the roofline bound; the fused and MAC
   rows run on K-major banks at decode (the narrow loop) and at 64, 512
   and 1024 rows (the int8 tensor cores), record the path each took, and
   time ``torch._int_mm`` on the K-major bank and on an N-major copy; the
   GQA cache attention at decode and at the prefill buckets 16, 64 and 512
   records its path (split keys below 16 query rows, the 3xTF32
   tensor-core tile loop from 16) with the f32-FMA and 3xTF32 bounds, and
   ``gqa_path_alternatives`` times both paths at decode and at the buckets
   4 to 64; the MLA cache attention (its 3xTF32 tensor-core loop, the
   heads of one query as the MMA rows) runs at decode, at the prefill
   buckets 16, 64 and 512 from row 0 and, with a drained slot and a masked
   row, at H = 7, the reduced widths and R + r off the MMA's 8, and MLA
   flash at the deepseek forward's shape and the same odd widths; then
   times the row softmax on one-CTA-a-row, cluster-split and staged rows
   against the kernel it replaced (``PARENT_SOFTMAX_MS``), and drives it
   through its entry point, ``EngineContext.activate(x, "softmax")``, on
   lm_head-wide rows, profiled: its one launch is the cluster
   instantiation and the profile shows ``af_softmax_cluster_kernel``;
3. serves full-width olmo-1b (16 layers, ``dtype="float32"``, seeded random
   weights) through ``BatchedServer`` in prepared kernel mode, each prefill
   bucket and each decode burst one captured CUDA graph: checks the launch
   counts exactly (``graph_accounting``: each graph's launches by
   instantiation, counted by the wrappers at capture, times its replays,
   against what the shapes imply; one replay and one transfer a prefill and
   a burst) and that a repeat run (no launch issued from the host), the
   uncaptured yardstick (``capture=False``: the same programs, every launch
   issued from the host) and a captured ``burst=1`` run give identical
   greedy streams and f32 top-2 margins; reports tokens/s, time to first
   token and inter-token latency, each graph's capture time and the graph
   pool's GiB; in the profiled repeat, by the wrappers' counts, every GQA
   attention launch of a prefill bucket of 16 rows or more ran the
   tensor-core instantiation and every other one the split keys, and the
   profile shows each of those kernels and no other of the port's; then
   runs the cache-free ``forward`` on the same weights at batch (2, 512)
   under ``attn_impl="flash"`` (the flash kernel) and ``"xla"``, with launch
   counts by instantiation (every fused launch, M = 1024, on wgmma, every
   flash launch on the tensor cores), a profiled repeat and the logits of
   the two compared; serves the same weights sampled (temperature 1.3,
   ``serve_sampled``): streams identical captured and uncaptured (margins
   too), at burst 1 and 8, alone and batched, and unlike the greedy ones;
   and, on reduced olmo-1b (``replay_order``), captures the graphs while
   serving one order of requests and replays them for two other orders,
   each bitwise equal to the uncaptured run of the same order;
4. serves olmo-1b widths at 4 layers (``PER_CALL_LAYERS``) prepared, as in
   3, and the same model and weights per call (``prepare_weights=False``:
   every dot re-rounds its raw weight and runs the MAC-array kernel, the
   gate its activation through the multi-AF kernel), captured as in 3, and
   checks its streams and top-2 margins against that prepared run's, bit
   for bit, at burst 8 and burst 1 and uncaptured, with its own launch
   counts; times the per-call weight rounding;
5. runs the startup calibration scan (``calibration_scan``: per call,
   ``"flash"``, batch (2, 512), one forward per engine-dot group) on
   full-width olmo-1b, turns it into a policy with ``assign_depths``, and
   serves the request set prepared under it (mixed-depth points), captured
   as in 3, repeat, uncaptured and ``burst=1`` streams identical; one scan
   forward is profiled again (every MAC and flash launch on the
   tensor-core instantiations, by the wrappers' counts);
6. serves olmo-1b widths at 2 layers on the card and on the CPU (plain
   versions) with the same weights, and checks the streams are identical;
   the same per call, at reduced width; and runs the 2-layer ``forward``
   on the card and the CPU: the flash kernel on the forward's own inputs
   must equal the plain version within its tolerance, and the logits'
   agreement is reported under ``"flash"`` and ``"xla"``;
7. and 8. do the same for full-width deepseek-v3 (MLA + MoE, served
   captured as in 3) cut to 4 layers (the 3 dense-prefix layers and 1 MoE
   layer: the routed experts alone take 45 GB in f32), its ``forward`` at
   (1, 512) on the serving weights (the MLA flash kernel), every MLA cache
   and MLA flash launch on the tensor-core instantiation; and for reduced
   deepseek-v3 card vs CPU, served and through ``forward`` (the MLA flash
   kernel held as above);
9. serves the other transformer archs at stock widths as 3 serves olmo-1b
   (``arch_phases``: captured, repeat, profiled, uncaptured and burst 1,
   streams and margins bitwise, launch counts exact), their GQA with 5
   (qwen2.5-14b, llama4), 4 (qwen3-8b), 8 (yi-9b) and 2 (internvl2-2b)
   head groups: qwen2.5-14b cut to 8 layers and its ``forward`` at
   (1, 512); internvl2-2b at 12 of its 24 layers, also sampled (its
   vocabulary of 92553 is odd), and its ``forward`` on 256 stub frontend
   embeddings and 256 tokens; qwen3-8b and yi-9b at 2 layers;
   llama4-maverick at 2 layers (one interleaved dense/MoE pair) with 64 of
   its 128 routed experts (``ARCH_LAYERS``, ``weight_reckoning``: 42.5 GB of
   f32 at set-up) and its ``forward`` at (1, 512); then reduced llama4 card
   vs CPU, served;
10. serves the recurrent and encoder-decoder archs at stock widths as 3
   serves olmo-1b (``scan_phases``), each prompt prefilled through the scan
   (a captured single-token step replayed once per prompt token, then a
   captured finish: one transfer a prefill), the exact launch gates counting
   those replays: mamba2-780m (48 layers, also sampled), zamba2-7b (18 of 81
   layers: two groups of nine Mamba2 layers and the shared attention block,
   GQA at head_dim 112) and seamless-m4t-large-v2 (24 + 24 layers); their
   ``forward`` on the serving weights (mamba2 and zamba2 at (1, 512), two SSD
   chunks; seamless on 512 stub frames and 256 tokens, its encoder's flash
   launches non-causal); then each reduced card vs CPU, served (zamba2 at
   d_model 448: head_dim 112). Its kernel rows add GQA and flash at head_dim
   112, non-causal flash, and the new archs' fused shapes;
11. serves full-width olmo-1b from multi-point weight banks, right after
   the accurate-only run of 3 (``adaptive_phases``: the bank approx FxP8,
   accurate FxP8 and hifi FxP16; a controller pinned at each point equals a
   static server of that point's weights, streams and f32 margins bitwise;
   the CLI's flow, cycle budget 0.75, captured = repeat = uncaptured in
   point trajectory, streams, margins and telemetry, the repeat capturing
   nothing and allocating less than a bank; a budget-driven run with the
   margins disarmed switches; ``spec_phases``: greedy self-speculative
   serving, draft_len 4, equals the accurate-only run of 3 bit for bit, as
   does a verify's decode step the token-by-token steps; sampled
   speculation captured = uncaptured; the controller picking the draft
   point), every (program, point) one captured graph, launches exact by
   (program, point) (``program_launches``, ``check_point_replays``), one
   transfer a prefill, a burst and a round; then reduced card vs CPU of
   olmo-1b adaptive and speculative and deepseek-v3 speculative
   (``bank_parity_phases``). Its kernel rows add the fused kernel on the
   hifi point's FxP16 banks at decode and every bucket, inputs whose int32
   sums wrap included (``check_fused_hifi``), at a verify's 20 rows, and GQA
   and MLA at a verify's 5 rows a slot (each GQA and MLA row bitwise its
   single-row call, ``verify_rows_bitwise``).
12. ``resilience_phases``, right after 11: full-width olmo-1b with ``resilience=``,
   ``observer=`` and ``injector=`` attached: the clean run equals the plain
   server's bitwise and writes a checked JSONL and Chrome trace; a NaN
   cache fault leaves the other requests bitwise unchanged (the poisoned
   one as a reduced card-vs-CPU run of the plan); a NaN weight fault on
   one bank point re-captures only that point's graphs; speculation under
   a draft-point fault equals accurate-only serving and a verify fault
   flag quarantines its lane; queue-limit, too_long and deadline shedding;
   kernels 1 and 2 on NaN-poisoned rows against their plain versions
   (``nan_rows_check``). ``spec_bitwise``: greedy speculation equals
   accurate-only serving bitwise on stock-width qwen3-8b (2 layers) and
   deepseek-v3 (4 layers), after the row-stable rmsnorm, MLA key splits and
   f32 products.

``python3 chip_smoke.py --phases bank`` (groups of ``PHASE_GROUPS``) runs
some groups only, with no ``kernels`` and no ``ok`` line.

Exact launch counts come from the kernel wrappers (``repro_torch.kernels.
launch_counts``, by instantiation), never from ``torch.profiler``, which
drops records; a profile is read for times, the device-busy share and
checks that a dropped record cannot fail (no library attention kernel,
library matmuls within the plain products' allowance, each kernel that ran
present and no other). Every phase runs through ``phase``: a failure
prints ``{"failed_phase": ..., "error": ...}`` on stdout, the traceback on
stderr, and the run exits non-zero.

It imports nothing of JAX. It exits non-zero on any failure, and when no CUDA
device is present. A full JSON report goes to ``chiprun_out/chip_smoke.json``.
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 tensor ops/s,
# f32 CUDA-core flop/s. int32 operations/s: 64 int32 lanes per SM (half the
# 128 f32 lanes, no fused multiply-add) x 132 SMs at the 1.98 GHz that gives
# the f32 figure.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
F32_FLOPS_PER_S = 67e12
# dense bf16 on the tensor cores (same data sheet): bounds the work of bf16
# operands, whatever units a kernel runs it on
BF16_FLOPS_PER_S = 989e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# dense TF32 on the tensor cores (NVIDIA H100 SXM data sheet): the 3xTF32
# kernels run three TF32 products for every f32 one (fewer where an operand
# is bf16, whose lo part is 0), so their tensor-core bound is passes x flops
# at this rate, beside the f32-FMA (or bf16) bound
TF32_FLOPS_PER_S = 494.7e12

SLOTS, MAX_LEN, BURST, BUCKET = 4, 512, 8, 512
# the speculative phases' draft length; a verify runs draft_len + 1 query
# rows a slot
DRAFT_LEN = 4
VERIFY_ROWS = SLOTS * (DRAFT_LEN + 1)
PROMPT_LENS = (3, 17, 60, 130, 300, 9)
MAX_NEW = 32
SEED = 0
# (K, N) of every fused dot on the olmo-1b path
FUSED_SHAPES = ((2048, 2048), (2048, 8192), (8192, 2048), (2048, 50304))
# the deepseek-v3 path's new ones: kv_a (N = 576, not a multiple of the
# 128-wide tile), o (K = 16384), q_b (N = 24576), dense down (K = 18432),
# lm_head (N = 129280)
DEEPSEEK_FUSED_SHAPES = ((7168, 576), (16384, 7168), (1536, 24576), (18432, 7168),
                         (7168, 129280))
DEEPSEEK_LAYERS = 4  # the stock 3 dense-prefix layers and 1 MoE layer
# olmo-1b per call (every dot re-rounds its raw weight) cut from 16 to 4
# layers, held against a prepared run at that depth: for the smoke's time,
# since the scan archs' phases (PR 21's 16-layer per-call phase: ~130 s)
PER_CALL_LAYERS = 4
# the other transformer archs, every width stock, f32: qwen2.5-14b cut from 48
# to 8 layers (15.0 GB of f32 weights at set-up), internvl2-2b from 24 to 12
# (for the smoke's time, since the scan archs' phases), qwen3-8b and yi-9b to 2;
# llama4-maverick to 2 layers (one dense/MoE pair) and from 128 routed experts
# to 64: at 128 the routed experts of one MoE layer alone are 128 x 3 x 5120 x
# 8192 x 4 B = 64.4 GB of f32, the embedding and lm_head 8.3 GB more
ARCH_LAYERS = {"qwen2.5-14b": 8, "qwen3-8b": 2, "yi-9b": 2, "internvl2-2b": 12,
               "llama4-maverick-400b-a17b": 2}
LLAMA4_EXPERTS = 64
# (K, N) of their new fused dots: qwen2.5's lm_head (N = 152064) and down
# projection (K = 13824), internvl2's lm_head over an odd vocabulary
# (N = 92553: rows of 370212 bytes, no multiple of 16), llama4's lm_head
ARCH_FUSED_SHAPES = (("qwen2.5-14b", (5120, 152064)), ("internvl2-2b", (2048, 92553)),
                     ("qwen2.5-14b", (13824, 5120)), ("llama4-maverick-400b-a17b", (5120, 202048)))
# the cache-free forwards on the serving weights: internvl2's 256 tokens after
# its 256 stub frontend embeddings
ARCH_FORWARD = {"qwen2.5-14b": (1, BUCKET), "internvl2-2b": (1, 256),
                "llama4-maverick-400b-a17b": (1, BUCKET)}
# GQA head groups of the new archs on the cache and flash kernels: 5
# (qwen2.5-14b and llama4, H40/KV8) and 8 (yi-9b, H32/KV4)
ARCH_HEADS = ((40, 8), (32, 4))
# the recurrent and encoder-decoder archs, every width stock, f32, prefilled
# through the scan (one single-token step a prompt token): mamba2-780m at all
# 48 layers; zamba2-7b cut from 81 to 18 layers, two groups of nine Mamba2
# layers with the shared block applied twice (1.84 B params, 7.35 GB of f32;
# all 81 would be 6.75 B and 27.0 GB, which fits one card: the cut is for the
# smoke's time only); seamless-m4t-large-v2 at all 24 + 24 layers
SCAN_ARCH_LAYERS = {"mamba2-780m": None, "zamba2-7b": 18, "seamless-m4t-large-v2": None}
# every fused dot (K, N) of their main paths and the activations each runs:
# mamba2's in_proj, out_proj and lm_head; zamba2's in_proj and out_proj, its
# shared block's q/k/v/o, GLU up and gate (swish) and down, and its lm_head;
# seamless's q/k/v/o (self and cross, encoder and decoder), its ReLU MLP's up
# and down, and its lm_head over 256206 (rows of 1024800 bytes)
SCAN_FUSED_SHAPES = (("mamba2-780m", (1536, 6448), ("identity",)),
                     ("mamba2-780m", (3072, 1536), ("identity",)),
                     ("mamba2-780m", (1536, 50280), ("identity",)),
                     ("zamba2-7b", (3584, 14576), ("identity",)),
                     ("zamba2-7b", (7168, 3584), ("identity",)),
                     ("zamba2-7b", (3584, 3584), ("identity",)),
                     ("zamba2-7b", (3584, 14336), ("identity", "swish")),
                     ("zamba2-7b", (14336, 3584), ("identity",)),
                     ("zamba2-7b", (3584, 32000), ("identity",)),
                     ("seamless-m4t-large-v2", (1024, 1024), ("identity",)),
                     ("seamless-m4t-large-v2", (1024, 8192), ("identity", "relu")),
                     ("seamless-m4t-large-v2", (8192, 1024), ("identity",)),
                     ("seamless-m4t-large-v2", (1024, 256206), ("identity",)))
# the cache-free forwards on the serving weights: mamba2 and zamba2 over two
# SSD chunks of 256; seamless over 512 stub frames (pooled to 256) and 256
# decoder tokens
SCAN_FORWARD = {"mamba2-780m": (1, BUCKET), "zamba2-7b": (1, BUCKET),
                "seamless-m4t-large-v2": (1, 256)}
SEAMLESS_FRAMES = 512
# the requests of a scan arch's profiled repeat (prompts 3, 17 and 9): every
# prompt token is a replayed step of ~2000 kernels at mamba2's depth, and the
# whole request set's 519 steps would be a million profiler records
SCAN_PROFILE_RIDS = (0, 1, 5)
# the serving CLI's --cycle-reduction default, for the calibrated policy
CYCLE_REDUCTION = 0.33
# resilience_phases' reduced card-vs-CPU run: a logit limit that flags some
# lanes mid-stream on the scaled_init weights
RESILIENCE_LIMIT = 0.8
# the yardstick the card vs CPU logits of the cache-free forward are reported
# against (test_torch_serving's LOGIT_TOL)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", file=sys.stderr, flush=True)


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


_SIDE_STREAM = []


def graph_ms(fn, iters: int) -> float:
    """Mean device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's time between launches is not counted. Warm-up
    and capture run on one side stream for the whole script (a library's
    per-stream workspace, cuBLAS's, would otherwise be kept for each new
    stream)."""
    import torch

    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
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


def bound_tf32(bytes_moved: float, flops: float, passes: float = 3.0) -> float:
    """The least ms of an attention run on the TF32 tensor cores with
    ``passes`` TF32 products per multiply-add (3 for f32 operands split into
    hi + lo): the larger of its bytes and its TF32 flops."""
    return max(bytes_moved / HBM_BYTES_PER_S, passes * flops / TF32_FLOPS_PER_S) * 1e3


# name fragments of library matmul / attention kernels. No serving path may
# launch a library attention kernel; library matmuls are allowed only for the
# plain products the reference leaves to XLA (see serve_full_width).
GEMM_KERNELS = ("gemm", "cublas", "cutlass")
ATTENTION_KERNELS = ("fmha", "flash", "attention_kernel", "sdpa")
# cuBLAS launches per plain product allowed: the GEMM and at most one split-K
# reduction
CUBLAS_LAUNCHES_PER_PRODUCT = 2
# the __global__ each kernel instantiation launches (``repro_torch.kernels``'
# ``launch_counts`` keys), as the profiler names it
GLOBALS = {
    "fused_dot_af/narrow": "fused_dot_af_narrow_kernel",
    "fused_dot_af/wgmma": "fused_dot_af_wgmma_kernel",
    "fused_dot_af/imad": "fused_dot_af_imad_kernel",
    "cordic_mac/narrow": "mac_matmul_narrow_kernel",
    "cordic_mac/wgmma": "mac_matmul_wgmma_kernel",
    "cordic_mac/imad": "mac_matmul_imad_kernel",
    "gqa_decode_attention/tc": "gqa_decode_tc_kernel",
    "gqa_decode_attention/split": "gqa_decode_split_kernel",
    "mla_decode_attention/tc": "mla_decode_tc_kernel",
    "af_elementwise/elementwise": "af_elementwise_kernel",
    "af_softmax/cluster": "af_softmax_cluster_kernel",
    "flash_attention/tc": "flash_attention_tc_kernel",
    "mla_flash_attention/tc": "mla_flash_tc_kernel",
}
# the __global__ names of the port's kernels, as the profiler reports them:
# each instantiation's, the fused wgmma path's quantize pass and the split
# merge of the cache attentions
PORT_KERNELS = tuple(GLOBALS.values()) + ("fused_quantize_x_kernel", "merge_splits_kernel")


def path_name(p) -> str:
    """The path of an ``int_dot.plan``, with its tile (wgmma: 128 x width) or
    its K split (narrow, imad), as the kernel rows record it."""
    from repro_torch.kernels.int_dot import PATH_NAMES

    name = PATH_NAMES[p.path]
    return f"{name} 128x{p.config}" if name == "wgmma" else f"{name}, {p.splits} K splits"


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


def library_kernels(rows, fragments) -> list:
    """``(name, calls)`` of the kernels in a breakdown whose names hold one of
    ``fragments`` (``GEMM_KERNELS`` or ``ATTENTION_KERNELS``). The port's own
    kernels (``PORT_KERNELS``) are dropped first, whatever their names hold."""
    return [(k, n) for _, k, n in rows
            if not any(p in k for p in PORT_KERNELS) and any(f in k.lower() for f in fragments)]


def port_kernel_ms(rows) -> dict:
    """Device ms and calls of the port's own kernels in a breakdown, by kernel."""
    out = {}
    for us, k, n in rows:
        name = next((f for f in PORT_KERNELS if f in k), None)
        if name:
            ms, calls = out.get(name, (0.0, 0))
            out[name] = (ms + us / 1e3, calls + n)
    return {k: dict(device_ms=ms, calls=n) for k, (ms, n) in out.items()}


# the attention instantiations: GQA's tensor-core path (S >= 16) and its
# split keys (S < 16), the MLA cache attention's tensor-core loop (every S),
# flash and MLA flash
ATTENTION_INSTANTIATIONS = ("gqa_decode_attention/tc", "gqa_decode_attention/split",
                            "flash_attention/tc", "mla_decode_attention/tc",
                            "mla_flash_attention/tc")


def tensor_core_launches(label, counts: dict, prefix: str, want: int) -> dict:
    """Launches by instantiation of the fused (``prefix="fused_dot_af"``) or
    MAC (``"cordic_mac"``) kernel, from the wrappers' counts (``counts``:
    ``launch_counts()`` or a graph's products), in a run whose dots all have
    M > 16: exactly ``want``, every one the wgmma instantiation."""
    from repro_torch.kernels.int_dot import PATH_NAMES

    calls = {path: counts.get(f"{prefix}/{path}", 0) for path in PATH_NAMES}
    if calls != {"narrow": 0, "wgmma": want, "imad": 0}:
        raise AssertionError(f"{label}: {prefix} launches by instantiation {calls}; at M > 16 "
                             f"all {want} must run the wgmma kernel")
    return calls


def attention_launches(label, counts: dict, want: dict) -> dict:
    """Launches of the attention kernels by instantiation, from the wrappers'
    counts: each of ``ATTENTION_INSTANTIATIONS`` exactly as ``want`` (what
    the shapes imply); any other count fails."""
    calls = {name: counts.get(name, 0) for name in ATTENTION_INSTANTIATIONS}
    if calls != {name: want.get(name, 0) for name in ATTENTION_INSTANTIATIONS}:
        raise AssertionError(f"{label}: attention launches by instantiation {calls}, the "
                             f"shapes imply {want}")
    return calls


def profile_names(label, rows, ran: dict) -> dict:
    """Presence and absence by kernel name in a profile whose window ran the
    port's kernels ``ran`` (flat counts by instantiation, from the wrappers):
    every instantiation that ran shows its ``__global__`` at least once, and
    none that did not run shows at all. The profiler may drop records (it
    listed 27 of 29 fused launches of a deepseek forward at times), so no
    count is read from it; a dropped record can fail neither check unless
    every record of a kernel is dropped. Returns the calls seen, by
    instantiation."""
    seen = {key: sum(n for _, k, n in rows if name in k) for key, name in GLOBALS.items()}
    missing = [key for key, n in ran.items() if n and not seen[key]]
    stray = [key for key, n in seen.items() if n and not ran.get(key)]
    if missing or stray:
        raise AssertionError(f"{label}: the profile lacks {missing} and shows {stray} that "
                             f"did not run (wrappers {ran}, profile {seen})")
    return {k: n for k, n in seen.items() if n}


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


def int_mm_ms(x, banks, iters: int) -> dict:
    """``torch._int_mm`` (the yardstick, int8 x and the dot alone) on the
    K-major banks and on N-major copies of them (PR 14's yardstick), or None
    where it does not apply (M <= 16, K or N not a multiple of 8)."""
    import torch

    m, k = x.shape
    n = banks[0].shape[1]
    if m <= 16 or k % 8 or n % 8 or x.dtype != torch.int8:
        return dict(k_major=None, n_major=None)
    n_major = [b.contiguous() for b in banks]
    it = iter(range(1 << 30))
    out = dict(k_major=graph_ms(lambda: torch._int_mm(x, banks[next(it) % len(banks)]), iters),
               n_major=graph_ms(lambda: torch._int_mm(x, n_major[next(it) % len(banks)]),
                                iters))
    del n_major
    return out


def fused_bound(m: int, k: int, n: int, af: str, af_depth: int, fmt, w_bytes: int = 1):
    """The fused dot+AF's least time: the larger of its bytes (x f32, the
    bank, the point, out f32), its multiply-adds (int8: two operations each
    on the tensor cores; int16, which no tensor core takes: one int32
    multiply-add instruction each on the CUDA cores) and, past identity, the
    CORDIC epilogue's int32 operations on every output."""
    from repro_torch.core.activations import internal_depth

    t_bytes, _ = bound(m * k * 4 + k * n * w_bytes + m * n * 4 + 20, 0.0, INT8_OPS_PER_S)
    t_mma = (2.0 * m * n * k / INT8_OPS_PER_S if w_bytes == 1
             else 1.0 * m * n * k / INT32_OPS_PER_S) * 1e3
    t_af = 0.0
    if af != "identity":
        t_af = af_int_ops(af, internal_depth(af_depth, fmt)) * m * n / INT32_OPS_PER_S * 1e3
    return max((t_bytes, "bytes"), (t_mma, "operations"), (t_af, "operations (AF int32)"))


def check_fused(device):
    import torch

    from repro_torch.core import FXP8, FXP16
    from repro_torch.kernels.cordic_fused import FUSED_AFS, fused_dot_af, fused_dot_af_ref
    from repro_torch.kernels.int_dot import plan

    gen = torch.Generator(device=device).manual_seed(SEED)
    rows, max_err = [], 0.0
    # decode, the 16-, 32- and 64-row serving buckets (the narrow loop up to
    # 16 rows, the tensor cores above), a speculative verify's rows, the
    # largest bucket, the forward's M (2 x 512 tokens)
    shapes = ([("olmo-1b", kn, (SLOTS, 16, VERIFY_ROWS, 32, 64, BUCKET, 2 * BUCKET))
               for kn in FUSED_SHAPES]
              + [("deepseek-v3-671b", kn, (SLOTS, BUCKET)) for kn in DEEPSEEK_FUSED_SHAPES]
              + [(arch, kn, (SLOTS, BUCKET)) for arch, kn in ARCH_FUSED_SHAPES])
    shapes = ([(name, kn, ms_, ("identity", "swish")) for name, kn, ms_ in shapes]
              + [(arch, kn, (SLOTS, BUCKET), afs) for arch, kn, afs in SCAN_FUSED_SHAPES])
    for model_name, (k, n), ms_, afs in shapes:
        banks = prepared_weight(k, n, FXP8, gen, device,
                                copies=max(1, min(48, math.ceil(3e8 / (k * n)))))
        for m in ms_:
            x = torch.randn((m, k), generator=gen, device=device)
            xq = torch.clamp(torch.round(x * 64), -128, 127).to(torch.int8)
            iters = 60 if m <= 32 else 20
            lib = int_mm_ms(xq, [b.data for b in banks], iters)
            for af in afs:
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
                ms = graph_ms(call, iters)
                eager_ms = timed_ms(call, iters)
                plain_ms = timed_ms(lambda: fused_dot_af_ref(x, w.data, w.point, **kw),
                                    iters=5, warmup=1)
                b_ms, b_by = fused_bound(m, k, n, af, FXP8.frac + 1, FXP8)
                path = path_name(plan(m, n, k))
                lib_ms = lib if af == "identity" else dict(k_major=None, n_major=None)
                rows.append(dict(model=model_name, M=m, K=k, N=n, af=af, fmt="fxp8", path=path,
                                 bitwise_equal=True, max_abs_err=err, ms=ms, eager_ms=eager_ms,
                                 plain_ms=plain_ms, int_mm_ms=lib_ms["k_major"],
                                 int_mm_n_major_ms=lib_ms["n_major"], bound_ms=b_ms,
                                 bound_by=b_by))
                log(f"fused {model_name} M={m} K={k} N={n} {af} [{path}]: {ms:.4f} ms (eager "
                    f"{eager_ms:.4f}, plain {plain_ms:.3f}, int_mm K-major {lib_ms['k_major']} "
                    f"N-major {lib_ms['n_major']}, bound {b_ms:.4f} {b_by})")
        del banks
    # every AF mode, compute_round, at one shape on each path: FxP8 at decode
    # (narrow) and a serving bucket (wgmma), FxP16 (the CUDA-core loop)
    k, n = 2048, 2048
    for fmt, m in ((FXP8, SLOTS), (FXP8, 64), (FXP16, SLOTS)):
        x = torch.randn((m, k), generator=gen, device=device) * 2.0
        x[0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
        w = prepared_weight(k, n, fmt, gen, device)[0]
        for af in FUSED_AFS:
            for compute_round in (False, True):
                kw = dict(af_mode=af, af_depth=fmt.frac + 1, af_fmt=fmt,
                          compute_round=compute_round)
                got = fused_dot_af(x, w.data, w.point, **kw)
                want = fused_dot_af_ref(x, w.data, w.point, **kw)
                if not torch.equal(got, want):
                    raise AssertionError(f"fused_dot_af != plain: {fmt} M={m} {af} "
                                         f"compute_round={compute_round}")
        rows.append(dict(M=m, K=k, N=n, af="all 7", fmt=str(fmt), compute_round="both",
                         path=path_name(plan(m, n, k, w.data.element_size(),
                                             w.data.element_size())),
                         nan_inf_in_x=True, bitwise_equal=True))
    torch.cuda.synchronize()
    return rows, max_err


# the hifi point's dots (FxP16 banks, the int32 CUDA-core loop) at decode and
# at every prefill bucket the requests fall in: each of the loop's tile
# configs (M <= 8, <= 32, above)
HIFI_MS = (SLOTS, 16, 32, 64, 256, BUCKET)


def check_fused_hifi(device):
    """The fused dot+AF on FxP16 banks, as the adaptive bank's hifi point
    launches it (x quantized at FxP16, the AF epilogue at the serving
    context's FxP8 depth), against its plain version, bitwise, at olmo-1b's
    shapes, identity and swish, for every ``HIFI_MS``; and at decode and
    the largest bucket on inputs whose int32 sums wrap modulo 2^32, as the
    reference's do. Times, bounds (an int16 multiply-add one CUDA-core int32
    instruction) and the launches' path."""
    import torch

    from repro_torch.core import FXP8, FXP16
    from repro_torch.kernels.cordic_fused import fused_dot_af, fused_dot_af_ref
    from repro_torch.kernels.int_dot import plan

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    rows, max_err = [], 0.0
    for k, n in FUSED_SHAPES:
        banks = prepared_weight(k, n, FXP16, gen, device,
                                copies=max(1, min(24, math.ceil(3e8 / (2 * k * n)))))
        w = banks[0]
        for m in HIFI_MS:
            for scale, afs in ((1.0, ("identity", "swish")), (1e3, ("identity",))):
                if scale > 1.0 and m not in (SLOTS, BUCKET):
                    continue
                x = torch.randn((m, k), generator=gen, device=device) * scale
                for af in afs:
                    kw = dict(af_mode=af, af_depth=FXP8.frac + 1, af_fmt=FXP8)
                    got = fused_dot_af(x, w.data, w.point, **kw)
                    want = fused_dot_af_ref(x, w.data, w.point, **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"fused_dot_af FxP16 != plain at M={m} K={k} N={n} "
                                             f"af={af} x scale {scale}: "
                                             f"{(got != want).sum().item()} elements differ")
                    row = dict(model="olmo-1b hifi", M=m, K=k, N=n, af=af, fmt="fxp16",
                               x_scale=scale, path=path_name(plan(m, n, k, 2, 2)),
                               bitwise_equal=True, max_abs_err=0.0)
                    if scale == 1.0:
                        iters = 30 if m <= 32 else 10
                        it = iter(range(1 << 30))
                        call = lambda: fused_dot_af(  # noqa: E731
                            x, banks[next(it) % len(banks)].data, w.point, **kw)
                        b_ms, b_by = fused_bound(m, k, n, af, FXP8.frac + 1, FXP8, w_bytes=2)
                        row.update(ms=graph_ms(call, iters), eager_ms=timed_ms(call, iters),
                                   plain_ms=timed_ms(lambda: fused_dot_af_ref(
                                       x, w.data, w.point, **kw), iters=3, warmup=1),
                                   bound_ms=b_ms, bound_by=b_by)
                        log(f"fused FxP16 M={m} K={k} N={n} {af} [{row['path']}]: "
                            f"{row['ms']:.4f} ms (eager {row['eager_ms']:.4f}, plain "
                            f"{row['plain_ms']:.3f}, bound {b_ms:.4f} {b_by})")
                    rows.append(row)
        del banks
    torch.cuda.synchronize()
    return rows, max_err


def plan_alternatives(device):
    """``int_dot.plan``'s choices against the alternatives, on the same inputs
    (each bitwise equal to the plain version): the narrow loop against wgmma
    at decode and up to its 16 rows, and 128- against 256-wide wgmma tiles
    at the largest bucket's and the forward's M."""
    import torch

    from repro_torch.core import FXP8
    from repro_torch.kernels import int_dot
    from repro_torch.kernels.cordic_fused import fused_dot_af, fused_dot_af_ref, ops

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    rows = []
    for k, n in FUSED_SHAPES + DEEPSEEK_FUSED_SHAPES[-1:]:
        banks = prepared_weight(k, n, FXP8, gen, device,
                                copies=max(1, min(48, math.ceil(3e8 / (k * n)))))
        for m in (SLOTS, 8, int_dot.NARROW_MAX_M, BUCKET, 2 * BUCKET):
            if m > int_dot.NARROW_MAX_M:
                plans = {f"wgmma 128x{bn}": int_dot.Plan(int_dot.WGMMA, bn, 1, k,
                                                         int_dot.WGMMA_BM, bn)
                         for bn in int_dot.WGMMA_BNS}
            else:
                plans = {"narrow": int_dot._narrow_plan(m, n, k),
                         "wgmma": int_dot._wgmma_plan(m, n, k)}
            x = torch.randn((m, k), generator=gen, device=device)
            times = {}
            for label, p in plans.items():
                ops.plan = lambda *a, p=p: p  # noqa: E731
                try:
                    w = banks[0]
                    if not torch.equal(fused_dot_af(x, w.data, w.point),
                                       fused_dot_af_ref(x, w.data, w.point)):
                        raise AssertionError(f"plan {label} != plain at M={m} K={k} N={n}")
                    it = iter(range(1 << 30))
                    times[label] = graph_ms(lambda: fused_dot_af(
                        x, banks[next(it) % len(banks)].data, w.point), 40)
                finally:
                    ops.plan = int_dot.plan
            chosen = path_name(int_dot.plan(m, n, k))
            rows.append(dict(M=m, K=k, N=n, chosen=chosen, ms=times))
            log(f"plan M={m} K={k} N={n}: chosen {chosen}; {times}")
        del banks
    return rows


def attention_case(b, s, t, h, kv, hd, gen, device, start=None):
    """Seeded q, caches and positions of one GQA cache-attention shape: a
    decode step at the cache's last row (S = 1), a prefill bucket from row 0
    (start = 0), or a run from a random row."""
    import torch

    q = torch.randn((b, s, h, hd), generator=gen, device=device)
    ck = torch.randn((b, t, kv, hd), generator=gen, device=device)
    cv = torch.randn((b, t, kv, hd), generator=gen, device=device)
    if s == 1:
        pos = torch.full((b, 1), t - 1, dtype=torch.int32, device=device)
    else:
        first = (torch.zeros((b, 1), dtype=torch.int64, device=device) if start is not None
                 else torch.randint(0, t - s + 1, (b, 1), generator=gen, device=device))
        pos = (first + torch.arange(s, device=device)[None]).to(torch.int32)
    return q, ck, cv, pos


def attention_bounds(q, kv: int, t: int, pos):
    """(f32-FMA bound ms, by, 3xTF32 bound ms) of one GQA cache-attention
    call: the keys this run's positions need (each batch row's K/V up to its
    last query position, each query row's scores up to its own)."""
    b, s, h, hd = q.shape
    rows_needed = (pos.max(dim=1).values + 1).clamp(max=t).sum().item()
    nbytes = rows_needed * kv * hd * 4 * 2 + 2 * q.numel() * 4 + pos.numel() * 4
    flops = 4.0 * h * hd * (pos.long() + 1).clamp(max=t).sum().item()
    b_ms, b_by = bound(nbytes, flops, F32_FLOPS_PER_S)
    return b_ms, b_by, bound_tf32(nbytes, flops)


def check_attention(device):
    """The GQA cache attention against its plain version: decode (B4 S1,
    split keys), the serving prefill buckets 16, 64 and 512 from row 0 and a
    burst of 4 (the tensor-core path from S = 16 on, split keys below), with
    GQA groups of 1 and 2 (olmo-1b widths), 5 (H40/KV8) and 8 (H32/KV4), and
    at head_dim 112 (zamba2, H32/KV32) and 64 (seamless, H16/KV16); each
    row records its path and splits, the f32-FMA and 3xTF32 bounds and
    SDPA's time."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        TOLERANCE, gqa_decode_attention, gqa_decode_attention_ref)
    from repro_torch.kernels.decode_attention.ops import gqa_plan

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    cases = [  # (B, S, T, H, KV, hd, start)
        (SLOTS, 1, MAX_LEN, 16, 16, 128, None),
        (1, BUCKET, MAX_LEN, 16, 16, 128, None),
        (SLOTS, 1, MAX_LEN, 16, 8, 128, None),
        (2, 4, MAX_LEN, 16, 8, 128, None),
        (1, 16, MAX_LEN, 16, 16, 128, 0),
        (1, 64, MAX_LEN, 16, 16, 128, 0),
    ]
    # the new archs' head groups: decode, a burst of 4 and the prefill
    # buckets 16, 64 and 512 from row 0
    for h, kv in ARCH_HEADS:
        cases += [(SLOTS, 1, MAX_LEN, h, kv, 128, None), (2, 4, MAX_LEN, h, kv, 128, None),
                  (1, 16, MAX_LEN, h, kv, 128, 0), (1, 64, MAX_LEN, h, kv, 128, 0),
                  (1, BUCKET, MAX_LEN, h, kv, 128, 0)]
    # zamba2's shared attention, H32/KV32 at head_dim 112: decode, a burst of 4
    # and the prefill buckets 16, 64 and 512 from row 0
    cases += [(SLOTS, 1, MAX_LEN, 32, 32, 112, None), (2, 4, MAX_LEN, 32, 32, 112, None),
              (1, 16, MAX_LEN, 32, 32, 112, 0), (1, 64, MAX_LEN, 32, 32, 112, 0),
              (1, BUCKET, MAX_LEN, 32, 32, 112, 0)]
    # seamless's decoder self-attention, H16/KV16 at head_dim 64 (split keys,
    # two dims a lane): decode and a burst of 4
    cases += [(SLOTS, 1, MAX_LEN, 16, 16, 64, None), (2, 4, MAX_LEN, 16, 16, 64, None)]
    # a speculative verify at olmo-1b widths: draft_len + 1 rows a slot
    cases += [(SLOTS, DRAFT_LEN + 1, MAX_LEN, 16, 16, 128, None)]
    rows, max_err = [], 0.0
    for b, s, t, h, kv, hd, start in cases:
        q, ck, cv, pos = attention_case(b, s, t, h, kv, hd, gen, device, start)
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
        b_ms, b_by, b3_ms = attention_bounds(q, kv, t, pos)
        path, splits = gqa_plan(b, s, h, t, kv)
        rows.append(dict(B=b, S=s, T=t, H=h, KV=kv, hd=hd, positions="from row 0" if start == 0
                         else "decode" if s == 1 else "run from a random row", path=path,
                         splits=splits, tolerance=TOLERANCE, max_abs_err=err, ms=ms,
                         eager_ms=eager_ms, plain_ms=plain_ms, sdpa_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by, bound_tf32_ms=b3_ms, tf32_passes=3))
        log(f"attn B={b} S={s} T={t} H={h} KV={kv} [{path}, {splits} splits]: {ms:.4f} ms "
            f"(eager {eager_ms:.4f}, plain {plain_ms:.3f}, sdpa {lib_ms:.4f}, bound "
            f"{b_ms:.4f} {b_by}, 3xTF32 {b3_ms:.4f}) err {err:.2e}")
    rows.append(verify_rows_bitwise(device, gen))
    return rows, max_err


def verify_rows_bitwise(device, gen) -> dict:
    """A speculative verify's GQA call (B4, draft_len + 1 rows a slot, split
    keys) gives each query row the bits that the single-row call of its
    position gives, at verify windows that cross 128 and 256 keys (where a
    partition of the block's visible key tiles would regroup a row's keys):
    greedy speculation's bit identity with token-by-token decoding rests on
    it."""
    import torch

    from repro_torch.kernels.decode_attention import gqa_decode_attention
    from repro_torch.kernels.decode_attention.ops import gqa_plan

    from repro_torch.kernels.decode_attention import mla_decode_attention
    from repro_torch.kernels.decode_attention.ops import mla_splits

    b, s, h, kv, hd = SLOTS, DRAFT_LEN + 1, 16, 16, 128
    q, ck, cv, _ = attention_case(b, s, MAX_LEN, h, kv, hd, gen, device)
    starts = torch.tensor([125, 253, 30, 380], dtype=torch.int32, device=device)[:b, None]
    pos = (starts + torch.arange(s, dtype=torch.int32, device=device)[None]).contiguous()

    def rows_equal(name, call, args, split_at):
        block = call(*args)
        for j in range(s):
            alone = call(*(split_at(a, j) for a in args))
            if not torch.equal(alone[:, 0], block[:, j]):
                raise AssertionError(f"{name}: verify row {j} differs from its single-row "
                                     f"call: {(alone[:, 0] - block[:, j]).abs().max()}")

    one = lambda a, j: a[:, j:j + 1].contiguous() if a.shape[1] == s else a  # noqa: E731
    rows_equal("gqa_decode_attention",
               lambda *a: gqa_decode_attention(*a, scale=1.0 / math.sqrt(hd)),
               (q, ck, cv, pos), one)
    # the MLA cache attention at deepseek-v3's widths (H128, R512, r64)
    mh, r, rd = 128, 512, 64
    mla_args = (torch.randn((b, s, mh, r), generator=gen, device=device),
                torch.randn((b, s, mh, rd), generator=gen, device=device),
                torch.randn((b, MAX_LEN, r), generator=gen, device=device),
                torch.randn((b, MAX_LEN, rd), generator=gen, device=device), pos)
    rows_equal("mla_decode_attention",
               lambda *a: mla_decode_attention(*a, scale=1.0 / math.sqrt(128 + rd)),
               mla_args, lambda a, j: one(a, j) if a.dim() != 3 else a)
    return dict(B=b, S=s, T=MAX_LEN, H=h, KV=kv, hd=hd, positions="verify windows from rows "
                f"{starts[:, 0].tolist()}", path=gqa_plan(b, s, h, MAX_LEN, kv).path,
                splits=gqa_plan(b, s, h, MAX_LEN, kv).splits,
                mla=dict(H=mh, R=r, r=rd, splits=mla_splits(b, s, mh, MAX_LEN)),
                rows_equal_single_row_calls=True)


def gqa_path_alternatives(device):
    """``gqa_plan``'s threshold against the alternative, on the same inputs
    (each within TOLERANCE of the plain version): the split-key path and the
    tensor-core path at decode (B4 S1), at the prefill buckets 4 to 64 from
    row 0 (few keys), and at bursts of 4, 8 and 16 rows on four slots from a
    random row (a long key range: what the split path is built for), olmo-1b
    widths."""
    import torch

    from repro_torch.kernels.decode_attention import (
        TOLERANCE, gqa_decode_attention, gqa_decode_attention_ref, ops)

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    rows, planned = [], ops.gqa_plan
    for b, s, start in ((SLOTS, 1, None), (1, 4, 0), (1, 8, 0), (1, 16, 0), (1, 32, 0),
                        (1, 64, 0), (SLOTS, 4, None), (SLOTS, 8, None), (SLOTS, 16, None)):
        q, ck, cv, pos = attention_case(b, s, MAX_LEN, 16, 16, 128, gen, device, start)
        scale = 1.0 / math.sqrt(128)
        want = gqa_decode_attention_ref(q, ck, cv, pos, scale=scale)
        times = {}
        for path in (ops.SPLIT_KEYS, ops.TENSOR_CORES):
            splits = ops.gqa_splits(b, s, 16, MAX_LEN, 16) if path == ops.SPLIT_KEYS else 1
            ops.gqa_plan = lambda *a, p=ops.GqaPlan(path, splits): p  # noqa: E731
            try:
                err = (gqa_decode_attention(q, ck, cv, pos, scale=scale) - want).abs().max()
                if not err.item() <= TOLERANCE:
                    raise AssertionError(f"gqa path {path} vs plain: {err.item()} at S={s}")
                times[path] = graph_ms(lambda: gqa_decode_attention(q, ck, cv, pos,
                                                                    scale=scale), 100)
            finally:
                ops.gqa_plan = planned
        chosen = ops.gqa_plan(b, s, 16, MAX_LEN, 16).path
        positions = "decode" if s == 1 else "from row 0" if start == 0 else "from a random row"
        rows.append(dict(B=b, S=s, T=MAX_LEN, positions=positions, chosen=chosen, ms=times))
        log(f"gqa plan B={b} S={s} ({positions}): chosen {chosen}; {times}")
    return rows


def check_mla(device):
    """The MLA cache attention against its plain version: deepseek-v3 widths
    (H 128, R 512, r 64) at decode (B4 S1, the key splits merged) and at the
    serving prefill buckets 16, 64 and 512 from row 0; a run from a random
    row at H = 7 over a ragged T, the reduced config's widths (H 4, R 16,
    r 8) and widths off the MMA's 8 (R 12, r 8), each with a drained slot
    (pos >= T) and a masked row (pos < 0); each row records its key splits,
    the f32-FMA and 3xTF32 bounds and SDPA's time."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (
        TOLERANCE, mla_decode_attention, mla_decode_attention_ref)
    from repro_torch.kernels.decode_attention.ops import mla_splits

    m = get_config("deepseek-v3-671b").mla
    h, r, rd = get_config("deepseek-v3-671b").num_heads, m.kv_lora_rank, m.qk_rope_head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    cases = [  # (B, S, T, H, R, r, start): decode, prefill from row 0, runs from a random row
        (SLOTS, 1, MAX_LEN, h, r, rd, None), (1, 16, MAX_LEN, h, r, rd, 0),
        (1, 64, MAX_LEN, h, r, rd, 0), (1, BUCKET, MAX_LEN, h, r, rd, 0),
        (3, 5, 100, 7, r, rd, "random"), (3, 2, 33, 4, 16, 8, "random"),
        (2, 5, 45, 7, 12, 8, "random"),
        # a speculative verify on deepseek-v3: draft_len + 1 rows a slot
        (SLOTS, DRAFT_LEN + 1, MAX_LEN, h, r, rd, None)]
    rows, max_err = [], 0.0
    for b, s, t, hh, rr, rrd, start in cases:
        scale = 1.0 / math.sqrt(m.qk_nope_head_dim + rd) if rr == r else 1.0 / math.sqrt(rr + rrd)
        ql = torch.randn((b, s, hh, rr), generator=gen, device=device)
        qr = torch.randn((b, s, hh, rrd), generator=gen, device=device)
        ck = torch.randn((b, t, rr), generator=gen, device=device)
        kr = torch.randn((b, t, rrd), generator=gen, device=device)
        if s == 1:
            pos = torch.full((b, 1), t - 1, dtype=torch.int32, device=device)
        else:
            first = (torch.zeros((b, 1), dtype=torch.int64, device=device) if start == 0 else
                     torch.randint(0, t - s + 1, (b, 1), generator=gen, device=device))
            pos = (first + torch.arange(s, device=device)[None]).to(torch.int32)
        if start == "random":
            pos[0, -1] = t + 7  # a drained slot
            pos[-1, 0] = -1  # a masked row: every key weighs 1 / T
        args = (ql, qr, ck, kr, pos)
        got = mla_decode_attention(*args, scale=scale)
        want = mla_decode_attention_ref(*args, scale=scale)
        err = (got - want).abs().max().item()
        if not err <= TOLERANCE:
            raise AssertionError(f"mla_decode_attention vs plain: max|diff| {err} > {TOLERANCE} "
                                 f"at B={b} S={s} T={t} H={hh} R={rr} r={rrd}")
        max_err = max(max_err, err)
        call = lambda: mla_decode_attention(*args, scale=scale)  # noqa: E731
        ms = graph_ms(call, 20 if s > 64 else 100)
        eager_ms = timed_ms(call, 20)
        plain_ms = timed_ms(lambda: mla_decode_attention_ref(*args, scale=scale), iters=5)
        # yardstick: SDPA on the concatenation form, the latent K/V shared by
        # every head: q_cat = [q_lat, q_rope], k_cat = [c_kv, k_rope], v = c_kv
        q_cat = torch.cat([ql, qr], -1).transpose(1, 2).contiguous()
        k_cat = torch.cat([ck, kr], -1)[:, None]
        v = ck[:, None]
        mask = (torch.arange(t, device=device)[None, None, :] <= pos[:, :, None])[:, None]
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            q_cat, k_cat, v, attn_mask=mask, scale=scale, enable_gqa=True), 20)
        # what this run's positions need: each batch row's latent rows up to
        # its last query position, each query row's scores up to its own; a
        # masked row (pos < 0) needs no score but the mean of every c_kv row
        seen = (pos.long() + 1).clamp(min=0, max=t)
        mean = torch.where(pos < 0, t, seen)
        rows_qk, rows_v = seen.max(dim=1).values, mean.max(dim=1).values
        flops = 2.0 * hh * (seen.sum().item() * (rr + rrd) + mean.sum().item() * rr)
        nbytes = (rows_qk.sum().item() * (rr + rrd) + (rows_v - rows_qk).sum().item() * rr
                  + ql.numel() + qr.numel() + got.numel()) * 4
        b_ms, b_by = bound(nbytes + pos.numel() * 4, flops, F32_FLOPS_PER_S)
        positions = ("decode" if s == 1 else "from row 0" if start == 0
                     else "from a random row, a drained slot and a masked row")
        rows.append(dict(B=b, S=s, T=t, H=hh, R=rr, r=rrd, positions=positions,
                         splits=mla_splits(b, s, hh, t), tolerance=TOLERANCE, max_abs_err=err,
                         ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, sdpa_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         bound_tf32_ms=bound_tf32(nbytes + pos.numel() * 4, flops),
                         tf32_passes=3))
        log(f"mla B={b} S={s} T={t} H={hh} R={rr} r={rrd} ({positions}): {ms:.4f} ms (eager "
            f"{eager_ms:.4f}, plain {plain_ms:.3f}, sdpa {lib_ms:.4f}, bound {b_ms:.4f} {b_by}) "
            f"err {err:.2e}")
    return rows, max_err


def causal_pairs(b: int, sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs a causal (or full) attention of one head scores."""
    if not causal:
        return b * sq * sk
    return b * sum(min(i + 1, sk) for i in range(sq))


def check_flash(device):
    """The cache-free flash attention against its plain version: olmo-1b
    widths (H 16, D 128) at the forward phase's B2 S512 and at B1 S2048,
    GQA (KV 4), a ragged S, bf16 in and out (both round an f32 result that
    agrees within TOLERANCE: at most one bf16 step apart, 2^-7 of the
    value), H40/KV8 (5 groups) at B1 S512, zamba2's head_dim 112 (H32) at
    B1 S512 causal and not, and seamless's non-causal encoder (H16 at
    head_dim 64 over its 256 pooled frames) and causal decoder (256
    tokens); each row records the f32-FMA bound (bf16: the bf16 tensor-core
    rate), the TF32 tensor-core bound for the passes the kernel runs (3, or
    1.5 with bf16 operands) and SDPA's time."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (TOLERANCE, flash_attention,
                                                     flash_attention_ref)

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    cases = [  # (B, S, H, KV, D, dtype, causal)
        (2, BUCKET, 16, 16, 128, torch.float32, True),
        (1, 2048, 16, 16, 128, torch.float32, True),
        (2, BUCKET, 16, 4, 128, torch.float32, True),
        (2, 70, 16, 16, 128, torch.float32, True),
        (2, BUCKET, 16, 16, 128, torch.bfloat16, True),
        (1, BUCKET, 40, 8, 128, torch.float32, True),  # qwen2.5-14b and llama4's forward
        (1, BUCKET, 32, 32, 112, torch.float32, True),  # zamba2's forward
        (1, 256, 16, 16, 64, torch.float32, False),  # seamless's encoder (pooled frames)
        (1, 256, 16, 16, 64, torch.float32, True),  # seamless's decoder forward
        (1, BUCKET, 32, 32, 112, torch.float32, False),
    ]
    rows, max_err = [], 0.0
    for b, s, h, kv, d, dtype, causal in cases:
        q = torch.randn((b, s, h, d), generator=gen, device=device).to(dtype)
        k = torch.randn((b, s, kv, d), generator=gen, device=device).to(dtype)
        v = torch.randn((b, s, kv, d), generator=gen, device=device).to(dtype)
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        if dtype == torch.float32:
            tol = f"{TOLERANCE} absolute"
            if not err <= TOLERANCE:
                raise AssertionError(f"flash_attention vs plain: max|diff| {err} > {TOLERANCE} "
                                     f"at B={b} S={s} H={h} KV={kv} D={d}")
            max_err = max(max_err, err)
        else:
            tol = f"one bf16 step (2^-7 of the value) + {TOLERANCE}"
            if not (diff <= want.float().abs() * 2.0**-7 + TOLERANCE).all():
                raise AssertionError(f"flash_attention bf16 vs plain: max|diff| {err} past one "
                                     f"rounding step at B={b} S={s}")
        ms = graph_ms(lambda: flash_attention(q, k, v, causal=causal), 20)
        plain_ms = timed_ms(lambda: flash_attention_ref(q, k, v, causal=causal), iters=3,
                            warmup=1)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        if kv != h:
            kt, vt = kt.repeat_interleave(h // kv, 1), vt.repeat_interleave(h // kv, 1)
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
                          20)
        elem = q.element_size()
        pairs = h * causal_pairs(b, s, s, causal)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * elem
        # bf16 operands: bounded at the bf16 tensor-core rate; on the TF32
        # units the kernel runs one pass for Q.K^T (both bf16) and two for
        # P.V (P is f32 and split, V is bf16)
        bf16 = dtype == torch.bfloat16
        b_ms, b_by = bound(nbytes, 4.0 * d * pairs, BF16_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S)
        passes = 1.5 if bf16 else 3.0
        b3_ms = bound_tf32(nbytes, 4.0 * d * pairs, passes)
        rows.append(dict(B=b, S=s, H=h, KV=kv, D=d, dtype=str(dtype).removeprefix("torch."),
                         causal=causal, tolerance=tol, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         sdpa_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bound_tf32_ms=b3_ms,
                         tf32_passes=passes))
        log(f"flash B={b} S={s} H={h} KV={kv} D={d} {dtype} causal={causal}: {ms:.4f} ms (plain "
            f"{plain_ms:.3f}, "
            f"sdpa {lib_ms:.4f}, bound {b_ms:.4f} {b_by}, TF32 x{passes} {b3_ms:.4f}) "
            f"err {err:.2e}")
    return rows, max_err


def check_mla_flash(device):
    """The cache-free MLA flash attention against its plain version:
    deepseek-v3 widths (H 128, R 512, r 64) at the forward phase's B1 S512,
    a ragged S, H = 7, the reduced config's (H 4, R 16, r 8) and widths off
    the MMA's 8 (R 12, r 8)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.mla_flash import (TOLERANCE, mla_flash_attention,
                                               mla_flash_attention_ref)

    full, small = get_config("deepseek-v3-671b"), reduced(get_config("deepseek-v3-671b"))
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    rows, max_err = [], 0.0
    for cfg, b, s, heads, widths in ((full, 1, BUCKET, None, None), (full, 2, 70, None, None),
                                     (full, 2, 70, 7, None), (small, 2, 70, None, None),
                                     (small, 2, 45, 7, (12, 8))):
        m, h = cfg.mla, heads or cfg.num_heads
        r, rd = widths or (m.kv_lora_rank, m.qk_rope_head_dim)
        scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
        ql = torch.randn((b, s, h, r), generator=gen, device=device)
        qr = torch.randn((b, s, h, rd), generator=gen, device=device)
        ck = torch.randn((b, s, r), generator=gen, device=device)
        kr = torch.randn((b, s, rd), generator=gen, device=device)
        args = (ql, qr, ck, kr)
        got = mla_flash_attention(*args, scale=scale)
        want = mla_flash_attention_ref(*args, scale=scale)
        err = (got - want).abs().max().item()
        if not err <= TOLERANCE:
            raise AssertionError(f"mla_flash_attention vs plain: max|diff| {err} > {TOLERANCE} "
                                 f"at B={b} S={s} H={h} R={r}")
        max_err = max(max_err, err)
        ms = graph_ms(lambda: mla_flash_attention(*args, scale=scale), 10)
        plain_ms = timed_ms(lambda: mla_flash_attention_ref(*args, scale=scale), iters=3,
                            warmup=1)
        # yardstick: SDPA on the concatenation form, the latent K/V shared by
        # every head: q_cat = [q_lat, q_rope], k_cat = [c_kv, k_rope], v = c_kv
        q_cat = torch.cat([ql, qr], -1).transpose(1, 2).contiguous()
        k_cat = torch.cat([ck, kr], -1)[:, None]
        v = ck[:, None]
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            q_cat, k_cat, v, is_causal=True, scale=scale, enable_gqa=True), 10)
        pairs = h * causal_pairs(b, s, s, True)
        nbytes = (ql.numel() + qr.numel() + ck.numel() + kr.numel() + got.numel()) * 4
        b_ms, b_by = bound(nbytes, 2.0 * pairs * (r + rd + r), F32_FLOPS_PER_S)
        rows.append(dict(B=b, S=s, H=h, R=r, r=rd, causal=True, tolerance=TOLERANCE,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, sdpa_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         bound_tf32_ms=bound_tf32(nbytes, 2.0 * pairs * (r + rd + r)),
                         tf32_passes=3))
        log(f"mla_flash B={b} S={s} H={h} R={r} r={rd}: {ms:.4f} ms (plain {plain_ms:.3f}, sdpa "
            f"{lib_ms:.4f}, bound {b_ms:.4f} {b_by}) err {err:.2e}")
    return rows, max_err


def af_int_ops(mode: str, depth: int) -> int:
    """int32 operations per element of the multi-AF block at internal depth
    ``depth``, counted from its CORDIC loops: a hyperbolic (exp) iteration is
    2 shifts, 3 adds and a select, a linear divide iteration 2 shifts, 2 adds
    and 2 compares, a linear multiply iteration 2 shifts, 2 adds and a
    compare; the quantize/requantize/dequantize chain and each loop's setup
    about a dozen more."""
    exp = 6 * depth + 12
    div, mul = 6 * depth, 5 * depth
    chain = 12
    sigmoid = exp + div + 4
    per_mode = {
        "relu": 1,
        "tanh": exp + div + 6,
        "sigmoid": sigmoid,
        "swish": sigmoid + mul + 2,
        "gelu": 5 * mul + exp + div + 12,
        "selu": exp + 2 * mul + 4,
    }
    return chain + per_mode[mode]


def check_af(device):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import FXP8, FXP16
    from repro_torch.core.activations import internal_depth
    from repro_torch.core.cordic import full_depth
    from repro_torch.kernels.cordic_af import ELEMENTWISE_AFS, multi_af, multi_af_ref

    moe = get_config("deepseek-v3-671b").moe
    e, k, f = moe.num_experts, moe.top_k, moe.d_ff_expert
    prefill_c = max(k, math.ceil(BUCKET * k / e * moe.capacity_factor))
    # the routed experts' gate (B, E, C, F): dropless decode has C = top_k
    shapes = {"decode": (SLOTS, e, k, f), "prefill": (1, e, prefill_c, f)}
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    rows = []
    for where, shape in shapes.items():
        x = torch.randn(shape, generator=gen, device=device) * 2.0
        n = x.numel()
        for fmt in (FXP8, FXP16):
            depth = full_depth(fmt)
            for mode in ELEMENTWISE_AFS:
                got = multi_af(x, mode, depth=depth, fmt=fmt)
                want = multi_af_ref(x, mode, depth=depth, fmt=fmt)
                if not torch.equal(got, want):
                    bad = (got != want).sum().item()
                    raise AssertionError(f"af_elementwise != plain: {where} {fmt} {mode}: "
                                         f"{bad} elements differ")
                call = lambda: multi_af(x, mode, depth=depth, fmt=fmt)  # noqa: E731
                ms = graph_ms(call, 20)
                plain_ms = timed_ms(lambda: multi_af_ref(x, mode, depth=depth, fmt=fmt),
                                    iters=3, warmup=1)
                ops = af_int_ops(mode, internal_depth(depth, fmt))
                b_ms, b_by = bound(8.0 * n, float(ops) * n, INT32_OPS_PER_S)
                rows.append(dict(where=where, shape=list(shape), fmt=str(fmt), depth=depth,
                                 mode=mode, bitwise_equal=True, max_abs_err=0.0, ms=ms,
                                 plain_ms=plain_ms, int_ops_per_element=ops, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None))
                log(f"af {where} {shape} {fmt} {mode}: {ms:.4f} ms (plain {plain_ms:.3f}, "
                    f"bound {b_ms:.4f} {b_by})")
    return rows


def mac_banks(m: int, k: int, n: int, gen, device, copies: int = 1):
    """The per-call path's operands of one random (M, K) x (K, N) dot at FxP8
    accurate: x quantized, ``copies`` signed-digit weight banks, the scales."""
    import torch

    from repro_torch.core import FXP8, FXP8_UNIT
    from repro_torch.kernels.cordic_mac import quantize_activations, quantize_weights

    x_q, xs = quantize_activations(torch.randn((m, k), generator=gen, device=device), FXP8)
    banks = [quantize_weights(torch.randn((k, n), generator=gen, device=device) * 0.3,
                              FXP8_UNIT.frac + 1, FXP8_UNIT) for _ in range(copies)]
    x_scale = torch.full((m, 1), xs, device=device)
    w_scale = torch.full((1, n), banks[0][1], device=device)
    return x_q, [w_q for w_q, _ in banks], x_scale, w_scale


def check_mac(device):
    """The MAC-array matmul against its plain version, bitwise: the per-call
    olmo-1b shapes on each of its paths (decode and the 16-row bucket on the
    narrow loop; the 32- and 64-row buckets, the largest bucket and the
    calibration forward's M on the tensor cores), an odd shape, the fused
    ReLU, and FxP16 int16 operands whose int32 accumulator overflows."""
    import torch

    from repro_torch.kernels.int_dot import to_k_major

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    # decode (SLOTS rows), the 16- and 32-row prefill buckets (prompts 9 and
    # 17), a 64-row bucket, the largest bucket and the calibration's 2 x 512
    cases = [(m, k, n, False) for k, n in FUSED_SHAPES
             for m in (SLOTS, 16, 32, 64, BUCKET, 2 * BUCKET)]
    cases += [(3, 1000, 300, False), (100, 1000, 300, False), (SLOTS, 2048, 2048, True),
              (BUCKET, 2048, 2048, True)]
    rows = []
    for m, k, n, relu in cases:
        x_q, banks, x_scale, w_scale = mac_banks(
            m, k, n, gen, device, copies=max(1, min(48, math.ceil(3e8 / (k * n)))))
        rows.append(time_mac(f"fxp8{' relu' if relu else ''}", x_q, banks, x_scale, w_scale,
                             relu))
        del banks
    # FxP16: Q3.12 activations near +8 against Q1.14 weights near +2 sum past 2^31
    m, k, n = SLOTS, 8192, 2048
    x_q = torch.randint(30000, 32768, (m, k), generator=gen, device=device).to(torch.int16)
    banks = [to_k_major(torch.randint(24000, 32768, (k, n), generator=gen,
                                      device=device).to(torch.int16))
             for _ in range(18)]  # 18 x 33.6 MB: cold weights, as the other shapes
    exact = x_q[:1].double() @ banks[0][:, :8].double()
    if not (exact.abs() >= 2**31).all():
        raise AssertionError("the FxP16 case does not overflow the int32 accumulator")
    rows.append(time_mac("fxp16 int16, int32 overflow", x_q, banks,
                         torch.full((m, 1), 2.0**-12, device=device),
                         torch.full((1, n), 2.0**-14, device=device), False))
    torch.cuda.synchronize()
    return rows


def time_mac(label, x_q, banks, x_scale, w_scale, relu):
    """One bitwise check and the timings of one MAC-array shape."""
    import torch

    from repro_torch.kernels.cordic_mac import mac_matmul, mac_matmul_ref
    from repro_torch.kernels.int_dot import plan

    m, k = x_q.shape
    n = banks[0].shape[1]
    got = mac_matmul(x_q, banks[0], x_scale, w_scale, fuse_relu=relu)
    want = mac_matmul_ref(x_q, banks[0], x_scale, w_scale, fuse_relu=relu)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        raise AssertionError(f"cordic_mac != plain at M={m} K={k} N={n} {label}: "
                             f"{bad} elements differ")
    it = iter(range(1 << 30))
    call = lambda: mac_matmul(x_q, banks[next(it) % len(banks)], x_scale, w_scale,  # noqa: E731
                              fuse_relu=relu)
    iters = 60 if m <= 32 else 20
    ms = graph_ms(call, iters)
    eager_ms = timed_ms(call, iters)
    plain_ms = timed_ms(lambda: mac_matmul_ref(x_q, banks[0], x_scale, w_scale, fuse_relu=relu),
                        iters=5, warmup=1)
    lib = int_mm_ms(x_q, banks, iters) if not relu else dict(k_major=None, n_major=None)
    elem = x_q.element_size()
    b_ms, b_by = bound(m * k * elem + k * n * elem + (m + n) * 4 + m * n * 4, 2.0 * m * n * k,
                       INT8_OPS_PER_S)
    path = path_name(plan(m, n, k, elem, banks[0].element_size()))
    log(f"mac {label} M={m} K={k} N={n} [{path}]: {ms:.4f} ms (eager {eager_ms:.4f}, plain "
        f"{plain_ms:.3f}, int_mm K-major {lib['k_major']} N-major {lib['n_major']}, bound "
        f"{b_ms:.4f} {b_by})")
    return dict(M=m, K=k, N=n, case=label, path=path, bitwise_equal=True, max_abs_err=0.0,
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, int_mm_ms=lib["k_major"],
                int_mm_n_major_ms=lib["n_major"], bound_ms=b_ms, bound_by=b_by)


def softmax_int_ops(depth: int) -> int:
    """int32 operations per element of the row softmax at internal depth
    ``depth``, counted as the function needs them (once per element, as
    ``af_int_ops`` counts them): the quantize/requantize/dequantize chain,
    the CORDIC exp and divide loops, the shift, the two reductions' adds and
    compares."""
    return 12 + (6 * depth + 12) + 6 * depth + 8


# (rows, n) of the softmax rows, each at FxP8 and FxP16: the softmax path's
# lm_head-wide logits (SLOTS, 50304) and one such row, one CTA a row at
# (64, 512), (5, 300), (4096, 64) and (7, 17), and a row past the shared
# memory the kernel may hold a slice in (the staged path)
SOFTMAX_SHAPES = ((64, 512), (5, 300), (SLOTS, 50304), (1, 50304), (4096, 64), (7, 17),
                  (2, 1_000_000))
# ms of the one-512-thread-block-a-row kernel this one replaced, at full
# depth on the same rows: the mean of two runs of benchmarks/softmax_probe.py
# on that kernel's tree (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6); each
# row reports its time against it
PARENT_SOFTMAX_MS = {
    ((64, 512), "Q1.6"): 0.00322272002696991, ((64, 512), "Q3.12"): 0.0035219199955463408,
    ((5, 300), "Q1.6"): 0.003114879876375198, ((5, 300), "Q3.12"): 0.003193439990282059,
    ((4, 50304), "Q1.6"): 0.11401328086853027, ((4, 50304), "Q3.12"): 0.13146992206573488,
    ((1, 50304), "Q1.6"): 0.11399232387542725, ((1, 50304), "Q3.12"): 0.13167232036590576,
    ((4096, 64), "Q1.6"): 0.022293279170989992, ((4096, 64), "Q3.12"): 0.023763359785079957,
    ((7, 17), "Q1.6"): 0.0027953599393367766, ((7, 17), "Q3.12"): 0.002890239953994751,
    ((2, 1_000_000), "Q1.6"): 2.222646427154541, ((2, 1_000_000), "Q3.12"): 2.5610936164855955,
}


def check_softmax(device):
    """The row softmax against its plain version, bitwise, at full depth; each
    row records the launch plan (cluster size, slice, threads, path) and its
    time against the one-block-a-row kernel it replaced."""
    import torch

    from repro_torch.core import FXP8, FXP16
    from repro_torch.core.activations import internal_depth, internal_fmt, softmax_shift
    from repro_torch.core.cordic import full_depth
    from repro_torch.kernels.cordic_af import af_softmax, af_softmax_ref
    from repro_torch.kernels.cordic_af.ops import launch_plan

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    rows = []
    for shape in SOFTMAX_SHAPES:
        x = torch.randn(shape, generator=gen, device=device) * 3.0
        plan = launch_plan(*shape, device)
        for fmt in (FXP8, FXP16):
            depth = full_depth(fmt)
            got = af_softmax(x, depth=depth, fmt=fmt)
            want = af_softmax_ref(x, depth=depth, fmt=fmt)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).sum().item()
                raise AssertionError(f"af_softmax != plain at {shape} {fmt}: {bad} elements "
                                     "differ")
            ms = graph_ms(lambda: af_softmax(x, depth=depth, fmt=fmt),
                          20 if x.numel() > 1e6 else 100)
            plain_ms = timed_ms(lambda: af_softmax_ref(x, depth=depth, fmt=fmt), iters=3,
                                warmup=1)
            ops = softmax_int_ops(internal_depth(depth, fmt))
            b_ms, b_by = bound(8.0 * x.numel(), float(ops) * x.numel(), INT32_OPS_PER_S)
            shift = softmax_shift(shape[1], internal_fmt(fmt).frac)
            parent_ms = PARENT_SOFTMAX_MS[(shape, str(fmt))]
            rows.append(dict(shape=list(shape), fmt=str(fmt), depth=depth, pre_shift=shift,
                             cluster=plan.cluster, planned_cluster=plan.planned_cluster,
                             slice=plan.slice, threads=plan.threads, path=plan.path,
                             bitwise_equal=True, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                             parent_ms=parent_ms, speedup_vs_parent=parent_ms / ms,
                             int_ops_per_element=ops, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None))
            log(f"softmax {shape} {fmt} shift {shift}, cluster {plan.cluster} {plan.path}: "
                f"{ms:.4f} ms (parent {parent_ms:.4f}, plain {plain_ms:.3f}, bound {b_ms:.4f} "
                f"{b_by})")
    return rows


def softmax_path(device):
    """The softmax's entry point: ``EngineContext.activate(x, "softmax")`` in
    kernel mode on lm_head-wide logits rows, profiled, with the launch count
    of its kernel read just after, held against the plain version: exactly
    one launch, of the cluster instantiation, by the wrappers' counts; the
    profile shows that kernel and no other of the port's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.cordic_af import af_softmax_ref
    from repro_torch.kernels.cordic_af.ops import launch_plan

    ctx = kernel_ctx()
    x = torch.randn((SLOTS, 50304), generator=torch.Generator(device=device).manual_seed(SEED),
                    device=device) * 3.0
    kernels = zero_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = ctx.activate(x, "softmax")
        torch.cuda.synchronize()
    launches = {name: w.launches for name, w in kernels.items()}
    counts = wrapper_counts()
    if counts != {**{key: 0 for key in counts}, "af_softmax/cluster": 1}:
        raise AssertionError(f"activate(x, 'softmax') launched {counts}")
    rows = kernel_breakdown(prof)
    profile_names("activate(x, 'softmax')", rows, counts)
    by_name = port_kernel_ms(rows)
    if list(by_name) != ["af_softmax_cluster_kernel"]:
        raise AssertionError(f"activate(x, 'softmax') ran port kernels {by_name}; the one "
                             "launch must be af_softmax_cluster_kernel")
    lp = ctx.layer_precision("af")
    if not torch.equal(got, af_softmax_ref(x, depth=int(lp.depth), fmt=lp.fmt)):
        raise AssertionError("activate(x, 'softmax') != the plain version")
    plan = launch_plan(*x.shape, device)
    return dict(entry="EngineContext(mode='kernel').activate(x, 'softmax')",
                shape=list(x.shape), launches=launches, port_kernels=by_name,
                cluster=plan.cluster, path=plan.path, bitwise_equal=True)


# ---------------------------------------------------------------------------
# phases 3-4: serving
# ---------------------------------------------------------------------------


def olmo(layers=None):
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("olmo-1b"), dtype="float32")
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def deepseek():
    """Full-width deepseek-v3 at 4 layers, f32 (the stock bf16 config does
    not trace with an f32 context in the reference). At the repo's random
    init, N(0, 0.02^2), its greedy streams settle on one token, so the
    serving checks also hold the f32 top-2 logit margins bit for bit, and
    the reduced card-vs-CPU phase serves varied streams."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-v3-671b"), dtype="float32",
                               num_layers=DEEPSEEK_LAYERS)


def arch_config(name: str):
    """One of the other transformer archs at stock widths, f32, with its
    depth cut to ``ARCH_LAYERS`` and llama4's routed experts to
    ``LLAMA4_EXPERTS`` (``weight_reckoning`` gives the bytes)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(name), dtype="float32")
    if ARCH_LAYERS[name]:
        cfg = dataclasses.replace(cfg, num_layers=ARCH_LAYERS[name])
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               num_experts=LLAMA4_EXPERTS))
    return cfg


def weight_reckoning(cfg) -> dict:
    """Parameters (billions) and GB of the f32 parameter tree ``cfg`` builds
    at set-up (from its specs), the parameters at the stock depth, and for an
    MoE config the routed experts' GB a MoE layer, at the config's expert
    count and at the stock one."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.params import spec_leaves

    def params(c):
        return sum(math.prod(s.shape) for _, s in spec_leaves(get_model(c).specs()))

    stock = dataclasses.replace(cfg, num_layers=get_config(cfg.name).num_layers)
    out = dict(layers=cfg.num_layers, stock_layers=stock.num_layers, params_b=params(cfg) / 1e9,
               f32_weights_gb=params(cfg) * 4 / 1e9, params_b_at_stock_depth=params(stock) / 1e9)
    if cfg.moe is not None:
        per_expert = 3 * cfg.d_model * cfg.moe.d_ff_expert * 4 / 1e9
        stock = get_config(cfg.name).moe.num_experts
        out.update(experts=cfg.moe.num_experts, stock_experts=stock,
                   routed_experts_gb_per_moe_layer=cfg.moe.num_experts * per_expert,
                   stock_routed_experts_gb_per_moe_layer=stock * per_expert)
    return out


def kernel_ctx(attn_impl: str = "decode_kernel", policy=None):
    import torch

    from repro_torch.core import FXP8, EngineContext, PrecisionPolicy

    return EngineContext(mode="kernel", policy=policy or PrecisionPolicy.accurate(FXP8),
                         compute_dtype=torch.float32, attn_impl=attn_impl)


def requests(cfg, lens=None, max_new=None):
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(SEED)
    return [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new or MAX_NEW) for i, n in enumerate(lens or PROMPT_LENS)]


def margins(reqs) -> list:
    """Each request's top-2 logit margins, in request order."""
    return [r.margins for r in reqs]


def zero_launches() -> dict:
    """name -> wrapper of every kernel a path may launch, every count (in all
    and by instantiation) set to 0."""
    from repro_torch.kernels import reset_launch_counts, wrappers

    reset_launch_counts()
    return wrappers()


def wrapper_counts() -> dict:
    """The wrappers' launches by instantiation since ``zero_launches``, flat
    (``"<kernel>/<instantiation>"``)."""
    from repro_torch.kernels import launch_counts

    return launch_counts()


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def check_launches(label, kernels, want: dict, times: int = 1) -> dict:
    """Launch counts by kernel (``kernels``: the wrappers, read since
    ``zero_launches``, or a name -> count dict): each kernel exactly as the
    shapes imply, ``times`` forwards, and any other kernel never."""
    launches = {name: getattr(w, "launches", w) for name, w in kernels.items()}
    for name, count in launches.items():
        if count != want.get(name, 0) * times:
            raise AssertionError(f"{label}: {name}: {count} launches, the shapes imply "
                                 f"{want.get(name, 0) * times}")
    return {name: launches[name] for name in want}


def check_instantiations(label, counts: dict, want: dict) -> dict:
    """Launch counts by instantiation (flat), exactly ``want``."""
    if nonzero(counts) != nonzero(want):
        raise AssertionError(f"{label}: launches by instantiation {nonzero(counts)}, the "
                             f"shapes imply {nonzero(want)}")
    return nonzero(counts)


def moe_layers(cfg) -> int:
    """The MoE layers of ``cfg``: every layer past the dense prefix, or one
    of each interleaved (dense, MoE) pair."""
    if cfg.moe is None:
        return 0
    return (cfg.num_layers - cfg.moe.first_dense_layers) // cfg.moe.moe_every


def scan_prefill(cfg) -> bool:
    """Whether ``cfg``'s server prefills through the scan (one single-token
    decode step a prompt token) rather than one forward over a bucket: the
    engine's own rule."""
    from repro_torch.serve.engine import prefills_batched

    return not prefills_batched(cfg)


def hybrid_groups(cfg) -> int:
    return cfg.num_layers // cfg.hybrid.attn_every


def launches_per_forward(cfg, per_call: bool = False) -> dict:
    """Kernel launches one decode forward of ``cfg`` implies, by kernel. Per
    call, every dot is a MAC-array launch and the gate's activation its own
    multi-AF launch. A Mamba2 layer runs two fused dots (in_proj, out_proj);
    zamba2's shared block seven (q k v o, up gate down) and one GQA launch a
    group; a seamless decoder layer eight (self q k v o, cross q o: the
    cross K/V are cached, up down) and one GQA launch (cross-attention is
    plain)."""
    if cfg.family == "ssm":
        return {"fused_dot_af": 2 * cfg.num_layers + 1}
    if cfg.family == "hybrid":
        groups = hybrid_groups(cfg)
        return {"fused_dot_af": 2 * cfg.num_layers + 7 * groups + 1,
                "gqa_decode_attention": groups}
    if cfg.family == "audio":
        return {"fused_dot_af": 8 * cfg.num_layers + 1, "gqa_decode_attention": cfg.num_layers}
    if cfg.moe is None and per_call:
        return {"cordic_mac": 7 * cfg.num_layers + 1, "af_elementwise": cfg.num_layers,
                "gqa_decode_attention": cfg.num_layers}
    if per_call:
        raise NotImplementedError("per-call serving is driven for the dense family only")
    attention = "mla_decode_attention" if cfg.mla else "gqa_decode_attention"
    if cfg.moe is None:  # dense GQA: q k v o up gate down per layer, and lm_head
        return {"fused_dot_af": 7 * cfg.num_layers + 1, attention: cfg.num_layers}
    moe = moe_layers(cfg)
    # attention: GQA q k v o, MLA q_a q_b kv_a o; dense MLP and shared
    # expert: up gate down; the routed experts' gate activation one multi-AF
    fused = 7 * (cfg.num_layers - moe) + (4 + 3 * bool(cfg.moe.num_shared_experts)) * moe + 1
    return {"fused_dot_af": fused, attention: cfg.num_layers, "af_elementwise": moe}


def forward_launches(cfg, attn_impl: str, per_call: bool = False) -> dict:
    """Kernel launches one cache-free ``forward`` implies: the decode step's
    dots, and under ``"flash"`` one flash (dense) or MLA flash launch per
    attention layer in place of the decode attention; ``"xla"`` runs no
    attention kernel. seamless's forward also projects the cross K/V and
    runs its encoder."""
    if cfg.family == "audio":  # encoder q k v o up down, decoder self and cross q k v o, up down
        enc, dec = cfg.encdec.encoder_layers, cfg.num_layers
        want = {"fused_dot_af": 6 * enc + 10 * dec + 1}
        if attn_impl == "flash":  # the encoder's (non-causal) and the decoder's self-attention
            want["flash_attention"] = enc + dec
        return want
    want = launches_per_forward(cfg, per_call)
    want.pop("gqa_decode_attention", None)
    want.pop("mla_decode_attention", None)
    attention_layers = (0 if cfg.family == "ssm" else hybrid_groups(cfg)
                        if cfg.family == "hybrid" else cfg.num_layers)
    if attn_impl == "flash" and attention_layers:
        want["mla_flash_attention" if cfg.mla else "flash_attention"] = attention_layers
    return want


def by_instantiation(per_kernel: dict, rows: int, s: int, times: int = 1,
                     w_bytes: int = 1) -> dict:
    """``times`` forwards' launches by instantiation (flat), from their count
    by kernel: every dot of a forward runs over ``rows`` token rows, on the
    narrow loop up to ``NARROW_MAX_M`` rows and on the int8 tensor cores
    (wgmma) above (``int_dot.plan``), or on int16 banks (``w_bytes`` 2, an
    FxP16 point) on the CUDA-core loop (imad) at any rows; the GQA cache
    attention of ``s`` query rows a sequence on its tensor cores from
    ``TC_MIN_S`` rows and on split keys below (``gqa_plan``); every other
    kernel has one instantiation."""
    from repro_torch.kernels.decode_attention.ops import TC_MIN_S
    from repro_torch.kernels.int_dot import NARROW_MAX_M

    dot = "imad" if w_bytes > 1 else "narrow" if rows <= NARROW_MAX_M else "wgmma"
    inst = {"fused_dot_af": dot, "cordic_mac": dot, "mla_decode_attention": "tc",
            "gqa_decode_attention": "tc" if s >= TC_MIN_S else "split",
            "af_elementwise": "elementwise", "af_softmax": "cluster", "flash_attention": "tc",
            "mla_flash_attention": "tc"}
    return {f"{k}/{inst[k]}": n * times for k, n in per_kernel.items()}


def add_counts(total: dict, more: dict) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def serving_instantiations(cfg, server, reqs, per_call: bool = False) -> dict:
    """Launches by instantiation that serving ``reqs`` implies: one forward
    per request over its prompt's bucket (the scan: one single-row forward
    per prompt token), and the run's decode steps over the server's slots,
    one query row each."""
    from repro_torch.serve.kvcache import bucket_length

    per_forward = launches_per_forward(cfg, per_call)
    want = by_instantiation(per_forward, server.slots, 1, server.decode_steps)
    if scan_prefill(cfg):
        return add_counts(want, by_instantiation(per_forward, 1, 1,
                                                 sum(len(r.prompt) for r in reqs)))
    for r in reqs:
        b = bucket_length(len(r.prompt), server.max_len)
        add_counts(want, by_instantiation(per_forward, b, b))
    return want


def plain_products_per_forward(cfg, cache_free: bool = False) -> int:
    """Products the reference leaves to XLA outside any kernel, which the port
    leaves to torch.einsum: MLA's wk_b/wv_b absorptions, the MoE router and
    its three expert einsums; a Mamba2 layer's conv window, state update and
    readout at decode, its SSD's four chunk products in a cache-free pass;
    seamless's two cross-attention products a decoder layer."""
    mamba = {"ssm": cfg.num_layers, "hybrid": cfg.num_layers}.get(cfg.family, 0)
    cross = 2 * cfg.num_layers if cfg.family == "audio" else 0
    return (2 * cfg.num_layers * bool(cfg.mla) + 4 * moe_layers(cfg)
            + (4 if cache_free else 3) * mamba + cross)


def model_forwards(server) -> int:
    """The model forwards a run made: prefills (one each when bucketed, one
    per prompt token through the scan), decode steps (a speculative round's
    draft steps among them) and a speculative round's verify."""
    prefill = server.prefill_calls if server.batched_prefill else server.prefill_steps
    return prefill + server.decode_steps + server.spec_rounds


def point_bytes(bank) -> dict:
    """Bytes of a weight integer at each point of ``bank`` (1: int8 FxP8, 2:
    int16 FxP16); every ladder the smoke serves keeps one format a point."""
    from repro_torch.core.backends.base import unit_fmt

    out = {}
    for p in bank.points:
        fmts = {p.policy.default.fmt, *(lp.fmt for lp in p.policy.overrides.values())}
        widths = {unit_fmt(f).storage_dtype.itemsize for f in fmts}
        if len(widths) != 1:
            raise AssertionError(f"point {p.name}: weights of {widths} bytes")
        out[p.name] = widths.pop()
    return out


def program_launches(name: str, server, cfg, per_call: bool = False, widths=None) -> dict:
    """Launches by instantiation that one capture of program ``name``
    implies: a prefill bucket ``b``, one forward over ``b`` rows; the scan
    prefill's step, one forward over one row, its finish none; a burst,
    ``burst`` forwards over the slots; a speculative draft (either variant),
    ``draft_len`` forwards over the slots, its verify one forward of
    ``draft_len + 1`` query rows a slot. A name ``"<program> @<point>"`` runs at that bank
    point, its dots on the banks of ``widths[point]`` bytes."""
    per_forward = launches_per_forward(cfg, per_call)
    base, _, point = name.partition(" @")
    w = (widths or {}).get(point, 1)
    if base.startswith("burst"):
        return by_instantiation(per_forward, server.slots, 1, server.burst, w)
    if base == "prefill step":
        return by_instantiation(per_forward, 1, 1, 1, w)
    if base == "prefill finish":
        return {}
    if base.startswith("draft"):
        return by_instantiation(per_forward, server.slots, 1, server.spec.draft_len, w)
    if base.startswith("verify"):
        s = server.spec.draft_len + 1
        return by_instantiation(per_forward, server.slots * s, s, 1, w)
    b = int(base.split()[-1])
    return by_instantiation(per_forward, b, b, 1, w)


def replays_by_point(runner, program) -> dict:
    """point -> replays of the graphs whose program name starts with
    ``program``, summed over the graphs of a point."""
    out = {}
    for name, n in runner.replays.items():
        base, _, point = name.partition(" @")
        if base.startswith(program):
            out[point] = out.get(point, 0) + n
    return out


def check_point_replays(label, server, reqs) -> dict:
    """A bank server's replays by (program, point), against what its run
    recorded: each prefill bucket as often as the requests' prompts fall in
    it, every prefill at the verify point when speculating; each burst at
    the point the telemetry charged it to; each speculative round one draft
    at the point the round drafted at and one verify at the verify point."""
    from collections import Counter

    from repro_torch.serve.kvcache import bucket_length

    runner = server.programs
    buckets = Counter(f"prefill {bucket_length(len(r.prompt), server.max_len)}" for r in reqs)
    got = Counter()
    for name, n in runner.replays.items():
        base = name.partition(" @")[0]
        if base.startswith("prefill") and base != "prefill step" and base != "prefill finish":
            got[base] += n
    if server.batched_prefill and got != buckets:
        raise AssertionError(f"{label}: prefill replays {dict(got)}, the prompts imply "
                             f"{dict(buckets)}")
    out = {"prefill": replays_by_point(runner, "prefill")}
    if server.spec is not None:
        tele = server.spec_telemetry
        want_draft = nonzero(tele.rounds_by_draft_point)
        out["draft"], out["verify"] = (replays_by_point(runner, "draft"),
                                       replays_by_point(runner, "verify"))
        if out["draft"] != want_draft or out["verify"] != {server.spec.verify_point: tele.rounds}:
            raise AssertionError(f"{label}: draft replays {out['draft']} (rounds {want_draft}), "
                                 f"verify {out['verify']} ({tele.rounds} rounds)")
        if set(out["prefill"]) != {server.spec.verify_point}:
            raise AssertionError(f"{label}: prefills at {out['prefill']}, not the verify point")
    else:
        out["burst"] = replays_by_point(runner, "burst")
        if out["burst"] != nonzero(server.telemetry.steps_by_point):
            raise AssertionError(f"{label}: burst replays by point {out['burst']}, the "
                                 f"telemetry {server.telemetry.steps_by_point}")
    return out


def replayed_launches(runner) -> dict:
    """Launches by instantiation that a run's replays made on the device:
    each graph's launches counted at its capture, times its replays in the
    run."""
    out = {}
    for name, replays in runner.replays.items():
        add_counts(out, {k: v * replays for k, v in runner.captured_launches[name].items()})
    return out


def graph_accounting(label, server, cfg, reqs, per_call: bool = False,
                     captured_before=frozenset(), widths=None) -> tuple:
    """The launch counts of a captured run of ``reqs``, exact, from the
    wrappers. A wrapper counts a launch when the host issues it: in a graph's
    warm-up and at its capture, never at a replay. So:

    * each graph captured in this run (not in ``captured_before``) issued,
      at its capture and again in its warm-up, exactly the launches by
      instantiation that its program implies (``program_launches``; a graph
      of a bank point at that point's weight width, ``widths``);
    * the wrappers' counts since ``zero_launches`` are exactly the sum of
      those warm-ups and captures (nothing else was issued from the host);
    * the launches the replays made on the device, each graph's captured
      launches times its replays, are exactly what serving ``reqs``
      implies: by kernel, the run's forwards; by instantiation, the
      requests' buckets and the decode steps for a server without a bank,
      and for a bank server its replays by (program, point) as its run
      recorded them (``check_point_replays``);
    * every prefill and every burst or speculative round was one replay (a
      round two: its draft and its verify) and one transfer; a scan prefill
      also replayed its step once per prompt token.

    Returns ``(launches by kernel, replayed launches by instantiation)``."""
    from repro_torch.kernels import kernel_totals

    runner = server.programs
    per_forward = launches_per_forward(cfg, per_call)
    issued = {}
    for name, captured in runner.captured_launches.items():
        if name in captured_before:
            continue
        want = program_launches(name, server, cfg, per_call, widths)
        check_instantiations(f"{label}: graph {name!r} at capture", captured, want)
        check_instantiations(f"{label}: graph {name!r} warm-up", runner.warmup_launches[name],
                             want)
        add_counts(issued, {k: 2 * v for k, v in captured.items()})
    check_instantiations(f"{label}: issued from the host (warm-ups and captures)",
                         wrapper_counts(), issued)
    replayed = replayed_launches(runner)
    launches = check_launches(f"{label}: replayed", kernel_totals(replayed), per_forward,
                              times=model_forwards(server))
    if widths is None:
        check_instantiations(f"{label}: replayed", replayed,
                             serving_instantiations(cfg, server, reqs, per_call))
    else:
        check_point_replays(label, server, reqs)
    # one transfer a prefill and a burst or round; one replay each (a round
    # two), and the scan's step once per prompt token besides
    rounds = server.spec_rounds if server.spec is not None else server.decode_steps // server.burst
    transfers = server.prefill_calls + rounds
    replays = transfers + (rounds if server.spec is not None else 0)
    steps = 0 if server.batched_prefill else sum(len(r.prompt) for r in reqs)
    if not (server.host_transfers == transfers and server.prefill_steps == steps
            and server.graph_replays == replays + steps):
        raise AssertionError(f"{label}: {server.graph_replays} graph replays, "
                             f"{server.host_transfers} transfers, {server.prefill_calls} prefills "
                             f"and {rounds} bursts or rounds, {server.prefill_steps} scan steps "
                             f"for {steps} prompt tokens")
    return launches, replayed


def uncaptured_accounting(label, server, cfg, reqs, per_call: bool = False) -> dict:
    """The launch counts of an uncaptured run (every launch issued from the
    host), by kernel and by instantiation, exactly as serving ``reqs``
    implies; no graph replayed."""
    from repro_torch.kernels import kernel_totals

    counts = wrapper_counts()
    launches = check_launches(label, kernel_totals(counts), launches_per_forward(cfg, per_call),
                              times=model_forwards(server))
    check_instantiations(label, counts, serving_instantiations(cfg, server, reqs, per_call))
    if server.graph_replays:
        raise AssertionError(f"{label}: {server.graph_replays} graph replays uncaptured")
    return launches


def latency(server) -> dict:
    """Time to first token and inter-token latency of the last run, ms, from
    each request's emissions (every request arrives at run entry): a burst
    that lands n tokens dt after the request's previous emission gives each
    of them dt / n, as the reference's observer counts it."""
    import numpy as np

    ttft = [em[0][0] * 1e3 for em in server.emissions.values()]
    itl = [(t1 - t0) / n * 1e3 for em in server.emissions.values()
           for (t0, _), (t1, n) in zip(em, em[1:]) for _ in range(n)]
    return dict(ttft_ms_mean=float(np.mean(ttft)), ttft_ms_p50=float(np.median(ttft)),
                ttft_ms_max=float(np.max(ttft)), intertoken_ms_mean=float(np.mean(itl)),
                intertoken_ms_p50=float(np.median(itl)),
                intertoken_ms_p90=float(np.percentile(itl, 90)))


def timed_run(server, reqs):
    """``server.run(reqs)`` with its wall time, tokens/s and latencies."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = server.run(reqs)
    wall = time.perf_counter() - t0
    tokens = sum(len(v) for v in out.values())
    return out, dict(wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
                     prefill_s=server.prefill_seconds, decode_s=server.decode_seconds,
                     decode_ms_per_step=server.decode_seconds / max(server.decode_steps, 1) * 1e3,
                     graph_replays=server.graph_replays, host_transfers=server.host_transfers,
                     **latency(server))


def runtime_launches(prof) -> dict:
    """Host calls that launch device work in a profile, by CUDA API entry
    point (``cudaLaunchKernel``, ``cudaGraphLaunch``, ...): reported, not
    gated."""
    out = {}
    for e in prof.key_averages():
        if "Launch" in e.key and e.key.startswith(("cuda", "cu")):
            out[e.key] = out.get(e.key, 0) + e.count
    return out


def graphs_report(runner) -> dict:
    return {name: dict(captured_launches=runner.captured_launches[name],
                       replays=runner.replays.get(name, 0),
                       capture_s=runner.capture_seconds[name]) for name in runner.graphs}


def serve_full_width(device, label, cfg, prepared_run=None, policy=None):
    """Serve ``cfg`` at full width on the card: the main path (every prefill
    bucket and burst one captured CUDA graph) with exact launch accounting, a
    steady repeat (every graph already captured: tokens/s, TTFT, inter-token
    latency; no launch issued from the host), a profiled repeat, the
    uncaptured yardstick at burst 8 and a captured ``burst=1`` run on the same
    weights. Streams and f32 top-2 margins must be identical, bit for bit,
    across all of them.

    With ``prepared_run`` (the ``(streams, margins)`` that a prepared run of
    the same weights returned) the server runs per call, and every stream
    and top-2 margin must equal the prepared run's bit for bit. ``policy``
    (default: accurate FxP8) is the policy the weights are prepared under.
    Returns ``(report, streams, margins, server weights)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import get_model
    from repro_torch.serve.capture import pool_bytes
    from repro_torch.serve.engine import BatchedServer

    per_call = prepared_run is not None
    model = get_model(cfg)
    start_mem = torch.cuda.memory_allocated()  # left over from earlier phases
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    ctx = kernel_ctx(policy=policy)
    make = lambda burst, capture=True: BatchedServer(  # noqa: E731
        model, ctx, weights, slots=SLOTS, max_len=MAX_LEN, burst=burst, device=device,
        prepare_weights=not per_call, capture=capture)
    server = BatchedServer(model, ctx, params, slots=SLOTS, max_len=MAX_LEN,
                           burst=BURST, device=device, prepare_weights=not per_call)
    weights = server.params
    del params  # prepared: the raw banks the prepared tree replaced
    torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    per_forward = launches_per_forward(cfg, per_call)
    # the main path: counts zeroed just before, read just after; a kernel of
    # the path must launch exactly as the shapes imply (so at least once), any
    # other kernel never
    zero_launches()
    first_reqs = requests(cfg)
    first, first_run = timed_run(server, first_reqs)
    launches, _ = graph_accounting(label, server, cfg, first_reqs, per_call)
    runner = server.programs
    report = dict(
        config=f"{label} full width, {cfg.num_layers} layers, dtype float32, kernel mode "
               f"({'per-call' if per_call else 'prepared'} weights), FxP8 "
               f"{'calibrated' if policy else 'accurate'}, attn_impl=decode_kernel, greedy",
        slots=SLOTS, max_len=MAX_LEN, burst=BURST, prompt_lens=list(PROMPT_LENS),
        max_new=MAX_NEW, prefill="scan" if scan_prefill(cfg) else "bucketed",
        prefill_calls=server.prefill_calls, prefill_steps=server.prefill_steps,
        decode_steps=server.decode_steps,
        first_run=first_run,  # graphs captured at first use, inside this run
        start_mem_gib=start_mem / 2**30,
        setup_peak_mem_gib=setup_peak / 2**30,
        launches=launches,
        launches_per_forward=per_forward,
    )
    for name, tok in first.items():
        if len(tok) != MAX_NEW:
            raise AssertionError(f"{label}: request {name} produced {len(tok)} tokens")
    if per_call and (first != prepared_run[0] or margins(first_reqs) != prepared_run[1]):
        raise AssertionError(f"{label}: per-call greedy streams or their top-2 logit margins "
                             "differ from the prepared run's")
    # steady state: the same requests again, every graph already captured, so
    # no launch is issued from the host
    captured = frozenset(runner.graphs)
    zero_launches()
    steady_reqs = requests(cfg)
    steady, report["steady_run"] = timed_run(server, steady_reqs)
    graph_accounting(f"{label} steady", server, cfg, steady_reqs, per_call, captured)
    report.update(tokens_per_s=report["steady_run"]["tokens_per_s"],
                  decode_ms_per_step=report["steady_run"]["decode_ms_per_step"],
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    if steady != first or margins(steady_reqs) != margins(first_reqs):
        raise AssertionError(f"{label}: full-width greedy streams or their top-2 logit "
                             "margins differ between two runs")
    # what ran on the card, under the profiler: prepared, a repeat of the
    # whole run; per call (~12,000 launches a forward), every request for 9
    # tokens (a prefill in each of the run's buckets, then decode bursts),
    # which must repeat their streams' heads
    head = 9 if per_call else MAX_NEW
    again_reqs = requests(cfg, max_new=head)
    if scan_prefill(cfg):
        again_reqs = [r for r in again_reqs if r.rid in SCAN_PROFILE_RIDS]
    zero_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = server.run(again_reqs)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    if set(runner.graphs) != captured:
        raise AssertionError(f"{label}: the profiled repeat captured {set(runner.graphs)}")
    _, ran = graph_accounting(f"{label} profiled", server, cfg, again_reqs, per_call, captured)
    profiled_forwards = model_forwards(server)
    heads = {r.rid: (first[r.rid][:head], r.margins[:head]) for r in first_reqs}
    if again != {r.rid: heads[r.rid][0] for r in again_reqs} \
            or margins(again_reqs) != [heads[r.rid][1] for r in again_reqs]:
        raise AssertionError(f"{label}: full-width greedy streams or their top-2 logit "
                             "margins differ between two runs")
    rows = kernel_breakdown(prof)
    attention = library_kernels(rows, ATTENTION_KERNELS)
    if attention:
        raise AssertionError(f"{label}: library attention kernels ran on the main path: "
                             f"{attention}")
    gemm = library_kernels(rows, GEMM_KERNELS)
    gemm_calls = sum(n for _, n in gemm)
    allowed = CUBLAS_LAUNCHES_PER_PRODUCT * plain_products_per_forward(cfg) * profiled_forwards
    if gemm_calls > allowed:
        raise AssertionError(f"{label}: {gemm_calls} library matmul launches, the plain "
                             f"products allow {allowed}: {gemm}")
    # by instantiation, from the wrappers' counts of the replayed graphs: GQA,
    # every prefill bucket of 16 rows or more on the tensor cores and the rest
    # on split keys; MLA, every prefill and decode step on the tensor-core loop
    attention_calls = attention_launches(label, ran, serving_instantiations(
        cfg, server, again_reqs, per_call))
    seen = profile_names(f"{label} profiled repeat", rows, ran)
    busy_ms = sum(r[0] for r in rows) / 1e3
    rounds = server.graph_replays
    host = runtime_launches(prof)
    report["profiled_repeat"] = dict(
        requests=len(again_reqs), prompt_lens=[len(r.prompt) for r in again_reqs],
        forwards=profiled_forwards, graph_replays=rounds,
        attention_launches_by_instantiation=attention_calls,
        port_launches_replayed=nonzero(ran), profile_calls_by_instantiation=seen,
        wall_ms=profiled_wall * 1e3, device_busy_ms=busy_ms,
        device_busy_share=busy_ms / (profiled_wall * 1e3),
        device_launches_per_forward=sum(r[2] for r in rows) / profiled_forwards,
        runtime_launch_calls=host,
        runtime_launch_calls_per_round=sum(host.values()) / max(rounds, 1),
        library_matmul_launches_per_forward=gemm_calls / profiled_forwards,
        library_matmul_launches_allowed_per_forward=allowed / profiled_forwards,
        library_kernels=[dict(name=k[:100], calls=n) for k, n in gemm],
        port_kernels=port_kernel_ms(rows),
        top_kernels=[dict(name=k[:100], device_ms=us / 1e3, calls=n)
                     for us, k, n in rows[:12]])
    report["graphs"] = graphs_report(runner)
    report["graph_pool_gib"] = pool_bytes(runner.pool) / 2**30
    if per_call:
        report["weight_rounding"] = weight_rounding_ms(weights, cfg)
    del server, runner
    free_card()
    # the uncaptured yardstick, burst 8, the same weights: every launch issued
    # from the host by the same programs
    eager = make(BURST, capture=False)
    zero_launches()
    eager_reqs = requests(cfg)
    eager_out, report["uncaptured_run"] = timed_run(eager, eager_reqs)
    uncaptured_accounting(f"{label} uncaptured", eager, cfg, eager_reqs, per_call)
    del eager
    free_card()
    if eager_out != first or margins(eager_reqs) != margins(first_reqs):
        raise AssertionError(f"{label}: captured greedy streams or their top-2 logit margins "
                             "differ from the uncaptured run's")
    # burst=1 on the same weights, captured
    one_server = make(1)
    zero_launches()
    one_reqs = requests(cfg)
    one = one_server.run(one_reqs)
    graph_accounting(f"{label} burst 1", one_server, cfg, one_reqs, per_call)
    del one_server
    free_card()
    if one != first or margins(one_reqs) != margins(first_reqs):
        raise AssertionError(f"{label}: full-width greedy streams or their top-2 logit "
                             "margins differ between burst=8 and burst=1")
    report["repeat_identical"] = True  # tokens and f32 margins, bit for bit
    report["uncaptured_identical"] = True
    report["burst1_identical"] = True
    if per_call:
        report["prepared_identical"] = True  # tokens and f32 margins, bit for bit
    report["distinct_tokens"] = len({t for toks in first.values() for t in toks})
    report["streams_head"] = {rid: toks[:8] for rid, toks in first.items()}
    report["margins_head"] = {r.rid: r.margins[:4] for r in first_reqs}
    if policy is not None:  # the execution points the prepared banks carry
        report["point_depths"] = sorted({
            int(d) for w in iter_prepared(weights) for d in w.point[..., 0].unique()})
    log(f"{label}: {report['tokens_per_s']:.2f} tok/s captured (uncaptured "
        f"{report['uncaptured_run']['tokens_per_s']:.2f}), busy "
        f"{report['profiled_repeat']['device_busy_share']:.3f}, graphs "
        f"{ {k: round(v['capture_s'], 2) for k, v in report['graphs'].items()} }, pool "
        f"{report['graph_pool_gib']:.2f} GiB")
    return report, first, margins(first_reqs), weights


TEMPERATURE, SEED_BASE = 1.3, 40


def sampled_requests(cfg, rids=None):
    """``requests(cfg)`` sampled at ``TEMPERATURE``, request i seeded ``SEED_BASE + i``."""
    reqs = requests(cfg)
    for r in reqs:
        r.temperature, r.seed = TEMPERATURE, SEED_BASE + r.rid
    return [r for r in reqs if rids is None or r.rid in rids]


def serve_sampled(device, cfg, params, greedy):
    """Full-width ``cfg`` served sampled (``TEMPERATURE``) on the prepared
    ``params``: the captured burst-8 run with exact launch accounting, the
    uncaptured yardstick, a captured burst-1 run and request 0 served alone
    (burst 4) must give identical streams (and, captured vs uncaptured, f32
    margins bit for bit); the streams must differ from the ``greedy`` ones."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import get_model
    from repro_torch.serve.capture import pool_bytes
    from repro_torch.serve.engine import BatchedServer

    model = get_model(cfg)
    ctx = kernel_ctx()
    make = lambda burst, capture=True: BatchedServer(  # noqa: E731
        model, ctx, params, slots=SLOTS, max_len=MAX_LEN, burst=burst, device=device,
        capture=capture)
    label = f"{cfg.name} sampled"
    server = make(BURST)
    zero_launches()
    reqs = sampled_requests(cfg)
    first, first_run = timed_run(server, reqs)
    launches, _ = graph_accounting(label, server, cfg, reqs)
    runner = server.programs
    captured = frozenset(runner.graphs)
    zero_launches()
    steady_reqs = sampled_requests(cfg)
    steady, steady_run = timed_run(server, steady_reqs)
    graph_accounting(f"{label} steady", server, cfg, steady_reqs, captured_before=captured)
    zero_launches()
    # a scan arch's profiled repeat serves SCAN_PROFILE_RIDS only (see there)
    prof_reqs = sampled_requests(cfg, rids=set(SCAN_PROFILE_RIDS) if scan_prefill(cfg) else None)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run(prof_reqs)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    _, ran = graph_accounting(f"{label} profiled", server, cfg, prof_reqs,
                              captured_before=captured)
    rows = kernel_breakdown(prof)
    seen = profile_names(f"{label} profiled repeat", rows, ran)
    busy_ms = sum(r[0] for r in rows) / 1e3
    host = runtime_launches(prof)
    graphs, pool = graphs_report(runner), pool_bytes(runner.pool) / 2**30
    del server, runner
    free_card()
    eager = make(BURST, capture=False)
    zero_launches()
    eager_reqs = sampled_requests(cfg)
    eager_out, eager_run = timed_run(eager, eager_reqs)
    uncaptured_accounting(f"{label} uncaptured", eager, cfg, eager_reqs)
    del eager
    one_server = make(1)
    zero_launches()
    one_reqs = sampled_requests(cfg)
    one = one_server.run(one_reqs)
    graph_accounting(f"{label} burst 1", one_server, cfg, one_reqs)
    del one_server
    alone = make(4).run(sampled_requests(cfg, rids={0}))
    free_card()
    checks = {"repeat": steady == first and margins(steady_reqs) == margins(reqs),
              "uncaptured": eager_out == first and margins(eager_reqs) == margins(reqs),
              "burst1": one == first and margins(one_reqs) == margins(reqs),
              "alone": alone[0] == first[0], "differs_from_greedy": first != greedy}
    if not all(checks.values()):
        raise AssertionError(f"{label}: {checks}")
    if any(len(v) != MAX_NEW for v in first.values()):
        raise AssertionError(f"{label}: stream lengths {[len(v) for v in first.values()]}")
    log(f"{label}: {steady_run['tokens_per_s']:.2f} tok/s captured, uncaptured "
        f"{eager_run['tokens_per_s']:.2f}, busy {busy_ms / (profiled_wall * 1e3):.3f}")
    return dict(
        config=f"{cfg.name} full width, {cfg.num_layers} layers, prepared, temperature "
               f"{TEMPERATURE}, request i seeded {SEED_BASE} + i",
        launches=launches, first_run=first_run, steady_run=steady_run, uncaptured_run=eager_run,
        tokens_per_s=steady_run["tokens_per_s"], graphs=graphs, graph_pool_gib=pool,
        profiled_repeat=dict(wall_ms=profiled_wall * 1e3, device_busy_ms=busy_ms,
                             device_busy_share=busy_ms / (profiled_wall * 1e3),
                             port_launches_replayed=nonzero(ran),
                             profile_calls_by_instantiation=seen,
                             runtime_launch_calls=host,
                             top_kernels=[dict(name=k[:100], device_ms=us / 1e3, calls=n)
                                          for us, k, n in rows[:12]]),
        identical=checks, distinct_tokens=len({t for v in first.values() for t in v}),
        streams_head={rid: toks[:8] for rid, toks in first.items()})


# the replay-order gate: reduced olmo-1b, prompts in six buckets, greedy and
# sampled requests (the first two greedy, so that the first order captures
# the greedy and the sampled burst), budgets that free slots at different
# bursts; each order is a permutation of the request list
ORDER_PROMPTS = (3, 17, 60, 9, 130, 33)
ORDER_MAX_NEW = (8, 5, 11, 6, 9, 7)
ORDER_TEMPS = (0.0, 0.0, TEMPERATURE, TEMPERATURE, 0.0, TEMPERATURE)
ORDERS = ((0, 1, 2, 3, 4, 5), (5, 4, 3, 2, 1, 0), (3, 0, 5, 2, 4, 1))


def order_requests(cfg, order):
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in ORDER_PROMPTS]
    return [Request(i, prompts[i], ORDER_MAX_NEW[i], temperature=ORDER_TEMPS[i],
                    seed=SEED_BASE + i) for i in order]


def replay_order(device):
    """One captured server on reduced olmo-1b captures its graphs (every
    bucket, the greedy and the sampled burst) while serving the requests in
    one order, then serves them again in two other orders, so that the
    graphs that share one pool replay in orders other than their capture
    order; no graph is captured after the first order. Each order's streams
    and f32 margins must be bitwise those of an uncaptured server given the
    same order."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.serve.capture import pool_bytes
    from repro_torch.serve.engine import BatchedServer

    cfg = reduced(get_config("olmo-1b"))
    model = get_model(cfg)
    params = scaled_init(model)
    make = lambda capture: BatchedServer(model, kernel_ctx(), params, slots=2,  # noqa: E731
                                         max_len=256, burst=4, device=device, capture=capture)
    server, eager = make(True), make(False)
    results = []
    for i, order in enumerate(ORDERS):
        before = frozenset(server.programs.graphs)
        zero_launches()
        reqs = order_requests(cfg, order)
        got = server.run(reqs)
        graph_accounting(f"replay order {order}", server, cfg, reqs, captured_before=before)
        if i and set(server.programs.graphs) != before:
            raise AssertionError(f"replay order {order}: captured "
                                 f"{set(server.programs.graphs) - before} after the first order")
        eager_reqs = order_requests(cfg, order)
        want = eager.run(eager_reqs)
        if got != want or margins(reqs) != margins(eager_reqs):
            raise AssertionError(f"replay order {order}: captured streams or margins differ "
                                 "from the uncaptured run's")
        results.append(dict(order=list(order), replays=dict(server.programs.replays),
                            identical=True))
    return dict(config="olmo-1b reduced, 2 layers, prepared, slots 2, burst 4, max_len 256",
                prompt_lens=list(ORDER_PROMPTS), max_new=list(ORDER_MAX_NEW),
                temperatures=list(ORDER_TEMPS), graphs=sorted(server.programs.graphs),
                capture_order=list(server.programs.capture_seconds),
                graph_pool_gib=pool_bytes(server.programs.pool) / 2**30, orders=results)


def iter_prepared(tree):
    """Every ``PreparedWeight`` leaf of a parameter tree."""
    from repro_torch.core.backends.base import PreparedWeight

    if isinstance(tree, dict):
        for v in tree.values():
            yield from iter_prepared(v)
    elif isinstance(tree, PreparedWeight):
        yield tree


def weight_rounding_ms(params, cfg) -> dict:
    """Device ms of one forward's per-call weight rounding: ``quantize_weights``
    on every dot weight of every layer and the tied lm_head, CUDA events
    around the whole sequence (each rounding is ~40 eager kernels over
    millions of elements, so the card, not the host, sets the pace)."""
    import torch

    from repro_torch.core import FXP8_UNIT
    from repro_torch.kernels.cordic_mac import quantize_weights

    weights = []
    for seg in (v for k, v in params.items() if k.startswith("seg")):
        layer_leaves = [seg["attn"][n] for n in ("wq", "wk", "wv", "wo")]
        layer_leaves += [seg["mlp"][n] for n in ("up", "gate", "down")]
        weights += [leaf[i] for i in range(cfg.num_layers) for leaf in layer_leaves]
    weights.append(params["embed"].T)
    depth = FXP8_UNIT.frac + 1

    def round_all():
        for w in weights:
            quantize_weights(w, depth, FXP8_UNIT)

    ms = timed_ms(round_all, iters=2, warmup=1)
    elements = sum(w.numel() for w in weights)
    return dict(weights_per_forward=len(weights), elements=elements, ms_per_forward=ms,
                f32_gb_read_once=elements * 4 / 1e9)


# ---------------------------------------------------------------------------
# phases 3 and 5-8: the cache-free forward and the calibration scan
# ---------------------------------------------------------------------------


def forward_phase(device, label, cfg, params, batch):
    """One cache-free ``forward`` of ``cfg`` on prepared ``params`` and seeded
    tokens of shape ``batch`` (a vision model: after its stub frontend's
    ``cfg.frontend_tokens`` embeddings, seeded 0.02 x N(0, 1) as the
    reference's data pipeline makes them), under ``attn_impl="flash"`` and
    ``"xla"``:
    wall time and launch counts of the main path, a profiled repeat (which
    must give the same logits), no library attention kernel and, under
    "flash", library matmuls only for the plain products; then the largest
    |logit| difference and the share of positions whose argmax agrees
    between the two (reported, not gated: a reduction-order ulp can move a
    value across an FxP8 rounding boundary)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import get_model

    model = get_model(cfg)
    rng = np.random.default_rng(SEED)
    inputs = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, batch), device=device)}
    seq = batch[1]  # the sequence each dot and attention runs over
    if cfg.frontend == "vision":
        embeds = rng.standard_normal((batch[0], cfg.frontend_tokens, cfg.d_model)) * 0.02
        inputs["frontend_embeds"] = torch.as_tensor(embeds, dtype=torch.float32, device=device)
        seq += cfg.frontend_tokens
    elif cfg.frontend == "audio":  # stub frames, pooled 2x to the decoder's length
        embeds = rng.standard_normal((batch[0], SEAMLESS_FRAMES, cfg.d_model)) * 0.02
        inputs["frontend_embeds"] = torch.as_tensor(embeds, dtype=torch.float32, device=device)
    runs, logits = {}, {}
    for impl in ("flash", "xla"):
        ctx = kernel_ctx(impl)
        want = forward_launches(cfg, impl)
        kernels = zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            lg, aux = model.forward(params, inputs, ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = check_launches(f"{label} forward ({impl})", kernels, want)
        check_instantiations(f"{label} forward ({impl})", wrapper_counts(),
                             by_instantiation(want, batch[0] * seq, seq))
        if tuple(lg.shape) != (batch[0], seq, cfg.vocab_size) or not torch.isfinite(lg).all():
            raise AssertionError(f"{label} forward ({impl}): logits {tuple(lg.shape)}, "
                                 f"finite {bool(torch.isfinite(lg).all())}")
        zero_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.no_grad():
                again, _ = model.forward(params, inputs, ctx)
            torch.cuda.synchronize()
            profiled_wall = time.perf_counter() - t0
        ran = wrapper_counts()
        if not torch.equal(again, lg):
            raise AssertionError(f"{label} forward ({impl}): logits differ between two runs")
        rows = kernel_breakdown(prof)
        attention = library_kernels(rows, ATTENTION_KERNELS)
        if attention:
            raise AssertionError(f"{label} forward ({impl}): library attention kernels: "
                                 f"{attention}")
        gemm = library_kernels(rows, GEMM_KERNELS)
        gemm_calls = sum(n for _, n in gemm)
        allowed = CUBLAS_LAUNCHES_PER_PRODUCT * plain_products_per_forward(cfg, cache_free=True)
        if impl == "flash" and gemm_calls > allowed:
            raise AssertionError(f"{label} forward: {gemm_calls} library matmul launches, the "
                                 f"plain products allow {allowed}: {gemm}")
        # by instantiation, from the wrappers: every fused launch (M = B x S >
        # 16) on the int8 tensor cores, every flash (MLA flash) launch on the
        # tensor-core kernel; the profile shows those kernels and no other
        fused_calls = tensor_core_launches(f"{label} forward ({impl})", ran, "fused_dot_af",
                                           want["fused_dot_af"])
        flash_name = "mla_flash_attention" if cfg.mla else "flash_attention"
        attention_calls = attention_launches(f"{label} forward ({impl})", ran,
                                             {f"{flash_name}/tc": want.get(flash_name, 0)})
        seen = profile_names(f"{label} forward ({impl})", rows, ran)
        busy_ms = sum(r[0] for r in rows) / 1e3
        runs[impl] = dict(
            wall_s=wall, launches=launches, lb_loss=float(aux.get("lb_loss", 0.0)),
            fused_launches_by_instantiation=fused_calls,
            attention_launches_by_instantiation=attention_calls,
            profiled_repeat=dict(
                profile_calls_by_instantiation=seen,
                wall_ms=profiled_wall * 1e3, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / (profiled_wall * 1e3),
                device_launches=sum(r[2] for r in rows),
                library_matmul_launches=gemm_calls,
                library_matmul_launches_allowed=allowed if impl == "flash" else None,
                library_kernels=[dict(name=k[:100], calls=n) for k, n in gemm],
                port_kernels=port_kernel_ms(rows),
                top_kernels=[dict(name=k[:100], device_ms=us / 1e3, calls=n)
                             for us, k, n in rows[:10]]))
        logits[impl] = lg
        log(f"{label} forward {batch} {impl}: {wall:.3f} s, launches {launches}, busy "
            f"{busy_ms / (profiled_wall * 1e3):.3f}")
    agree = (logits["flash"].argmax(-1) == logits["xla"].argmax(-1)).float().mean().item()
    return dict(
        config=f"{label} full width, {cfg.num_layers} layers, dtype float32, kernel mode "
               "(prepared weights), FxP8 accurate, cache-free forward",
        batch=list(batch), frontend_tokens=seq - batch[1],
        frontend_frames=SEAMLESS_FRAMES if cfg.frontend == "audio" else 0, runs=runs,
        launches=runs["flash"]["launches"],
        launches_per_forward=forward_launches(cfg, "flash"),
        max_abs_dlogit_flash_vs_xla=(logits["flash"] - logits["xla"]).abs().max().item(),
        argmax_agreement_flash_vs_xla=agree)


def calibrate_full_width(device):
    """The serving CLI's startup scan on full-width olmo-1b: ``calibration_scan``
    per call (raw weights: the MAC-array kernel, the gate's multi-AF, the
    flash kernel), kernel mode, ``attn_impl="flash"``, batch (2, 512), with
    the launch counts of all its forwards; then ``assign_depths`` at the
    CLI's default cycle reduction. Returns ``(report, policy)``."""
    import numpy as np
    import torch

    from repro_torch.core import FXP8, assign_depths
    from repro_torch.models import get_model
    from repro_torch.runtime import calibration_scan

    cfg = olmo()
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    batch = (2, BUCKET)
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab_size, batch),
                             device=device)
    kernels = zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sens = calibration_scan(model, params, tokens, fmt=FXP8, mode="kernel", attn_impl="flash")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    forwards = len(sens) + 1  # one at full depth, one per demoted group
    want = forward_launches(cfg, "flash", per_call=True)
    launches = check_launches("calibration scan", kernels, want, times=forwards)
    check_instantiations("calibration scan", wrapper_counts(),
                         by_instantiation(want, batch[0] * batch[1], batch[1], forwards))
    if len(sens) != 8 or not all(math.isfinite(v) and v > 0 for v in sens.values()):
        raise AssertionError(f"calibration scan: sensitivities {sens}")
    policy = assign_depths(sens, fmt=FXP8, cycle_reduction_target=CYCLE_REDUCTION)
    log(f"calibration: {seconds:.2f} s for {forwards} forwards; {sens}")
    # one of the scan's per-call forwards again, profiled: every MAC launch
    # (M = 1024) on the tensor cores, by the wrappers' counts; the profile
    # shows those kernels and no other
    from torch.profiler import ProfilerActivity, profile

    zero_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            model.forward(params, {"tokens": tokens}, kernel_ctx("flash"))
        torch.cuda.synchronize()
    ran = wrapper_counts()
    rows = kernel_breakdown(prof)
    mac_calls = tensor_core_launches("calibration forward", ran, "cordic_mac",
                                     want["cordic_mac"])
    flash_calls = attention_launches("calibration forward", ran,
                                     {"flash_attention/tc": cfg.num_layers})
    seen = profile_names("calibration forward", rows, ran)
    return dict(
        config="olmo-1b full width, 16 layers, dtype float32, kernel mode per call (raw "
               "weights), attn_impl=flash, calibration_scan",
        batch=list(batch), forwards=forwards, seconds=seconds,
        seconds_per_forward=seconds / forwards, sensitivities=sens,
        cycle_reduction=CYCLE_REDUCTION, policy=policy.to_json(), launches=launches,
        launches_per_forward=want,
        profiled_forward=dict(mac_launches_by_instantiation=mac_calls,
                              attention_launches_by_instantiation=flash_calls,
                              profile_calls_by_instantiation=seen,
                              port_kernels=port_kernel_ms(rows))), policy


def forward_card_vs_cpu(device, label, cfg, params, batch):
    """The cache-free ``forward`` on the card and on the CPU, the same
    prepared weights and tokens, under ``"flash"`` and ``"xla"``.

    Gated: every flash (or MLA flash) launch of the card's ``"flash"``
    forward, recorded with its inputs, equals the plain version run on the
    CPU on those same inputs within the kernel's TOLERANCE; and the launch
    counts. The end-to-end logits are compared under both ``attn_impl`` and
    reported, not gated (the largest difference, the share of logits past
    LOGIT_TOL, the argmax agreement): the fused kernel quantizes its input
    onto the FxP8 grid, so an f32 reduction-order ulp of the glue (norms,
    RoPE, attention) that lands on a rounding boundary moves a value one
    FxP8 step, and over 140 tokens such flips occur and cascade through the
    layers (and through the MoE routing). The ``"xla"`` comparison, which
    runs no kernel of the cache-free path, shows the same spread, and the
    first layer's attention inputs (after the norm, the fused projections
    and RoPE, before any attention) are reported beside it."""
    import numpy as np
    import torch

    from repro_torch.core import prepare_params
    from repro_torch.kernels import flash_attention as flash_pkg, mla_flash as mla_flash_pkg
    from repro_torch.models import blocks, get_model, mla
    from repro_torch.serve.engine import _to_device

    model = get_model(cfg)
    tokens = np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, batch)
    if cfg.mla:
        owner, attr, pkg, ref = (mla, "mla_flash_attention", mla_flash_pkg,
                                 mla_flash_pkg.mla_flash_attention_ref)
    else:
        owner, attr, pkg, ref = (blocks, "flash_attention", flash_pkg,
                                 flash_pkg.flash_attention_ref)
    kernel, records = getattr(owner, attr), {"card": [], "cpu": []}

    def recorder(where):
        def recording(*args, **kw):
            out = kernel(*args, **kw)
            records[where].append(([a.cpu() for a in args], kw, out.cpu()))
            return out
        return recording

    logits, lb = {}, {}
    for impl in ("flash", "xla"):
        for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
            ctx = kernel_ctx(impl)
            prepared = prepare_params(_to_device(params, dev), ctx.policy, "kernel",
                                      specs=model.specs())
            kernels = zero_launches()
            setattr(owner, attr, recorder(where) if impl == "flash" else kernel)
            try:
                with torch.no_grad():
                    lg, aux = model.forward(
                        prepared, {"tokens": torch.as_tensor(tokens, device=dev)}, ctx)
            finally:
                setattr(owner, attr, kernel)
            if where == "card":
                check_launches(f"{label} forward card ({impl})", kernels,
                               forward_launches(cfg, impl))
            logits[impl, where], lb[impl, where] = lg.cpu(), float(aux["lb_loss"])
    if len(records["card"]) != cfg.num_layers:
        raise AssertionError(f"{label}: {len(records['card'])} flash launches recorded")
    kernel_err = 0.0
    for args, kw, out in records["card"]:
        kernel_err = max(kernel_err, (out - ref(*args, **kw)).abs().max().item())
    layer0 = [(a - b).abs().max().item()
              for a, b in zip(records["card"][0][0], records["cpu"][0][0])]
    if not kernel_err <= pkg.TOLERANCE:
        raise AssertionError(f"{label}: the card's {attr} on the forward's inputs vs the plain "
                             f"version on the CPU: max|diff| {kernel_err} > {pkg.TOLERANCE}")
    report = dict(config=label, layers=cfg.num_layers, d_model=cfg.d_model, batch=list(batch),
                  weights="prepared", kernel=attr, kernel_vs_plain_in_forward=kernel_err,
                  kernel_tolerance=pkg.TOLERANCE, layer0_attention_inputs_max_abs_diff=layer0)
    for impl in ("flash", "xla"):
        card, cpu = logits[impl, "card"], logits[impl, "cpu"]
        beyond = (card - cpu).abs() > LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * cpu.abs()
        agree = (card.argmax(-1) == cpu.argmax(-1)).float().mean().item()
        report[impl] = dict(logits_max_abs_diff=(card - cpu).abs().max().item(),
                            logits_share_beyond_tol=beyond.float().mean().item(),
                            argmax_agreement=agree, lb_loss_card=lb[impl, "card"],
                            lb_loss_cpu=lb[impl, "cpu"])
    log(f"{label}: kernel in forward {kernel_err:.2e}; layer-0 inputs {layer0}; flash "
        f"{report['flash']}; xla {report['xla']}")
    return report


def card_vs_cpu(device, label, cfg, params, lens, max_len, prepare_weights=True):
    """The same weights served on the card (kernels) and the CPU (plain
    versions); the greedy streams must be identical."""
    import torch

    from repro_torch.models import get_model
    from repro_torch.serve.engine import BatchedServer

    model = get_model(cfg)
    reqs = lambda: requests(cfg, lens=lens, max_new=8)  # noqa: E731
    out, logits = {}, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        server = BatchedServer(model, kernel_ctx(), params, slots=2, max_len=max_len, burst=4,
                               device=dev, prepare_weights=prepare_weights)
        out[where] = server.run(reqs())
        prompt = torch.as_tensor(reqs()[1].prompt[None], device=dev)
        row = model.make_cache(1, max_len, device=dev)
        # the logits of every prompt row: one block, or a step a token (the
        # scan), the steps' rows concatenated
        blocks = prompt.split(1, dim=1) if scan_prefill(cfg) else (prompt,)
        with torch.no_grad():
            lg = torch.cat([model.decode_step(server.params, block, row, server.ctx)[0]
                            for block in blocks], dim=1)
        logits[where] = lg.cpu()
    if out["card"] != out["cpu"]:
        raise AssertionError(f"{label}: streams differ card vs CPU: {out}")
    diff = (logits["card"] - logits["cpu"]).abs().max().item()
    return dict(config=label, layers=cfg.num_layers, d_model=cfg.d_model, prompt_lens=list(lens),
                weights="prepared" if prepare_weights else "per-call", streams_identical=True,
                prefill_logits_max_abs_diff=diff, streams=out["card"])


def olmo_card_vs_cpu(device):
    import torch

    from repro_torch.models import get_model

    cfg = olmo(layers=2)
    params = get_model(cfg).init(torch.Generator(device="cpu").manual_seed(SEED))
    return card_vs_cpu(device, "olmo-1b full width, 2 layers", cfg, params, (5, 11), 64)


def scaled_init(model, scale: float = 0.1):
    """``model.init`` on the CPU from ``SEED``, with the layer matrices scaled
    to N(0, scale^2), as in the CPU parity tests, so that the layers and not
    the tied embedding pick the tokens; for the scan families the leaves
    initialised to ones (norm scales, the Mamba2 mixer's ``norm`` and ``D``)
    become 1 + 0.1 x N(0, 1), as the CPU parity tests make them: at exactly
    one the reduced streams collapse onto one token."""
    import torch

    from repro_torch.models.params import spec_leaves

    params = model.init(torch.Generator(device="cpu").manual_seed(SEED))
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    for path, spec in spec_leaves(model.specs()):
        leaf = params
        for key in path:
            leaf = leaf[key]
        if spec.init == "normal" and path[0] != "embed":
            leaf.mul_(scale / spec.scale)
        elif spec.init == "ones" and scan_prefill(model.cfg):
            leaf.add_(torch.randn(leaf.shape, generator=gen) * 0.1)
    return params


def olmo_per_call_card_vs_cpu(device):
    """Per-call olmo-1b, reduced (2 layers, d_model 128: the CPU's plain
    versions re-round every weight at every dot), card vs CPU."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model

    cfg = reduced(get_config("olmo-1b"))
    return card_vs_cpu(device, "olmo-1b reduced, 2 layers, per-call", cfg,
                       scaled_init(get_model(cfg)), (5, 11, 40), 64, prepare_weights=False)


def deepseek_card_vs_cpu(device):
    """Reduced deepseek-v3 (4 layers: 1 dense prefix, 3 MoE; d_model 128, 4
    experts): a full-width MoE layer is 45 GB and ~722 GFLOP per step on the
    host. Layer weights are scaled to N(0, 0.1^2), as in the CPU parity tests,
    so that the routing is not degenerate. The 70-token prompt's 96-row
    bucket is past the dropless widening (s > 64)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model

    cfg = reduced(get_config("deepseek-v3-671b"), layers=4)
    return card_vs_cpu(device, "deepseek-v3-671b reduced, 4 layers", cfg,
                       scaled_init(get_model(cfg)), (5, 11, 70), 96)


def llama4_card_vs_cpu(device):
    """Reduced llama4-maverick, one interleaved (dense, MoE) pair (d_model
    128, 4 experts, top-1, a shared expert) with its 5 head groups kept
    (H10/KV2, head_dim 32), card vs CPU, served; layer weights scaled as in
    ``deepseek_card_vs_cpu``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model

    cfg = dataclasses.replace(reduced(get_config("llama4-maverick-400b-a17b")), num_heads=10,
                              num_kv_heads=2, head_dim=32)
    return card_vs_cpu(device, "llama4-maverick reduced, one pair, H10/KV2", cfg,
                       scaled_init(get_model(cfg)), (5, 11, 70), 96)


def scan_card_vs_cpu(device, name):
    """A reduced scan arch (2 layers, d_model 128; zamba2 at d_model 448, where
    the reduced rules give its stock head_dim 112 at H4/KV4, so that the
    GQA kernel at 112 runs end to end) served on the card and the CPU, layer
    weights scaled and ones-leaves perturbed as in ``scaled_init``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model

    cfg = reduced(get_config(name), d_model=448 if name == "zamba2-7b" else 128)
    label = f"{name} reduced, {cfg.num_layers} layers, d_model {cfg.d_model}"
    if cfg.num_heads:
        label += f", H{cfg.num_heads}/KV{cfg.num_kv_heads} head_dim {cfg.head_dim}"
    return card_vs_cpu(device, label, cfg, scaled_init(get_model(cfg)), (5, 11, 40), 64)


def recorded(controller) -> list:
    """Wrap ``controller.observe`` to record the point it picks after each
    observation; returns the (growing) list."""
    trajectory, observe = [], controller.observe

    def record(signals):
        trajectory.append(observe(signals))
        return trajectory[-1]

    controller.observe = record
    return trajectory


def bank_report(bank, seconds: float) -> dict:
    """A bank's points, build time, shared leaves and, by point, the GiB of
    the prepared leaves it holds that no cheaper point holds, and its
    relative MAC cycles."""
    seen, by_point = set(), {}
    for name in bank.names:
        nbytes = 0
        for leaf in iter_prepared(bank.tree(name)):
            if id(leaf) not in seen:
                seen.add(id(leaf))
                nbytes += leaf.data.untyped_storage().nbytes() + leaf.point.numel() * 4
        by_point[name] = dict(gib=nbytes / 2**30, rel_cycles=bank.rel_cycles(name),
                              cycles_per_token=bank.cycles_per_token[name])
    return dict(points=list(bank.names), reference=bank.reference, build_s=seconds,
                shared_leaves=bank.shared_leaves, unique_leaves=bank.unique_leaves,
                cycle_model=bank.cycle_model, by_point=by_point)


def capture_by_point(runner) -> dict:
    """point -> (graphs, capture seconds) of a runner's graphs ("" for a
    program without a point)."""
    out = {}
    for name, sec in runner.capture_seconds.items():
        point = name.partition(" @")[2]
        n, t = out.get(point, (0, 0.0))
        out[point] = (n + 1, t + sec)
    return {p: dict(graphs=n, capture_s=t) for p, (n, t) in out.items()}


def make_bank(device, cfg, hifi: bool):
    """Full-width ``cfg``'s seeded weights on the card (those of
    ``serve_full_width``) and their multi-point bank: approx and accurate
    FxP8, and with ``hifi`` accurate FxP16. Returns ``(model, params, bank,
    report)``."""
    import torch

    from repro_torch.core import FXP8, FXP16
    from repro_torch.models import get_model
    from repro_torch.runtime import build_bank, default_points

    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = build_bank(params, "kernel", default_points(FXP8, hifi_fmt=FXP16 if hifi else None),
                      specs=model.specs())
    torch.cuda.synchronize()
    return model, params, bank, bank_report(bank, time.perf_counter() - t0)


def adaptive_phases(device, accurate):
    """Runtime-adaptive precision on full-width olmo-1b (16 layers), the bank
    ``default_points(FXP8, hifi_fmt=FXP16)`` (approx FxP8, accurate FxP8,
    hifi FxP16: three whole banks), the six requests of ``requests``; every
    (program, point) one captured graph, in one pool a server:

    a. a controller pinned at each point serves what a static server of
       that point's prepared weights serves, streams and f32 margins bit for
       bit (at accurate, the ``serve olmo-1b`` phase's run, ``accurate``);
    b. the CLI's flow (cycle budget 0.75): the captured run, a steady repeat
       (no graph captured: every point it visits replays its graphs) and the
       uncaptured yardstick give the same point trajectory, streams, margins
       and telemetry summary; the repeat allocates less than a bank (no bank
       is copied); the yardstick launches exactly the captured run's
       replayed launches;
    c. a budget-driven run with the margins disarmed switches at least once.

    Each captured run's launches are exact by (program, point)
    (``graph_accounting`` with the points' weight widths) with one transfer
    a prefill and a burst. Reports tokens/s by point, capture seconds by
    point and the pool's GiB."""
    import torch

    from repro_torch.core import prepare_params
    from repro_torch.runtime import ControllerConfig, ModeController
    from repro_torch.serve.capture import pool_bytes
    from repro_torch.serve.engine import BatchedServer

    cfg = olmo()
    torch.cuda.reset_peak_memory_stats()
    model, params, bank, report = make_bank(device, cfg, hifi=True)
    widths = point_bytes(bank)
    ctx = kernel_ctx()
    label = "olmo-1b adaptive"

    def serve(controller, capture=True):
        return BatchedServer(model, ctx, params, slots=SLOTS, max_len=MAX_LEN, burst=BURST,
                             device=device, controller=controller, capture=capture)

    report.update(config=f"{label}: full width, {cfg.num_layers} layers, kernel mode, bank "
                         f"{list(bank.names)}, slots {SLOTS}, burst {BURST}, max_len {MAX_LEN}",
                  setup_peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    # a. pinned at each point == a static server of that point's weights
    pinned = {}
    for point in bank.names:
        server = serve(ModeController(bank, ControllerConfig(pin=point)))
        zero_launches()
        reqs = requests(cfg)
        out, first_run = timed_run(server, reqs)
        launches, _ = graph_accounting(f"{label} pinned {point}", server, cfg, reqs,
                                       widths=widths)
        runner = server.programs
        if any(name.partition(" @")[2] not in ("", point) for name in runner.graphs):
            raise AssertionError(f"{label} pinned {point}: graphs {sorted(runner.graphs)}")
        captured = frozenset(runner.graphs)
        zero_launches()
        steady_reqs = requests(cfg)
        steady, steady_run = timed_run(server, steady_reqs)
        graph_accounting(f"{label} pinned {point} steady", server, cfg, steady_reqs,
                         captured_before=captured, widths=widths)
        if steady != out or margins(steady_reqs) != margins(reqs):
            raise AssertionError(f"{label} pinned {point}: two runs differ")
        row = dict(first_run=first_run, steady_run=steady_run,
                   tokens_per_s=steady_run["tokens_per_s"],
                   decode_ms_per_step=steady_run["decode_ms_per_step"], launches=launches,
                   graphs=graphs_report(runner), graph_pool_gib=pool_bytes(runner.pool) / 2**30,
                   telemetry=server.telemetry.summary())
        del server, runner
        free_card()
        if point == bank.reference and accurate is not None:
            want, want_margins = accurate
        else:
            policy = next(p.policy for p in bank.points if p.name == point)
            static = BatchedServer(model, ctx, prepare_params(params, policy, "kernel",
                                                              specs=model.specs()),
                                   slots=SLOTS, max_len=MAX_LEN, burst=BURST, device=device,
                                   prepare_weights=False)
            static_reqs = requests(cfg)
            want, want_margins = static.run(static_reqs), margins(static_reqs)
            del static
            free_card()
        if out != want or margins(reqs) != want_margins:
            raise AssertionError(f"{label}: pinned at {point}, streams or f32 margins differ "
                                 "from the static server's")
        row["static_identical"] = True
        pinned[point] = row
        log(f"{label} pinned {point}: {row['tokens_per_s']:.2f} tok/s, "
            f"{row['decode_ms_per_step']:.3f} ms a step")
    report["pinned"] = pinned

    # b. the CLI's flow: captured, steady, uncaptured
    budget = ControllerConfig(cycle_budget=0.75)
    ctrl = ModeController(bank, budget)
    trajectory = recorded(ctrl)
    server = serve(ctrl)
    zero_launches()
    reqs = requests(cfg)
    out, first_run = timed_run(server, reqs)
    launches, replayed = graph_accounting(f"{label} cli", server, cfg, reqs, widths=widths)
    tele, first_traj = server.telemetry.summary(), list(trajectory)
    runner = server.programs
    captured = frozenset(runner.graphs)
    trajectory.clear()
    zero_launches()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    steady_reqs = requests(cfg)
    steady, steady_run = timed_run(server, steady_reqs)
    steady_alloc = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    graph_accounting(f"{label} cli steady", server, cfg, steady_reqs, captured_before=captured,
                     widths=widths)
    smallest_bank = min(v["gib"] for v in report["by_point"].values())
    checks = {"repeat": steady == out and margins(steady_reqs) == margins(reqs),
              "repeat_trajectory": trajectory == first_traj,
              "repeat_telemetry": server.telemetry.summary() == tele,
              "no_recapture": set(runner.graphs) == captured,
              "no_bank_copy": steady_alloc < smallest_bank}
    cli = dict(first_run=first_run, steady_run=steady_run,
               tokens_per_s=steady_run["tokens_per_s"], launches=launches,
               trajectory=first_traj, telemetry=tele, graphs=graphs_report(runner),
               capture_by_point=capture_by_point(runner),
               graph_pool_gib=pool_bytes(runner.pool) / 2**30,
               steady_alloc_over_start_gib=steady_alloc,
               replays_by_program_point=check_point_replays(f"{label} cli", server, reqs))
    del server, runner
    free_card()
    ctrl = ModeController(bank, budget)
    eager_traj = recorded(ctrl)
    eager = serve(ctrl, capture=False)
    zero_launches()
    eager_reqs = requests(cfg)
    eager_out, cli["uncaptured_run"] = timed_run(eager, eager_reqs)
    check_instantiations(f"{label} cli uncaptured", wrapper_counts(), replayed)
    checks.update(uncaptured=eager_out == out and margins(eager_reqs) == margins(reqs),
                  uncaptured_trajectory=eager_traj == first_traj,
                  uncaptured_telemetry=eager.telemetry.summary() == tele,
                  uncaptured_replays_none=eager.graph_replays == 0)
    del eager
    free_card()
    if not all(checks.values()):
        raise AssertionError(f"{label} cli: {checks}")
    cli["identical"] = checks
    report["cli_flow"] = cli
    report["launches"] = launches
    log(f"{label} cli: trajectory {first_traj}, {cli['tokens_per_s']:.2f} tok/s, "
        f"{tele['switches']} switches, capture by point {cli['capture_by_point']}")

    # c. budget-driven, margins disarmed: at least one switch
    ctrl = ModeController(bank, ControllerConfig(cycle_budget=0.7, margin_promote=-1.0,
                                                 margin_demote=float("inf")))
    trajectory = recorded(ctrl)
    server = serve(ctrl)
    zero_launches()
    reqs = requests(cfg)
    _, run = timed_run(server, reqs)
    graph_accounting(f"{label} budget", server, cfg, reqs, widths=widths)
    tele = server.telemetry.summary()
    if tele["switches"] < 1:
        raise AssertionError(f"{label} budget-driven: no switch ({tele})")
    report["budget_driven"] = dict(run=run, trajectory=list(trajectory), telemetry=tele,
                                   capture_by_point=capture_by_point(server.programs),
                                   graph_pool_gib=pool_bytes(server.programs.pool) / 2**30)
    del server, bank, params
    free_card()
    return report


def verify_logits_bitwise(model, ctx, tree, device) -> dict:
    """A verify's decode step (``DRAFT_LEN + 1`` tokens a slot on ``SLOTS``
    slots, a cache filled to rows 125..380) gives every position the logits
    that the token-by-token decode steps give, bit for bit; raises with the
    largest difference otherwise."""
    import torch

    from repro_torch.serve.kvcache import scatter_rows

    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    vocab = model.cfg.vocab_size
    cache = model.make_cache(SLOTS, MAX_LEN, device=device)
    with torch.no_grad():
        for b, plen in enumerate((125, 253, 30, 380)[:SLOTS]):
            plen = min(plen, MAX_LEN - DRAFT_LEN - 1)
            row = model.make_cache(1, MAX_LEN, device=device)
            model.decode_step(tree, torch.randint(0, vocab, (1, plen), generator=gen,
                                                  device=device), row, ctx)
            scatter_rows(cache, row, torch.tensor([b], device=device))
        block = torch.randint(0, vocab, (SLOTS, DRAFT_LEN + 1), generator=gen, device=device)
        seq_cache = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items()}
        seq = torch.cat([model.decode_step(tree, block[:, j:j + 1], seq_cache, ctx)[0]
                         for j in range(DRAFT_LEN + 1)], dim=1)
        blk, _ = model.decode_step(tree, block, cache, ctx)
    diff = (seq - blk).abs().max().item()
    if not torch.equal(seq, blk):
        raise AssertionError(f"verify logits differ from token-by-token decode: max |diff| {diff}")
    return dict(slots=SLOTS, rows=DRAFT_LEN + 1, identical=True)


def spec_phases(device, accurate, accurate_tokens_per_s=None):
    """Self-speculative serving on full-width olmo-1b (16 layers), the bank
    ``default_points(FXP8, hifi_fmt=None)``, draft_len ``DRAFT_LEN``, the six
    requests; the draft program one captured graph a draft point, the
    verify one at the verify point, the prefills at the verify point:

    * greedy speculation equals the accurate-only captured run (``accurate``,
      the ``serve olmo-1b`` phase's streams and f32 margins) bit for bit,
      and so does its steady repeat;
    * sampled speculation (``TEMPERATURE``, request i seeded ``SEED_BASE`` +
      i) gives every request ``MAX_NEW`` tokens, and its captured run equals
      its uncaptured run (streams and f32 margins; the yardstick launches
      exactly the captured run's replayed launches);
    * with a controller (the CLI's ``--adaptive --speculative``: budget 0.75,
      starting at the cheapest point) the controller picks the draft point,
      and greedy streams still equal accurate-only serving.

    Launches exact by (program, point), one transfer a prefill and a round.
    Reports acceptance, tokens per verify and tokens/s (against
    ``accurate_tokens_per_s``, the accurate-only steady run's)."""
    from repro_torch.runtime import ControllerConfig, ModeController
    from repro_torch.serve.capture import pool_bytes
    from repro_torch.serve.engine import BatchedServer
    from repro_torch.spec import SpecConfig

    cfg = olmo()
    model, params, bank, report = make_bank(device, cfg, hifi=False)
    widths = point_bytes(bank)
    ctx = kernel_ctx()
    label = "olmo-1b speculative"

    def serve(capture=True, controller=None):
        return BatchedServer(model, ctx, params, slots=SLOTS, max_len=MAX_LEN, burst=BURST,
                             device=device, speculate=SpecConfig(draft_len=DRAFT_LEN),
                             bank=None if controller else bank, controller=controller,
                             capture=capture)

    report.update(config=f"{label}: full width, {cfg.num_layers} layers, kernel mode, bank "
                         f"{list(bank.names)}, draft_len {DRAFT_LEN}, slots {SLOTS}, "
                         f"max_len {MAX_LEN}", accurate_only_tokens_per_s=accurate_tokens_per_s)

    def spec_summary(server, run):
        tele = server.spec_telemetry.summary()
        return dict(run=run, tokens_per_s=run["tokens_per_s"], rounds=server.spec_rounds,
                    acceptance_rate=tele["acceptance_rate"],
                    tokens_per_verify=tele["tokens_per_step"], telemetry=tele,
                    graphs=graphs_report(server.programs),
                    capture_by_point=capture_by_point(server.programs),
                    graph_pool_gib=pool_bytes(server.programs.pool) / 2**30)

    report["verify_logits_bitwise"] = verify_logits_bitwise(model, ctx, bank.tree(bank.reference),
                                                           device)
    # greedy == accurate-only, captured and steady
    server = serve()
    zero_launches()
    reqs = requests(cfg)
    out, first_run = timed_run(server, reqs)
    launches, _ = graph_accounting(f"{label} greedy", server, cfg, reqs, widths=widths)
    if out != accurate[0] or margins(reqs) != accurate[1]:
        raise AssertionError(f"{label}: greedy streams or f32 margins differ from accurate-only "
                             "serving")
    captured = frozenset(server.programs.graphs)
    zero_launches()
    steady_reqs = requests(cfg)
    steady, steady_run = timed_run(server, steady_reqs)
    graph_accounting(f"{label} greedy steady", server, cfg, steady_reqs,
                     captured_before=captured, widths=widths)
    if steady != out or margins(steady_reqs) != margins(reqs):
        raise AssertionError(f"{label}: greedy repeat differs")
    greedy = spec_summary(server, steady_run)
    greedy.update(first_run=first_run, launches=launches, accurate_identical=True,
                  replays_by_program_point=check_point_replays(label, server, steady_reqs))
    report["greedy"], report["launches"] = greedy, launches
    del server
    free_card()
    log(f"{label} greedy: {greedy['tokens_per_s']:.2f} tok/s, acceptance "
        f"{greedy['acceptance_rate']}, {greedy['tokens_per_verify']} tokens a verify")

    # sampled: captured == uncaptured
    server = serve()
    zero_launches()
    reqs = sampled_requests(cfg)
    out, run = timed_run(server, reqs)
    _, replayed = graph_accounting(f"{label} sampled", server, cfg, reqs, widths=widths)
    sampled = spec_summary(server, run)
    del server
    free_card()
    eager = serve(capture=False)
    zero_launches()
    eager_reqs = sampled_requests(cfg)
    eager_out, sampled["uncaptured_run"] = timed_run(eager, eager_reqs)
    check_instantiations(f"{label} sampled uncaptured", wrapper_counts(), replayed)
    del eager
    free_card()
    checks = {"uncaptured": eager_out == out and margins(eager_reqs) == margins(reqs),
              "max_new": all(len(v) == MAX_NEW for v in out.values()),
              "differs_from_greedy": out != accurate[0]}
    if not all(checks.values()):
        raise AssertionError(f"{label} sampled: {checks}")
    sampled["identical"] = checks
    report["sampled"] = sampled

    # the controller picks the draft point
    ctrl = ModeController(bank, ControllerConfig(cycle_budget=0.75, start=bank.names[0]))
    trajectory = recorded(ctrl)
    server = serve(controller=ctrl)
    zero_launches()
    reqs = requests(cfg)
    out, run = timed_run(server, reqs)
    graph_accounting(f"{label} adaptive", server, cfg, reqs, widths=widths)
    if out != accurate[0] or margins(reqs) != accurate[1]:
        raise AssertionError(f"{label} adaptive: greedy streams differ from accurate-only")
    adaptive = spec_summary(server, run)
    adaptive.update(trajectory=list(trajectory), telemetry_adaptive=server.telemetry.summary())
    report["adaptive"] = adaptive
    del server, bank, params
    free_card()
    log(f"{label} sampled {sampled['tokens_per_s']:.2f} tok/s (uncaptured "
        f"{sampled['uncaptured_run']['tokens_per_s']:.2f}); adaptive draft points "
        f"{adaptive['telemetry']['rounds_by_draft_point']}")
    return report


def bank_card_vs_cpu(device, label, cfg, params, lens, max_len, speculative: bool):
    """The same weights' bank served on the card and the CPU: adaptive (the
    CLI's flow, budget 0.75, bank with hifi FxP16) or speculative (greedy,
    draft_len ``DRAFT_LEN``); the streams must be identical. Reports whether
    the point trajectories and telemetry agree too."""
    import torch

    from repro_torch.core import FXP8, FXP16
    from repro_torch.models import get_model
    from repro_torch.runtime import ControllerConfig, ModeController, build_bank, default_points
    from repro_torch.serve.engine import BatchedServer, _to_device
    from repro_torch.spec import SpecConfig

    model = get_model(cfg)
    out, tele, traj = {}, {}, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        tree = _to_device(params, dev)
        bank = build_bank(tree, "kernel", default_points(FXP8, hifi_fmt=None if speculative
                                                         else FXP16), specs=model.specs())
        kw = dict(slots=2, max_len=max_len, burst=4, device=dev)
        if speculative:
            server = BatchedServer(model, kernel_ctx(), tree, bank=bank,
                                   speculate=SpecConfig(draft_len=DRAFT_LEN), **kw)
        else:
            ctrl = ModeController(bank, ControllerConfig(cycle_budget=0.75))
            traj[where] = recorded(ctrl)
            server = BatchedServer(model, kernel_ctx(), tree, controller=ctrl, **kw)
        out[where] = server.run(requests(cfg, lens=lens, max_new=8))
        tele[where] = (server.spec_telemetry if speculative else server.telemetry).summary()
    if out["card"] != out["cpu"]:
        raise AssertionError(f"{label}: streams differ card vs CPU: {out}")
    return dict(config=label, layers=cfg.num_layers, d_model=cfg.d_model, prompt_lens=list(lens),
                serving="speculative, greedy" if speculative else "adaptive, budget 0.75",
                streams_identical=True, telemetry_identical=tele["card"] == tele["cpu"],
                trajectory_identical=traj.get("card") == traj.get("cpu"), telemetry=tele,
                streams=out["card"])


def bank_parity_phases(device, parity: dict) -> None:
    """Reduced card vs CPU of the bank servers: olmo-1b adaptive and
    speculative, deepseek-v3 speculative (MLA + MoE), weights as
    ``scaled_init``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model

    olmo_cfg = reduced(get_config("olmo-1b"))
    ds_cfg = reduced(get_config("deepseek-v3-671b"), layers=4)
    for name, cfg, speculative, lens, max_len in (
            ("olmo-1b adaptive", olmo_cfg, False, (5, 11, 40), 64),
            ("olmo-1b speculative", olmo_cfg, True, (5, 11, 40), 64),
            ("deepseek-v3-671b speculative", ds_cfg, True, (5, 11, 70), 96)):
        label = f"{name} reduced, {cfg.num_layers} layers"
        parity[name] = phase(f"{name} card vs cpu", bank_card_vs_cpu, device, label, cfg,
                             scaled_init(get_model(cfg)), lens, max_len, speculative)
        emit({"card_vs_cpu": parity[name]})


def spec_bitwise(device, label, cfg):
    """Greedy self-speculative serving of ``cfg`` at full width (its bank's
    approx and accurate FxP8 points, draft_len ``DRAFT_LEN``, the six
    requests, captured) equals accurate-only serving of the bank's accurate
    tree bit for bit, streams and f32 margins, and a verify's decode step
    gives each position the logits of its token-by-token steps: the rmsnorm
    and MLA/MoE archs, whose rows depended on the rows beside them before
    the row-stable norm, key splits and f32 products. Launches exact by
    (program, point)."""
    import torch

    from repro_torch.serve.engine import BatchedServer
    from repro_torch.spec import SpecConfig

    torch.cuda.reset_peak_memory_stats()
    model, params, bank, report = make_bank(device, cfg, hifi=False)
    del params  # the bank holds the prepared banks and the shared f32 leaves
    free_card()
    ctx = kernel_ctx()
    widths = point_bytes(bank)
    report["verify_logits_bitwise"] = verify_logits_bitwise(model, ctx, bank.tree(bank.reference),
                                                           device)
    accurate = BatchedServer(model, ctx, bank.tree("accurate"), slots=SLOTS, max_len=MAX_LEN,
                             burst=BURST, device=device, prepare_weights=False)
    acc_reqs = requests(cfg)
    acc_out, acc_run = timed_run(accurate, acc_reqs)
    del accurate
    free_card()
    server = BatchedServer(model, ctx, bank.tree("accurate"), slots=SLOTS, max_len=MAX_LEN,
                           device=device, bank=bank, speculate=SpecConfig(draft_len=DRAFT_LEN))
    zero_launches()
    reqs = requests(cfg)
    out, run = timed_run(server, reqs)
    launches, _ = graph_accounting(f"{label} speculative", server, cfg, reqs, widths=widths)
    if out != acc_out or margins(reqs) != margins(acc_reqs):
        raise AssertionError(f"{label}: greedy speculation differs from accurate-only serving")
    tele = server.spec_telemetry.summary()
    report.update(config=f"{label}: full width, {cfg.num_layers} layers, kernel mode, bank "
                         f"{list(bank.names)}, draft_len {DRAFT_LEN}, slots {SLOTS}, "
                         f"max_len {MAX_LEN}", accurate_identical=True, launches=launches,
                  accurate_only_run=acc_run, run=run, tokens_per_s=run["tokens_per_s"],
                  rounds=server.spec_rounds, acceptance_rate=tele["acceptance_rate"],
                  setup_peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    del server, bank
    free_card()
    log(f"{label} speculative: greedy = accurate-only bitwise; {run['tokens_per_s']:.2f} tok/s "
        f"(accurate-only {acc_run['tokens_per_s']:.2f})")
    return report


def nan_rows_check(device) -> dict:
    """Kernels 1 and 2 on NaN-poisoned rows against their plain versions:
    the fused dot (narrow M = 4 and wgmma M = 20) with one row all NaN and
    one partly NaN (the kernel quantizes NaN to 0, as JAX's cast does:
    bitwise equal to the plain version), and the GQA cache attention at a
    decode step and a verify with one slot's cache rows NaN: the same
    finite / non-finite pattern per row as the plain version, the clean
    rows within tolerance of it and bitwise the kernel's rows on the clean
    cache."""
    import torch

    from repro_torch.kernels.cordic_fused import fused_dot_af, fused_dot_af_ref
    from repro_torch.kernels.decode_attention import (TOLERANCE, gqa_decode_attention,
                                                      gqa_decode_attention_ref)

    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    out = {"fused_dot_af": [], "gqa_decode_attention": []}
    from repro_torch.core import FXP8

    k, n = 2048, 8192
    w = prepared_weight(k, n, FXP8, gen, device)[0]
    bank, point = w.data, w.point
    for m in (SLOTS, VERIFY_ROWS):
        x = torch.randn((m, k), generator=gen, device=device)
        x[1] = float("nan")
        x[2, ::3] = float("nan")
        kw = dict(af_mode="identity", af_depth=FXP8.frac + 1, af_fmt=FXP8)
        got, want = fused_dot_af(x, bank, point, **kw), fused_dot_af_ref(x, bank, point, **kw)
        if not (torch.equal(torch.isfinite(got), torch.isfinite(want))
                and torch.equal(got.nan_to_num(), want.nan_to_num())):
            raise AssertionError(f"fused_dot_af on NaN rows (M={m}) differs from its plain version")
        out["fused_dot_af"].append(dict(M=m, K=k, N=n, nan_rows=[1, 2], bitwise=True,
                                        finite_rows=int(torch.isfinite(got).all(1).sum())))
    b, h, kv, hd = SLOTS, 16, 16, 128
    for s in (1, DRAFT_LEN + 1):
        q, ck, cv, _ = attention_case(b, s, MAX_LEN, h, kv, hd, gen, device)
        pos = (torch.tensor([125, 253, 30, 380], device=device)[:b, None]
               + torch.arange(s, device=device)[None]).to(torch.int32)
        scale = 1.0 / math.sqrt(hd)
        clean = gqa_decode_attention(q, ck, cv, pos, scale=scale)
        ck[1], cv[1] = float("nan"), float("nan")
        got = gqa_decode_attention(q, ck, cv, pos, scale=scale)
        want = gqa_decode_attention_ref(q, ck, cv, pos, scale=scale)
        fin, wfin = torch.isfinite(got), torch.isfinite(want)
        keep = [i for i in range(b) if i != 1]
        err = (got[keep] - want[keep]).abs().max().item()
        if not torch.equal(fin, wfin) or fin[1].any() or err > TOLERANCE:
            raise AssertionError(f"gqa_decode_attention S={s} on a NaN slot: pattern equal "
                                 f"{torch.equal(fin, wfin)}, NaN row finite {fin[1].any()}, "
                                 f"clean rows err {err}")
        if not torch.equal(got[keep], clean[keep]):
            raise AssertionError(f"gqa_decode_attention S={s}: a NaN slot moved the clean rows")
        out["gqa_decode_attention"].append(dict(B=b, S=s, T=MAX_LEN, nan_slot=1,
                                                nan_slot_all_nonfinite=True,
                                                clean_rows_unchanged=True, max_abs_err=err))
    return out


def resilience_card_vs_cpu(device):
    """Reduced olmo-1b (``scaled_init`` weights) under one fault plan, on the
    card and the CPU: a NaN-poisoned KV slot (request 1 at round 1) beside
    ``logit_limit`` quarantine. Each request's outcome (status, reason,
    tokens) and stream must be identical."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.resilience import FaultInjector, NaNCacheFault, ResilienceConfig
    from repro_torch.serve.engine import BatchedServer

    cfg = reduced(get_config("olmo-1b"))
    params = scaled_init(get_model(cfg))
    res = {}
    for limit in (None, RESILIENCE_LIMIT):
        got = {}
        for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
            server = BatchedServer(get_model(cfg), kernel_ctx(), params, slots=4, max_len=64,
                                   burst=4, device=dev,
                                   resilience=ResilienceConfig(logit_limit=limit),
                                   injector=FaultInjector(NaNCacheFault(rid=1, at_round=1)))
            out = server.run(requests(cfg, lens=(5, 11, 40), max_new=10))
            got[where] = (out, {rid: (o.status, o.reason, o.tokens)
                                for rid, o in server.outcomes.items()})
        if got["card"] != got["cpu"]:
            raise AssertionError(f"reduced olmo-1b, logit_limit {limit}: outcomes or streams "
                                 f"differ card vs CPU: {got}")
        res[str(limit)] = dict(outcomes=got["card"][1], streams=got["card"][0])
    return dict(config="olmo-1b reduced, NaNCacheFault(rid=1, at_round=1)", identical=True,
                by_logit_limit=res)


def check_trace_files(jsonl: Path, chrome: Path) -> dict:
    """The serve trace's JSONL (read back with the schema check) and its
    Chrome export: header schema, version and run metadata with the
    resilience block, and every track's spans balanced."""
    from repro_torch.obs import TRACE_SCHEMA, TRACE_VERSION, read_trace

    header, events = read_trace(str(jsonl))
    if (header["schema"], header["version"]) != (TRACE_SCHEMA, TRACE_VERSION) or \
            "resilience" not in header["run"] or header["meta"].get("aborted") is not False:
        raise AssertionError(f"trace header: {header['schema']} v{header['version']}, run "
                             f"keys {sorted(header['run'])}, meta {header['meta']}")
    depth = {}
    for ev in events:
        if ev["ph"] in ("B", "E"):
            depth[ev["track"]] = depth.get(ev["track"], 0) + (1 if ev["ph"] == "B" else -1)
            if depth[ev["track"]] < 0:
                raise AssertionError(f"trace: span ends before it begins on {ev['track']}")
    doc = json.loads(chrome.read_text())
    per_tid = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] in ("B", "E"):
            per_tid[ev["tid"]] = per_tid.get(ev["tid"], 0) + (1 if ev["ph"] == "B" else -1)
    if any(depth.values()) or any(per_tid.values()) or \
            doc["metadata"]["schema"] != TRACE_SCHEMA:
        raise AssertionError(f"trace spans unbalanced: jsonl {depth}, chrome {per_tid}")
    return dict(jsonl=jsonl.name, chrome=chrome.name, events=len(events), tracks=sorted(depth), balanced=True,
                names=sorted({ev["name"] for ev in events}))


def resilience_phases(device, accurate, accurate_tokens_per_s=None):
    """Fault-tolerant, observed serving on full-width olmo-1b (16 layers),
    captured, kernel mode, FxP8, the six requests:

    * clean: ``resilience=`` and ``observer=`` attached serve the plain
      server's streams and f32 margins (``accurate``) bit for bit, every
      outcome ``ok``; launches exact by instantiation (the fault flag adds
      glue, no kernel launch); the JSONL and Chrome traces written and
      checked (``check_trace_files``);
    * a NaN cache fault (request 1 at round 2): every other request's
      stream and margins equal the clean run's; the poisoned request's
      outcome and stream as a reduced card-vs-CPU run of the same plan
      shows them (``resilience_card_vs_cpu``: in kernel mode a NaN is
      quantized to 0, so the stream changes and the request completes);
    * a NaN weight fault on the approx point of an adaptive bank (the CLI's
      flow, budget 0.75): only that point's graphs are captured again (and
      counted); a pinned-accurate server on the same bank then serves the
      accurate streams bit for bit, a pinned-approx one all-zero logits
      (token 0, margin 0);
    * speculation: a NaN weight fault on the draft point leaves greedy
      speculation equal to accurate-only serving, every request admitted to
      the end; a verify fault flag set on one lane at one round quarantines
      it (``verify_nonfinite``) while the others serve the accurate streams;
    * shedding and deadlines on the clean server (its graphs captured):
      ``queue_limit`` 3 sheds 3 requests ``queue_full`` and the survivors
      serve the accurate streams; an oversized request is shed
      ``too_long``; a ``DelayFault`` past every deadline expires the active
      requests at the boundary and sheds the queued ones;
    * kernels 1 and 2 on NaN-poisoned rows against their plain versions
      (``nan_rows_check``).

    Reports tokens/s with the flag (against ``accurate_tokens_per_s``, no
    gate) and the weight fault's re-capture seconds."""
    import torch

    from repro_torch.core import prepare_params
    from repro_torch.models import get_model
    from repro_torch.obs import ServingObserver
    from repro_torch.resilience import (DelayFault, FaultInjector, NaNCacheFault,
                                        NaNWeightFault, ResilienceConfig, oversized_request)
    from repro_torch.runtime import ControllerConfig, ModeController
    from repro_torch.serve.engine import BatchedServer
    from repro_torch.spec import SpecConfig

    cfg = olmo()
    model = get_model(cfg)
    ctx = kernel_ctx()
    label = "olmo-1b resilient"
    report = dict(config=f"{label}: full width, {cfg.num_layers} layers, kernel mode, FxP8, "
                         f"slots {SLOTS}, burst {BURST}, max_len {MAX_LEN}",
                  accurate_only_tokens_per_s=accurate_tokens_per_s)
    report["nan_rows"] = nan_rows_check(device)
    weights = prepare_params(model.init(torch.Generator(device=device).manual_seed(SEED)),
                             ctx.policy, "kernel", specs=model.specs())
    free_card()

    def serve(**kw):
        return BatchedServer(model, ctx, weights, slots=SLOTS, max_len=MAX_LEN, burst=BURST,
                             device=device, prepare_weights=False, **kw)

    def statuses(server):
        return {rid: (o.status, o.reason, o.tokens) for rid, o in server.outcomes.items()}

    # clean, observed
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    jsonl, chrome = out_dir / "resilience_trace.jsonl", out_dir / "resilience_trace.json"
    observer = ServingObserver(trace_sink=str(jsonl))
    clean = serve(resilience=ResilienceConfig(), observer=observer)
    zero_launches()
    reqs = requests(cfg)
    out, first_run = timed_run(clean, reqs)
    launches, _ = graph_accounting(f"{label} clean", clean, cfg, reqs)
    clean_margins = [r.margins for r in reqs]
    if out != accurate[0] or clean_margins != accurate[1]:
        raise AssertionError(f"{label}: streams or margins differ from the plain server's")
    if any(o.status != "ok" for o in clean.outcomes.values()):
        raise AssertionError(f"{label}: clean outcomes {statuses(clean)}")
    observer.trace.write_jsonl(str(jsonl))
    observer.trace.write_chrome(str(chrome))
    report["trace"] = check_trace_files(jsonl, chrome)
    report["metrics_counters"] = observer.snapshot()["metrics"]["counters"]
    steady_reqs = requests(cfg)
    steady, steady_run = timed_run(clean, steady_reqs)
    if steady != out or [r.margins for r in steady_reqs] != clean_margins:
        raise AssertionError(f"{label}: the steady repeat differs")
    report.update(clean=dict(first_run=first_run, steady_run=steady_run, launches=launches,
                             tokens_per_s=steady_run["tokens_per_s"], identical=True),
                  launches=launches)

    # shedding and deadlines on the clean server: its graphs are captured
    clean.observer = None
    clean.resilience = ResilienceConfig(queue_limit=3)
    shed_out = clean.run(requests(cfg) + [oversized_request(9, MAX_LEN)])
    want = {rid: ("shed", "queue_full", 0) for rid in (3, 4, 5)}
    want[9] = ("shed", "too_long", 0)
    got = statuses(clean)
    if {r: got[r] for r in want} != want or any(shed_out[r] != out[r] for r in (0, 1, 2)):
        raise AssertionError(f"{label}: queue_limit / too_long: {got}")
    clean.resilience = ResilienceConfig(default_deadline_s=0.5)
    clean.injector = FaultInjector(DelayFault(at_round=1, seconds=1.0))
    dl_out = clean.run(requests(cfg))
    got = statuses(clean)
    active, queued = (0, 1, 2, 3), (4, 5)
    if not (all(got[r][:2] == ("expired", "deadline") and 0 < got[r][2] < MAX_NEW
                for r in active)
            and all(got[r] == ("shed", "deadline_expired", 0) for r in queued)
            and all(dl_out[r] == out[r][:len(dl_out[r])] for r in active)):
        raise AssertionError(f"{label}: deadline expiry under DelayFault: {got}")
    report["shedding_and_deadlines"] = dict(queue_limit=3, too_long=9, deadline_s=0.5,
                                            delay_s=1.0, outcomes=got)
    del clean
    free_card()

    # NaN cache fault on request 1 at round 2
    server = serve(resilience=ResilienceConfig(),
                   injector=FaultInjector(NaNCacheFault(rid=1, at_round=2)))
    zero_launches()
    nreqs = requests(cfg)
    nout, _ = timed_run(server, nreqs)
    graph_accounting(f"{label} NaN cache", server, cfg, nreqs)
    others = [r for r in out if r != 1]
    if any(nout[r] != out[r] or nreqs[r].margins != reqs[r].margins for r in others):
        raise AssertionError(f"{label}: a NaN slot changed another request's stream or margins")
    report["nan_cache"] = dict(fault="NaNCacheFault(rid=1, at_round=2)",
                               others_identical=True, outcomes=statuses(server),
                               poisoned_stream_changed=nout[1] != out[1],
                               poisoned_prefix_kept=nout[1][:1 + 2 * BURST]
                               == out[1][:1 + 2 * BURST])
    report["nan_cache"]["card_vs_cpu"] = resilience_card_vs_cpu(device)
    del server, weights
    free_card()

    # NaN weight fault on one point of an adaptive bank
    _, params, bank, _ = make_bank(device, cfg, hifi=False)
    del params
    free_card()
    widths = point_bytes(bank)
    ctrl = ModeController(bank, ControllerConfig(cycle_budget=0.75))
    server = BatchedServer(model, ctx, bank.tree("accurate"), slots=SLOTS, max_len=MAX_LEN,
                           burst=BURST, device=device, controller=ctrl,
                           resilience=ResilienceConfig())
    server.run(requests(cfg))
    graphs_before = frozenset(server.programs.graphs)
    capture_before = dict(server.programs.capture_seconds)
    server.injector = FaultInjector(NaNWeightFault(at_round=1, point=bank.names[0]))
    zero_launches()
    wreqs = requests(cfg)
    wout = server.run(wreqs)
    recaptured = {n: server.programs.capture_seconds[n] for n in server.programs.recaptures}
    if not recaptured or any(not n.endswith(f" @{bank.names[0]}") for n in recaptured):
        raise AssertionError(f"{label}: re-captured graphs {sorted(recaptured)}")
    graph_accounting(f"{label} NaN weights", server, cfg, wreqs, widths=widths,
                     captured_before=graphs_before - set(recaptured))
    del server
    pinned = {}
    for point in bank.names:
        ps = BatchedServer(model, ctx, bank.tree(point), slots=SLOTS, max_len=MAX_LEN,
                           burst=BURST, device=device,
                           controller=ModeController(bank, ControllerConfig(pin=point)))
        preqs = requests(cfg)
        pinned[point] = (ps.run(preqs), [r.margins for r in preqs])
        del ps
    if pinned["accurate"] != (out, clean_margins):
        raise AssertionError(f"{label}: the accurate point changed after the approx point's "
                             "weight fault")
    zero = {r: [0] * MAX_NEW for r in out}
    if pinned[bank.names[0]][0] != zero or any(
            m != [0.0] * MAX_NEW for m in pinned[bank.names[0]][1]):
        raise AssertionError(f"{label}: the poisoned point does not serve all-zero logits")
    report["nan_weights"] = dict(
        fault=f"NaNWeightFault(at_round=1, point={bank.names[0]!r})",
        recaptured_graphs=sorted(recaptured), recapture_s=recaptured,
        first_capture_s={n: capture_before[n] for n in recaptured},
        recapture_s_total=sum(recaptured.values()), outcomes={r: len(v) for r, v in wout.items()},
        accurate_point_unchanged=True, poisoned_point_zero_logits=True)
    del bank
    free_card()

    # speculation: a draft-point weight fault, and a verify fault flag
    _, params, bank, _ = make_bank(device, cfg, hifi=False)
    del params
    spec = BatchedServer(model, ctx, bank.tree("accurate"), slots=SLOTS, max_len=MAX_LEN,
                         device=device, bank=bank, speculate=SpecConfig(draft_len=DRAFT_LEN),
                         resilience=ResilienceConfig(),
                         injector=FaultInjector(NaNWeightFault(at_round=1, point=bank.names[0])))
    sreqs = requests(cfg)
    sout = spec.run(sreqs)
    if sout != out or margins(sreqs) != margins(reqs) or any(
            o.status != "ok" for o in spec.outcomes.values()):
        raise AssertionError(f"{label}: a draft fault changed greedy speculation: "
                             f"{statuses(spec)}")
    spec.injector = None
    inner, calls = spec.spec.round, [0]

    def flagged(*args, **kw):
        res = list(inner(*args, **kw))
        if calls[0] == 1:
            res[4] = res[4].copy()
            res[4][1] = True
        calls[0] += 1
        return tuple(res)

    spec.spec.round = flagged
    vreqs = requests(cfg)
    vout = spec.run(vreqs)
    got = statuses(spec)
    if got[1][:2] != ("faulted", "verify_nonfinite") or any(
            vout[r] != out[r] for r in out if r != 1) or vout[1] != out[1][:len(vout[1])]:
        raise AssertionError(f"{label}: verify fault flag: {got}")
    report["speculation"] = dict(draft_fault="NaNWeightFault(at_round=1, point='approx')",
                                 draft_fault_streams_accurate=True, draft_fault_all_ok=True,
                                 verify_fault="flag set on request 1's lane at round 1",
                                 verify_fault_outcomes=got)
    del spec, bank
    free_card()
    log(f"{label}: clean {steady_run['tokens_per_s']:.2f} tok/s (plain "
        f"{accurate_tokens_per_s}); weight-fault re-capture "
        f"{report['nan_weights']['recapture_s_total']:.3f} s over {len(recaptured)} graphs")
    return report


def free_card():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def arch_phases(device, serving: dict, forward: dict, parity: dict) -> None:
    """The other transformer archs (``ARCH_LAYERS``), each served at full
    width as ``serve_full_width`` serves olmo-1b, internvl2-2b also sampled,
    the ``ARCH_FORWARD`` ones' forwards on the serving weights, the card freed
    between archs; then reduced llama4 card vs CPU. Adds each report to the
    dicts and prints it."""
    for name in ARCH_LAYERS:
        cfg = arch_config(name)
        serving[name], streams, _, weights = phase(f"serve {name}", serve_full_width, device,
                                                    name, cfg)
        serving[name]["weights"] = weight_reckoning(cfg)
        emit({"serving": serving[name]})
        if name == "internvl2-2b":  # sampled over the odd vocabulary
            serving[f"{name} sampled"] = phase(f"serve {name} sampled", serve_sampled, device,
                                               cfg, weights, streams)
            emit({"serving": serving[f"{name} sampled"]})
        if name in ARCH_FORWARD:
            forward[name] = phase(f"forward {name}", forward_phase, device, name, cfg, weights,
                                  ARCH_FORWARD[name])
            emit({"forward": forward[name]})
        del weights
        free_card()
    parity["llama4-maverick"] = phase("llama4-maverick card vs cpu", llama4_card_vs_cpu,
                                      device)
    emit({"card_vs_cpu": parity["llama4-maverick"]})


def scan_config(name: str):
    """One of the scan archs at stock widths, f32, its depth cut to
    ``SCAN_ARCH_LAYERS``."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(name), dtype="float32")
    if SCAN_ARCH_LAYERS[name]:
        cfg = dataclasses.replace(cfg, num_layers=SCAN_ARCH_LAYERS[name])
    return cfg


def scan_phases(device, serving: dict, forward: dict, parity: dict) -> None:
    """The recurrent and encoder-decoder archs (``SCAN_ARCH_LAYERS``), each
    served at full width as ``serve_full_width`` serves olmo-1b, through the
    scan prefill; mamba2 also sampled; each one's ``SCAN_FORWARD`` forward on
    the serving weights, the card freed between archs; then each reduced,
    card vs CPU. Adds each report to the dicts and prints it."""
    for name in SCAN_ARCH_LAYERS:
        cfg = scan_config(name)
        serving[name], streams, _, weights = phase(f"serve {name}", serve_full_width, device,
                                                    name, cfg)
        serving[name]["weights"] = weight_reckoning(cfg)
        emit({"serving": serving[name]})
        if name == "mamba2-780m":
            serving[f"{name} sampled"] = phase(f"serve {name} sampled", serve_sampled, device,
                                               cfg, weights, streams)
            emit({"serving": serving[f"{name} sampled"]})
        forward[name] = phase(f"forward {name}", forward_phase, device, name, cfg, weights,
                              SCAN_FORWARD[name])
        emit({"forward": forward[name]})
        del weights
        free_card()
    for name in SCAN_ARCH_LAYERS:
        parity[name] = phase(f"{name} card vs cpu", scan_card_vs_cpu, device, name)
        emit({"card_vs_cpu": parity[name]})


def phase(name: str, fn, *args, **kw):
    """Run one phase of ``main``: ``fn(*args, **kw)``. On an exception it
    prints one stdout line ``{"failed_phase": name, "error": "<type>:
    <first 300 characters>"}`` and the traceback on stderr, and re-raises,
    so the run stops there with a non-zero exit code."""
    t0 = time.perf_counter()
    log(f"phase {name}")
    try:
        out = fn(*args, **kw)
    except BaseException as e:
        emit({"failed_phase": name, "error": f"{type(e).__name__}: {str(e)[:300]}"})
        traceback.print_exc(file=sys.stderr)
        raise
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


PHASE_GROUPS = ("kernels", "olmo", "bank", "resilience", "parity", "deepseek", "archs", "scan")


def main(argv=()) -> int:
    """Every phase, with no arguments; ``--phases`` runs the named groups of
    ``PHASE_GROUPS`` only (a quicker check while working on one path; "bank"
    and "resilience" need "olmo"), writes their report and prints no
    ``kernels`` and no ``ok`` line."""
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="on-card smoke test of the PyTorch/CUDA port")
    ap.add_argument("--phases", default=None,
                    help=f"comma-separated groups of {PHASE_GROUPS} (default: all)")
    args = ap.parse_args(list(argv))
    groups = None if args.phases is None else set(args.phases.split(","))
    if groups is not None and not groups <= set(PHASE_GROUPS):
        ap.error(f"--phases takes groups of {PHASE_GROUPS}")
    if groups is not None and groups & {"bank", "resilience"}:
        groups.add("olmo")

    def want(group: str) -> bool:
        return groups is None or group in groups

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import _build
    from repro_torch.models import get_model

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase("device", nvidia_smi)
    phase("build", _build.build_all)
    device_line = dict(
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=_build.build_info["seconds"],
        ptxas={name: _build.ptxas_summary(name) for name in _build.build_info["ptxas"]},
    )
    emit({"device": device_line})

    checks, paths, serving, forward, parity = {}, {}, {}, {}, {}
    calibration = order = None
    if want("kernels"):
        fused_rows, fused_err = phase("check_fused", check_fused, device)
        hifi_rows, _ = phase("check_fused_hifi", check_fused_hifi, device)
        plan_rows = phase("plan_alternatives", plan_alternatives, device)
        attn_rows, attn_err = phase("check_attention", check_attention, device)
        gqa_plan_rows = phase("gqa_path_alternatives", gqa_path_alternatives, device)
        mla_rows, mla_err = phase("check_mla", check_mla, device)
        af_rows = phase("check_af", check_af, device)
        mac_rows = phase("check_mac", check_mac, device)
        softmax_rows = phase("check_softmax", check_softmax, device)
        flash_rows, flash_err = phase("check_flash", check_flash, device)
        mla_flash_rows, mla_flash_err = phase("check_mla_flash", check_mla_flash, device)
        checks = {"fused_dot_af": fused_rows, "fused_dot_af_fxp16": hifi_rows,
                  "plan_alternatives": plan_rows, "cordic_mac": mac_rows,
                  "gqa_decode_attention": attn_rows, "gqa_path_alternatives": gqa_plan_rows,
                  "mla_decode_attention": mla_rows,
                  "af_elementwise": af_rows, "af_softmax": softmax_rows,
                  "flash_attention": flash_rows, "mla_flash_attention": mla_flash_rows}
        emit({"kernel_checks": checks})
        free_card()
        paths["softmax activate"] = phase("softmax_path", softmax_path, device)
        emit({"softmax_path": paths["softmax activate"]})

    if want("olmo"):
        serving["olmo-1b"], streams, olmo_margins, weights = phase(
            "serve olmo-1b", serve_full_width, device, "olmo-1b", olmo())
        emit({"serving": serving["olmo-1b"]})
    if want("olmo") and groups is None:
        forward["olmo-1b"] = phase("forward olmo-1b", forward_phase, device, "olmo-1b", olmo(),
                                   weights, (2, BUCKET))
        emit({"forward": forward["olmo-1b"]})
        serving["olmo-1b sampled"] = phase("serve olmo-1b sampled", serve_sampled, device,
                                           olmo(), weights, streams)
        emit({"serving": serving["olmo-1b sampled"]})
    if want("olmo"):
        del weights
        free_card()
    if want("bank"):
        # runtime-adaptive precision and self-speculative serving, held
        # against the accurate-only run above
        serving["olmo-1b adaptive"] = phase("adaptive olmo-1b", adaptive_phases, device,
                                            (streams, olmo_margins))
        emit({"serving": serving["olmo-1b adaptive"]})
        free_card()
        serving["olmo-1b speculative"] = phase(
            "speculative olmo-1b", spec_phases, device, (streams, olmo_margins),
            serving["olmo-1b"]["tokens_per_s"])
        emit({"serving": serving["olmo-1b speculative"]})
        free_card()
    if want("resilience"):
        # fault-tolerant, observed serving, held against the plain run above
        serving["olmo-1b resilient"] = phase(
            "resilient olmo-1b", resilience_phases, device, (streams, olmo_margins),
            serving["olmo-1b"]["tokens_per_s"])
        emit({"serving": serving["olmo-1b resilient"]})
        free_card()
    if want("olmo") and groups is None:
        order = phase("replay order", replay_order, device)
        emit({"replay_order": order})
        free_card()
        # per call at PER_CALL_LAYERS, held against a prepared run of the same
        # weights at that depth
        serving[f"olmo-1b {PER_CALL_LAYERS} layers"], cut_streams, cut_margins, _ = phase(
            f"serve olmo-1b {PER_CALL_LAYERS} layers", serve_full_width, device,
            f"olmo-1b {PER_CALL_LAYERS} layers", olmo(PER_CALL_LAYERS))
        emit({"serving": serving[f"olmo-1b {PER_CALL_LAYERS} layers"]})
        free_card()
        serving["olmo-1b per-call"], *_ = phase(
            "serve olmo-1b per-call", serve_full_width, device, "olmo-1b", olmo(PER_CALL_LAYERS),
            prepared_run=(cut_streams, cut_margins))
        emit({"serving": serving["olmo-1b per-call"]})
        free_card()
        calibration, policy = phase("calibrate olmo-1b", calibrate_full_width, device)
        emit({"calibration": calibration})
        free_card()
        serving["olmo-1b calibrated"], *_ = phase(
            "serve olmo-1b calibrated", serve_full_width, device, "olmo-1b calibrated", olmo(),
            policy=policy)
        emit({"serving": serving["olmo-1b calibrated"]})
        free_card()
    if want("parity"):
        parity["olmo-1b"] = phase("olmo-1b card vs cpu", olmo_card_vs_cpu, device)
        emit({"card_vs_cpu": parity["olmo-1b"]})
        parity["olmo-1b per-call"] = phase("olmo-1b per-call card vs cpu",
                                           olmo_per_call_card_vs_cpu, device)
        emit({"card_vs_cpu": parity["olmo-1b per-call"]})
        cfg = olmo(layers=2)
        parity["olmo-1b forward"] = phase(
            "olmo-1b forward card vs cpu", forward_card_vs_cpu, device,
            "olmo-1b full width, 2 layers, forward", cfg,
            get_model(cfg).init(torch.Generator(device="cpu").manual_seed(SEED)), (2, 70))
        emit({"card_vs_cpu": parity["olmo-1b forward"]})
        bank_parity_phases(device, parity)
        free_card()
    if want("deepseek"):
        serving["deepseek-v3-671b"], _, _, weights = phase(
            "serve deepseek-v3-671b", serve_full_width, device, "deepseek-v3-671b", deepseek())
        emit({"serving": serving["deepseek-v3-671b"]})
        free_card()
        # the serving weights: 63 GB of f32 are not built twice
        forward["deepseek-v3-671b"] = phase("forward deepseek-v3-671b", forward_phase, device,
                                            "deepseek-v3-671b", deepseek(), weights, (1, BUCKET))
        emit({"forward": forward["deepseek-v3-671b"]})
        del weights
        free_card()
        parity["deepseek-v3-671b"] = phase("deepseek-v3-671b card vs cpu", deepseek_card_vs_cpu,
                                           device)
        emit({"card_vs_cpu": parity["deepseek-v3-671b"]})
        cfg = reduced(get_config("deepseek-v3-671b"), layers=4)
        parity["deepseek-v3-671b forward"] = phase(
            "deepseek-v3-671b forward card vs cpu", forward_card_vs_cpu, device,
            "deepseek-v3-671b reduced, 4 layers, forward", cfg, scaled_init(get_model(cfg)),
            (2, 70))
        emit({"card_vs_cpu": parity["deepseek-v3-671b forward"]})
        free_card()
        serving["deepseek-v3-671b speculative"] = phase(
            "speculative deepseek-v3-671b", spec_bitwise, device, "deepseek-v3-671b", deepseek())
        emit({"serving": serving["deepseek-v3-671b speculative"]})
        free_card()
    if want("archs"):
        arch_phases(device, serving, forward, parity)
        free_card()
        serving["qwen3-8b speculative"] = phase("speculative qwen3-8b", spec_bitwise, device,
                                                "qwen3-8b", arch_config("qwen3-8b"))
        emit({"serving": serving["qwen3-8b speculative"]})
        free_card()
    if want("scan"):
        scan_phases(device, serving, forward, parity)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    if groups is not None:
        (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
            device=device_line, phases=sorted(groups), kernel_checks=checks, serving=serving,
            forward=forward, card_vs_cpu=parity), indent=1))
        log(f"chip_smoke: groups {sorted(groups)} done")
        return 0
    paths.update(serving)
    paths.update({f"{label} forward": rep for label, rep in forward.items()})
    paths["olmo-1b calibration"] = calibration

    def launches(name):
        by_path = {label: rep["launches"][name] for label, rep in paths.items()
                   if rep["launches"].get(name)}
        return sum(by_path.values()), by_path

    def kernel_rows():
        """The ``kernels`` line's rows; every kernel must have launched on a
        driven path."""
        rep_f = next(r for r in fused_rows if (r["M"], r["K"], r["N"], r["af"]) ==
                     (SLOTS, 2048, 8192, "identity"))
        rep_mac = next(r for r in mac_rows if (r["M"], r["K"], r["N"], r["case"]) ==
                       (SLOTS, 2048, 8192, "fxp8"))
        rep_af = next(r for r in af_rows if (r["where"], r["fmt"], r["mode"]) ==
                      ("decode", "Q1.6", "swish"))
        rep_sm = next(r for r in softmax_rows if (r["shape"], r["fmt"]) == ([SLOTS, 50304], "Q1.6"))
        rep_fl, rep_mf = flash_rows[0], mla_flash_rows[0]  # the forward phases' shapes
        kernels = []
        for name, file, replaces, err, rep, lib in (
                ("fused_dot_af", "cordic_fused/csrc/cordic_fused.cu", "cordic_fused/kernel.py:104",
                 fused_err, rep_f, None),
                ("cordic_mac", "cordic_mac/csrc/cordic_mac.cu", "cordic_mac/kernel.py:36", 0.0,
                 rep_mac, None),
                ("gqa_decode_attention", "decode_attention/csrc/decode_attention.cu",
                 "decode_attention/kernel.py:40", attn_err, attn_rows[0], attn_rows[0]["sdpa_ms"]),
                ("mla_decode_attention", "decode_attention/csrc/mla_decode.cu",
                 "decode_attention/kernel.py:79", mla_err, mla_rows[0], mla_rows[0]["sdpa_ms"]),
                ("af_elementwise", "cordic_af/csrc/cordic_af.cu", "cordic_af/kernel.py:40", 0.0,
                 rep_af, None),
                ("af_softmax", "cordic_af/csrc/af_softmax.cu", "cordic_af/kernel.py:54", 0.0,
                 rep_sm, None),
                ("flash_attention", "flash_attention/csrc/flash_attention.cu",
                 "flash_attention/kernel.py:34", flash_err, rep_fl, rep_fl["sdpa_ms"]),
                ("mla_flash_attention", "mla_flash/csrc/mla_flash.cu", "mla_flash/kernel.py:36",
                 mla_flash_err, rep_mf, rep_mf["sdpa_ms"])):
            total, by_path = launches(name)
            if not total:
                raise AssertionError(f"{name}: no launch on any driven path")
            kernels.append(dict(name=name, route="cuda", source=f"src/repro_torch/kernels/{file}",
                                replaces=f"src/repro/kernels/{replaces}", launches=total,
                                launches_by_path=by_path, max_abs_err=err, ms=rep["ms"],
                                plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
                                bound_by=rep["bound_by"], library_ms=lib))
        return kernels

    kernels = phase("kernels line", kernel_rows)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        device=device_line, kernel_checks=checks, softmax_path=paths["softmax activate"],
        serving=serving, forward=forward, calibration=calibration, replay_order=order,
        card_vs_cpu=parity, kernels=kernels), indent=1))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
