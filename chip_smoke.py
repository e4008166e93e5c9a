#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Builds every CUDA kernel library from the checkout's sources (the fused
CORDIC dot+AF with its partial-sum and epilogue kernels, the MAC-array
matmul, the GQA and MLA cache-decode attentions, the standalone multi-AF
block and its row softmax, the cache-free flash and MLA flash attentions),
then:

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
   those replays: mamba2-780m (24 of 48 layers, also sampled), zamba2-7b (18 of 81
   layers: two groups of nine Mamba2 layers and the shared attention block,
   GQA at head_dim 112) and seamless-m4t-large-v2 (12 of 24 decoder layers and
   its 24 encoder layers); their
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
13. ``sim_phases``: the PE-array simulator's calibration measured on the
   card at the reference's sizes (each function one CUDA-graph replay),
   saved and loaded back (gate: no fallback); the adaptive olmo-1b CLI
   flow (kernel mode, budget 0.75) traced to JSONL and replayed on the
   analytic array (gates: savings drift within 1e-9, every request and
   token attributed) and on the card's calibration (reported).
14. ``train_phases``: training at full-width olmo-1b (16 layers, f32,
   batch 8 x seq 64, remat on): exact mode 20 steps, the loss falling;
   remat on = off bitwise; a checkpoint at step 3 restored into a fresh
   trainer = the uninterrupted steps 4-6 bitwise; carmen and int8 3 steps
   each, finite; int8's MAC-array launches exact by instantiation, its
   first launches bitwise the plain version on their inputs; ms a step,
   tokens/s and peak GiB by mode.
15. ``analysis_phase`` (right after 3's first run, on its prepared
   weights): the cost analyzer (``launch/cost_analysis.py``) over one
   uncaptured decode step and one 512-row prefill bucket of full-width
   olmo-1b on the card and on meta tensors: the two records equal op for
   op, the kernel calls equal the wrappers' launches and
   ``launches_per_forward``; the predicted against the card's peak memory,
   each kernel's bound (``kernels/costs.py``) against its profiled device
   ms, the decode step's roofline terms and ``measured_share`` against 3's
   captured decode step.
16. ``check_tp_kernels``, ``check_tp_attention`` and ``tp_phases`` (group
   ``tp``): kernel 1's split form for tensor-parallel row products (the
   partial-sum instantiation on the narrow, wgmma and FxP16 imad paths,
   then the epilogue kernel on the int32 sum) bitwise its plain twins and,
   summed over two K halves, the fused kernel over the whole of K, at
   olmo-1b's local row-parallel shapes; the GQA and MLA cache kernels on a
   rank's half of the heads (and slots), their key splits planned from the
   whole counts, bitwise the whole call's rows; kernels 2 and 7 on a
   rank's q heads against the whole kv heads (replicated kv heads: yi-9b at
   a model axis of 8, qwen3-8b at 16), read in place, bitwise the whole
   call's rows and within 2e-5 of their plain versions
   (``check_kv_replicated``); one meshed dry-run cell (rank 0 of the 16x16
   mesh in a fake process group, ``dryrun_mesh_cell``, a subprocess);
   then tensor-parallel serving on spawned ranks that share the card
   (gloo; the server uncaptured): full-width olmo-1b on a (1, 2) mesh, its
   streams, f32 top-2 margins and a flash forward's logits bitwise the
   same server's ``mesh=None`` run, each rank's launches exact by
   instantiation; olmo-1b at 4 layers on (2, 1) (slots and the FSDP
   shards over data) and on (1, 1) under NCCL; llama4's pair and
   deepseek-v3 at (1, 2) with their routed experts cut. Prints a ``tp``
   record (tok/s, collective bytes: a smoke reading, two ranks time-share
   the card and gloo moves every collective through the host).

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

It imports nothing of JAX. It exits non-zero on any failure: its first phase,
``setup``, imports the port from ``src/`` beside the script and fails when
that is missing or no CUDA device is present, printing ``failed_phase`` as
any phase does. A full JSON report goes to ``chiprun_out/chip_smoke.json``.
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Every kernel's bound (the H100's data-sheet peaks and one cost formula a
# kernel) comes from src/repro_torch/kernels/costs.py, which the cost
# analyzer reads too: the 3xTF32 attention kernels run three TF32 products
# for every f32 one (fewer where an operand is bf16, whose lo part is 0), so
# their tensor-core bound is passes x flops at the TF32 rate, beside the
# f32-FMA (or bf16) bound.

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
# through the scan (one single-token step a prompt token): mamba2-780m cut
# from 48 to 24 layers (for the smoke's time, once the tp group came in:
# its two 48-layer runs took 131 s of a 1030 s clean-export run);
# zamba2-7b cut from 81 to 18 layers, two groups of nine Mamba2
# layers with the shared block applied twice (1.84 B params, 7.35 GB of f32;
# all 81 would be 6.75 B and 27.0 GB, which fits one card: the cut is for the
# smoke's time only); seamless-m4t-large-v2 cut from 24 to 12 decoder
# layers, its 24 encoder layers kept (for the smoke's time, once the tp
# group grew by kernel 6's split form and the scan archs: its 24-layer run
# took 68.5 s of a 1058 s clean-export run)
SCAN_ARCH_LAYERS = {"mamba2-780m": 24, "zamba2-7b": 18, "seamless-m4t-large-v2": 12}
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
    every record of a kernel is dropped. A profile with no device kernel at
    all (the profiler recorded no device activity in the window) fails
    naming itself as empty. Returns the calls seen, by instantiation."""
    if not rows and any(ran.values()):
        raise AssertionError(f"{label}: the profile came back empty: no device kernel at all "
                             f"in its window (torch.profiler recorded no device activity), "
                             f"while the wrappers launched {nonzero(ran)}")
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


def check_fused(device):
    import torch

    from repro_torch.core import FXP8, FXP16
    from repro_torch.kernels import costs
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
                b_ms, b_by = costs.fused_dot_af(m, n, k, 1, af, FXP8.frac + 1, FXP8).bound()
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
    from repro_torch.kernels import costs
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
                        b_ms, b_by = costs.fused_dot_af(m, n, k, 2, af, FXP8.frac + 1,
                                                         FXP8).bound()
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
    from repro_torch.kernels import costs

    b, s, h, hd = q.shape
    rows_needed = (pos.max(dim=1).values + 1).clamp(max=t).sum().item()
    scored = (pos.long() + 1).clamp(max=t).sum().item()
    cost = costs.gqa_decode_attention(b, s, h, t, kv, hd, keys=(rows_needed, scored))
    return (*cost.bound(), cost.bound_tf32_ms())


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
    from repro_torch.kernels import costs
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
        cost = costs.mla_decode_attention(b, s, hh, t, rr, rrd, keys=(
            rows_qk.sum().item(), rows_v.sum().item(), seen.sum().item(), mean.sum().item()))
        b_ms, b_by = cost.bound()
        positions = ("decode" if s == 1 else "from row 0" if start == 0
                     else "from a random row, a drained slot and a masked row")
        rows.append(dict(B=b, S=s, T=t, H=hh, R=rr, r=rrd, positions=positions,
                         splits=mla_splits(b, s, hh, t), tolerance=TOLERANCE, max_abs_err=err,
                         ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, sdpa_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, bound_tf32_ms=cost.bound_tf32_ms(),
                         tf32_passes=3))
        log(f"mla B={b} S={s} T={t} H={hh} R={rr} r={rrd} ({positions}): {ms:.4f} ms (eager "
            f"{eager_ms:.4f}, plain {plain_ms:.3f}, sdpa {lib_ms:.4f}, bound {b_ms:.4f} {b_by}) "
            f"err {err:.2e}")
    return rows, max_err


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

    from repro_torch.kernels import costs
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
        # bf16 operands: bounded at the bf16 tensor-core rate; on the TF32
        # units the kernel runs one pass for Q.K^T (both bf16) and two for
        # P.V (P is f32 and split, V is bf16)
        cost = costs.flash_attention(b, s, h, kv, d, q.element_size(), causal)
        b_ms, b_by = cost.bound()
        passes, b3_ms = cost.tf32_passes, cost.bound_tf32_ms()
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
    from repro_torch.kernels import costs
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
        cost = costs.mla_flash_attention(b, s, h, r, rd)
        b_ms, b_by = cost.bound()
        rows.append(dict(B=b, S=s, H=h, R=r, r=rd, causal=True, tolerance=TOLERANCE,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, sdpa_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, bound_tf32_ms=cost.bound_tf32_ms(),
                         tf32_passes=3))
        log(f"mla_flash B={b} S={s} H={h} R={r} r={rd}: {ms:.4f} ms (plain {plain_ms:.3f}, sdpa "
            f"{lib_ms:.4f}, bound {b_ms:.4f} {b_by}) err {err:.2e}")
    return rows, max_err


def check_af(device):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import FXP8, FXP16
    from repro_torch.core.activations import internal_depth
    from repro_torch.core.cordic import full_depth
    from repro_torch.kernels import costs
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
                ops = costs.af_int_ops(mode, internal_depth(depth, fmt))
                b_ms, b_by = costs.af_elementwise(n, mode, depth, fmt).bound()
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

    from repro_torch.kernels import costs
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
    b_ms, b_by = costs.cordic_mac(m, n, k, elem).bound()
    path = path_name(plan(m, n, k, elem, banks[0].element_size()))
    log(f"mac {label} M={m} K={k} N={n} [{path}]: {ms:.4f} ms (eager {eager_ms:.4f}, plain "
        f"{plain_ms:.3f}, int_mm K-major {lib['k_major']} N-major {lib['n_major']}, bound "
        f"{b_ms:.4f} {b_by})")
    return dict(M=m, K=k, N=n, case=label, path=path, bitwise_equal=True, max_abs_err=0.0,
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, int_mm_ms=lib["k_major"],
                int_mm_n_major_ms=lib["n_major"], bound_ms=b_ms, bound_by=b_by)


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
    from repro_torch.kernels import costs
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
            ops = costs.softmax_int_ops(internal_depth(depth, fmt))
            b_ms, b_by = costs.af_softmax(x.numel(), depth, fmt).bound()
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


def launches_per_forward(cfg, per_call: bool = False, mode: str = "kernel") -> dict:
    """Kernel launches one decode forward of ``cfg`` implies, by kernel. Per
    call, every dot is a MAC-array launch and the gate's activation its own
    multi-AF launch. In the ``exact`` and ``carmen`` modes (dense archs) the
    dots are f32 products and the activation plain torch, so only the cache
    attention launches; in ``int8`` mode every dot, prepared or per call, is
    a MAC-array launch. A Mamba2 layer runs two fused dots (in_proj, out_proj);
    zamba2's shared block seven (q k v o, up gate down) and one GQA launch a
    group; a seamless decoder layer eight (self q k v o, cross q o: the
    cross K/V are cached, up down) and one GQA launch (cross-attention is
    plain)."""
    if mode != "kernel":
        if cfg.family != "dense":
            raise NotImplementedError("the exact, carmen and int8 modes are driven for the "
                                      "dense family only")
        want = {"gqa_decode_attention": cfg.num_layers}
        if mode == "int8":
            want["cordic_mac"] = 7 * cfg.num_layers + 1
        return want
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
    inst = {"fused_dot_af": dot, "cordic_mac": dot, "fused_dot_partial": dot,
            "fused_epilogue": "elementwise", "cordic_mac_partial": dot,
            "cordic_mac_epilogue": "elementwise", "mla_decode_attention": "tc",
            "gqa_decode_attention": "tc" if s >= TC_MIN_S else "split",
            "af_elementwise": "elementwise", "af_softmax": "cluster", "flash_attention": "tc",
            "mla_flash_attention": "tc"}
    return {f"{k}/{inst[k]}": n * times for k, n in per_kernel.items()}


def add_counts(total: dict, more: dict) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def serving_instantiations(cfg, server, reqs, per_call: bool = False,
                           mode: str = "kernel") -> dict:
    """Launches by instantiation that serving ``reqs`` implies: one forward
    per request over its prompt's bucket (the scan: one single-row forward
    per prompt token), and the run's decode steps over the server's slots,
    one query row each."""
    from repro_torch.serve.kvcache import bucket_length

    per_forward = launches_per_forward(cfg, per_call, mode)
    want = by_instantiation(per_forward, server.slots, 1, server.decode_steps)
    if scan_prefill(cfg):
        return add_counts(want, by_instantiation(per_forward, 1, 1,
                                                 sum(len(r.prompt) for r in reqs)))
    for r in reqs:
        b = bucket_length(len(r.prompt), server.max_len)
        add_counts(want, by_instantiation(per_forward, b, b))
    return want


def batch_groups(n: int) -> int:
    """The products a batched f32 product over ``n`` experts or MLA heads
    runs as on the card (``blocks.batch_grouped``: groups of
    ``BATCH_GROUP``, so a mesh rank's share of them gets the same bits)."""
    from repro_torch.models.blocks import BATCH_GROUP

    return n // BATCH_GROUP if n % BATCH_GROUP == 0 and n != BATCH_GROUP else 1


def plain_products_per_forward(cfg, cache_free: bool = False) -> int:
    """Products the reference leaves to XLA outside any kernel, which the port
    leaves to torch.einsum: MLA's wk_b/wv_b absorptions, the MoE router and
    its three expert einsums (the absorptions and expert products each in
    ``batch_groups`` products); a Mamba2 layer's conv window, state update
    and readout at decode, its SSD's four chunk products in a cache-free
    pass; seamless's two cross-attention products a decoder layer."""
    mamba = {"ssm": cfg.num_layers, "hybrid": cfg.num_layers}.get(cfg.family, 0)
    cross = 2 * cfg.num_layers if cfg.family == "audio" else 0
    experts = batch_groups(cfg.moe.num_experts) if cfg.moe else 1
    return (2 * cfg.num_layers * bool(cfg.mla) * batch_groups(cfg.num_heads)
            + (1 + 3 * experts) * moe_layers(cfg) + (4 if cache_free else 3) * mamba + cross)


def model_forwards(server) -> int:
    """The model forwards a run made: prefills (one each when bucketed, one
    per prompt token through the scan), the streaming frontend's chunks (one
    forward a chunk when bucketed; the scan's are its steps), decode steps
    (a speculative round's draft steps among them) and a speculative round's
    verify."""
    prefill = (server.prefill_calls + server.prefill_chunks if server.batched_prefill
               else server.prefill_steps)
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


def program_launches(name: str, server, cfg, per_call: bool = False, widths=None,
                     mode: str = "kernel") -> dict:
    """Launches by instantiation that one capture of program ``name``
    implies: a prefill bucket ``b`` or a frontend chunk bucket ``b``
    (``"prefill_chunk b"``), one forward over ``b`` rows; the scan prefill's
    step, one forward over one row, its finish and the chunked prefill's
    admit none; a burst,
    ``burst`` forwards over the slots; a speculative draft (either variant),
    ``draft_len`` forwards over the slots, its verify one forward of
    ``draft_len + 1`` query rows a slot. A name ``"<program> @<point>"`` runs at that bank
    point, its dots on the banks of ``widths[point]`` bytes."""
    per_forward = launches_per_forward(cfg, per_call, mode)
    base, _, point = name.partition(" @")
    w = (widths or {}).get(point, 1)
    if base.startswith("burst"):
        return by_instantiation(per_forward, server.slots, 1, server.burst, w)
    if base == "prefill step":
        return by_instantiation(per_forward, 1, 1, 1, w)
    if base in ("prefill finish", "prefill admit"):
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
                     captured_before=frozenset(), widths=None, mode: str = "kernel") -> tuple:
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
    per_forward = launches_per_forward(cfg, per_call, mode)
    issued = {}
    for name, captured in runner.captured_launches.items():
        if name in captured_before:
            continue
        want = program_launches(name, server, cfg, per_call, widths, mode)
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
                             serving_instantiations(cfg, server, reqs, per_call, mode))
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


def uncaptured_accounting(label, server, cfg, reqs, per_call: bool = False,
                          mode: str = "kernel") -> dict:
    """The launch counts of an uncaptured run (every launch issued from the
    host), by kernel and by instantiation, exactly as serving ``reqs``
    implies; no graph replayed."""
    from repro_torch.kernels import kernel_totals

    counts = wrapper_counts()
    launches = check_launches(label, kernel_totals(counts),
                              launches_per_forward(cfg, per_call, mode),
                              times=model_forwards(server))
    check_instantiations(label, counts, serving_instantiations(cfg, server, reqs, per_call,
                                                               mode))
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


def analysis_phase(device, weights, serving) -> dict:
    """The cost analyzer (``launch/cost_analysis.py``) on the path the fused
    kernel and GQA decode carry: full-width olmo-1b (16 layers, f32, kernel
    mode, the serving phase's prepared ``weights``), one uncaptured decode
    step of ``SLOTS`` slots and one ``BUCKET``-row prefill bucket into a
    ``MAX_LEN`` row cache (the decode step at its last row, so that every
    query scores every key, as the formulas count at the cache length),
    each eager on the card under the analyzer and the profiler (after one
    warm-up step), and the same step on meta tensors.

    Gates: the card's record and the meta record are equal op for op (op,
    shapes, dtypes, flops, bytes, kernel and instantiation); the kernel
    calls equal the wrappers' launch counts for the card step and
    ``launches_per_forward`` by instantiation. Reported: the memory the
    analyzer predicts against ``torch.cuda.max_memory_allocated``; each
    kernel's bound from its formula against its device ms in the profile
    (``port_kernel_ms``); and the decode step's roofline terms, their bound
    over the captured decode step the serving phase timed
    (``decode_ms_per_step``), and ``roofline.measured_share`` of that step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import prepare_params
    from repro_torch.launch import cost_analysis, roofline
    from repro_torch.launch.dryrun import record_costs
    from repro_torch.models import get_model
    from repro_torch.serve.kvcache import with_cache_positions

    cfg = olmo()
    model = get_model(cfg)
    ctx = kernel_ctx()
    meta_weights = prepare_params(model.abstract_params(), ctx.policy, "kernel",
                                  specs=model.specs())
    per_forward = launches_per_forward(cfg)
    gen = torch.Generator().manual_seed(SEED + 11)
    report = dict(config="olmo-1b full width, 16 layers, dtype float32, kernel mode (prepared "
                         "weights), FxP8 accurate, attn_impl=decode_kernel, uncaptured",
                  slots=SLOTS, max_len=MAX_LEN, steps={})
    for name, rows, s in (("decode", SLOTS, 1), (f"prefill {BUCKET}", 1, BUCKET)):
        tokens = torch.randint(0, cfg.vocab_size, (rows, s), generator=gen,
                               dtype=torch.int32).to(device)
        model.decode_step(weights, tokens, model.make_cache(rows, MAX_LEN, device=device), ctx)
        cache = model.make_cache(rows, MAX_LEN, device=device)
        if s == 1:  # a decode step at a full cache: its queries score every key
            with_cache_positions(cache, torch.full((rows,), MAX_LEN - 1, dtype=torch.int32,
                                                   device=device))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        card = cost_analysis.Analyzer()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            card.run(model.decode_step, weights, tokens, cache, ctx)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        card_peak = torch.cuda.max_memory_allocated()
        launched = nonzero(wrapper_counts())
        del cache
        meta = cost_analysis.Analyzer()
        t0 = time.perf_counter()
        meta.run(model.decode_step, meta_weights,
                 torch.empty((rows, s), dtype=torch.int32, device="meta"),
                 model.make_cache(rows, MAX_LEN, device="meta"), ctx)
        meta_s = time.perf_counter() - t0
        diff = cost_analysis.first_difference(card.records, meta.records)
        if diff is not None:
            raise AssertionError(f"analysis {name}: the card's and the meta record differ: "
                                 f"{diff[:600]}")
        costs = meta.costs()
        want = by_instantiation(per_forward, rows * s, s)
        if card.costs().kernels != launched or costs.kernels != want \
                or costs.kernel_totals() != per_forward:
            raise AssertionError(f"analysis {name}: kernel calls {costs.kernels}, the card's "
                                 f"wrappers launched {launched}, launches_per_forward implies "
                                 f"{want}")
        port = port_kernel_ms(kernel_breakdown(prof))
        kernels = []
        for key, calls in sorted(costs.kernels.items()):
            bound_ms = sum(r["bound_ms"] for r in meta.records
                           if "kernel" in r and f"{r['kernel']}/{r['inst']}" == key)
            seen = port.get(GLOBALS[key], {})
            kernels.append(dict(instantiation=key, kernel=GLOBALS[key], calls=calls,
                                bound_ms=bound_ms, device_ms=seen.get("device_ms"),
                                profiled_calls=seen.get("calls"),
                                bound_share=bound_ms / seen["device_ms"] if seen else None))
        mem = meta.memory()
        rec = dict(arch="olmo-1b", shape=f"serving {name}", seq_len=MAX_LEN if s == 1 else s,
                   global_batch=rows, kind="decode" if s == 1 else "prefill", mesh="none",
                   mode="kernel", status="ok")
        record_costs(rec, costs)
        step = dict(ops=len(meta.records), meta_analysis_s=meta_s, card_wall_ms=wall_ms,
                    flops=costs.dot_flops, hbm_bytes=costs.hbm_bytes,
                    hbm_bytes_upper=costs.hbm_bytes_upper, ops_by_kind=costs.ops_by_kind,
                    kernel_calls=costs.kernels, records_equal=True,
                    memory=dict(mem, predicted_peak_bytes=mem["argument_size_in_bytes"]
                                + mem["temp_size_in_bytes"], card_allocated_before=before,
                                card_max_allocated=card_peak,
                                card_step_bytes=card_peak - before),
                    kernels=kernels,
                    other_port_kernels={k: v for k, v in port.items()
                                        if k not in {g for g in GLOBALS.values()}})
        if s == 1:  # against the captured decode step the serving phase timed
            step_s = serving["decode_ms_per_step"] / 1e3
            terms = roofline.terms(rec)
            step.update(roofline=terms, measured_decode_ms=serving["decode_ms_per_step"],
                        bound_over_measured=terms["step_s"] / step_s,
                        measured_share=roofline.measured_share(rec, step_s))
        report["steps"][name] = step
        log(f"analysis {name}: {len(meta.records)} records equal card/meta, flops "
            f"{costs.dot_flops:.4g}, hbm {costs.hbm_bytes:.4g} B, predicted peak "
            f"{step['memory']['predicted_peak_bytes']}, card {card_peak}")
    del meta_weights
    free_card()
    return report


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


def card_vs_cpu(device, label, cfg, params, lens, max_len, prepare_weights=True, ctx=None):
    """The same weights served on the card (kernels) and the CPU (plain
    versions), in kernel mode unless ``ctx`` says otherwise; the greedy
    streams must be identical."""
    import torch

    from repro_torch.models import get_model
    from repro_torch.serve.engine import BatchedServer

    model = get_model(cfg)
    reqs = lambda: requests(cfg, lens=lens, max_new=8)  # noqa: E731
    out, logits = {}, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        server = BatchedServer(model, ctx or kernel_ctx(), params, slots=2, max_len=max_len,
                               burst=4, device=dev, prepare_weights=prepare_weights)
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


# -- the streaming frontend (chunked prefill) and the exact / carmen / int8 modes -------------

# the frontend's prefill budget a tick (the CLI's --chunk-tokens default)
CHUNK_TOKENS = 32
# the Poisson arrivals of the frontend's arrival run: requests a second and
# the arrival process's seed (the CLI's --arrival-rate, --arrival-seed)
ARRIVAL_RATE, ARRIVAL_SEED = 20.0, 0
# the request whose prefill the decoding slots' inter-token gaps are
# measured across: the 300-token prompt
LONG_RID = PROMPT_LENS.index(300)
# a chunked stream's f32 top-2 margins against run()'s: a chunk whose query
# rows take the other GQA path than its monolithic bucket could agree to
# reduction-order ulps, not bits (reported either way; measured bitwise at
# olmo-1b). Not gated for MoE archs: a chunk of at most 64 rows routes
# dropless, as the reference's decode step does, where a long prompt's
# bucket drops tokens past its experts' capacity
MARGIN_ATOL = 1e-4
MODES = ("exact", "carmen", "int8")
# the uncaptured yardstick of a mode serves each request this many tokens
# (the heads of the captured streams): carmen and int8 run the multi-AF
# block as plain torch ops, ~10 tok/s issued from the host
MODE_UNCAPTURED_HEAD = 9
# the GQA and MLA chunk rows: query rows a chunk and chunk starts on the row cache
CHUNK_S, CHUNK_STARTS = (1, 4, 16, 32), (64, 130, 288)
MLA_CHUNK_S, MLA_CHUNK_STARTS = (4, 16, 32), (130, 288)


def check_chunk_attention(device):
    """The GQA cache attention (olmo-1b widths) and the MLA cache attention
    (deepseek-v3 widths) on a chunked prefill's rows: one request's row
    cache (B1, T512), S query rows from a nonzero start (GQA: 1, 4, 16, 32
    from 64, 130 and 288; MLA: 4, 16, 32 from 130 and 288), each within
    TOLERANCE of its plain version; on split keys (below 16 rows) each row
    bit for bit the single-row call of its position. Times, bounds and
    SDPA's time as ``check_attention``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import costs
    from repro_torch.kernels.decode_attention import (
        TOLERANCE, gqa_decode_attention, gqa_decode_attention_ref, mla_decode_attention,
        mla_decode_attention_ref)
    from repro_torch.kernels.decode_attention.ops import SPLIT_KEYS, gqa_plan, mla_splits

    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    rows, max_err, t = [], 0.0, MAX_LEN

    def rows_bitwise(name, call, args, rowwise):
        """Each query row of ``call(*args)`` bitwise the call on that row
        alone (the arguments at ``rowwise`` sliced to it)."""
        block = call(*args)
        for j in range(args[0].shape[1]):
            alone = call(*(a[:, j:j + 1].contiguous() if i in rowwise else a
                           for i, a in enumerate(args)))
            if not torch.equal(alone[:, 0], block[:, j]):
                raise AssertionError(f"{name}: chunk row {j} differs from its single-row call")

    def checked(name, got, want, label):
        err = (got - want).abs().max().item()
        if not err <= TOLERANCE:
            raise AssertionError(f"{name} vs plain: max|diff| {err} > {TOLERANCE} at {label}")
        return err

    for start in CHUNK_STARTS:
        for s in CHUNK_S:
            h = kv = 16
            hd = 128
            q, ck, cv, _ = attention_case(1, s, t, h, kv, hd, gen, device)
            pos = (start + torch.arange(s, device=device, dtype=torch.int32))[None].contiguous()
            scale = 1.0 / math.sqrt(hd)
            call = lambda q=q, ck=ck, cv=cv, pos=pos: gqa_decode_attention(  # noqa: E731
                q, ck, cv, pos, scale=scale)
            err = checked("gqa_decode_attention", call(),
                          gqa_decode_attention_ref(q, ck, cv, pos, scale=scale),
                          f"S={s} from {start}")
            max_err = max(max_err, err)
            path, splits = gqa_plan(1, s, h, t, kv)
            if path == SPLIT_KEYS:
                rows_bitwise("gqa_decode_attention",
                             lambda *a: gqa_decode_attention(*a, scale=scale), (q, ck, cv, pos),
                             (0, 3))
            qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, ck, cv))
            mask = (torch.arange(t, device=device)[None, None, :] <= pos[:, :, None])[:, None]
            b_ms, b_by, b3_ms = attention_bounds(q, kv, t, pos)
            rows.append(dict(kernel="gqa_decode_attention", B=1, S=s, T=t, H=h, KV=kv, hd=hd,
                             start=start, path=path, splits=splits, tolerance=TOLERANCE,
                             max_abs_err=err, rows_equal_single_row_calls=path == SPLIT_KEYS,
                             ms=graph_ms(call, 100),
                             plain_ms=timed_ms(lambda: gqa_decode_attention_ref(
                                 q, ck, cv, pos, scale=scale), iters=20),
                             sdpa_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                                 qt, kt, vt, attn_mask=mask, scale=scale), 100),
                             bound_ms=b_ms, bound_by=b_by, bound_tf32_ms=b3_ms))
            log(f"gqa chunk S={s} from {start} [{path}, {splits} splits]: "
                f"{rows[-1]['ms']:.4f} ms (plain {rows[-1]['plain_ms']:.3f}, sdpa "
                f"{rows[-1]['sdpa_ms']:.4f}, bound {b_ms:.4f} {b_by}) err {err:.2e}")
    cfg = get_config("deepseek-v3-671b")
    m = cfg.mla
    h, r, rd = cfg.num_heads, m.kv_lora_rank, m.qk_rope_head_dim
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + rd)
    for start in MLA_CHUNK_STARTS:
        for s in MLA_CHUNK_S:
            args = (torch.randn((1, s, h, r), generator=gen, device=device),
                    torch.randn((1, s, h, rd), generator=gen, device=device),
                    torch.randn((1, t, r), generator=gen, device=device),
                    torch.randn((1, t, rd), generator=gen, device=device),
                    (start + torch.arange(s, device=device, dtype=torch.int32))[None].contiguous())
            call = lambda args=args: mla_decode_attention(*args, scale=scale)  # noqa: E731
            got = call()
            err = checked("mla_decode_attention", got,
                          mla_decode_attention_ref(*args, scale=scale), f"S={s} from {start}")
            max_err = max(max_err, err)
            if s < 16:
                rows_bitwise("mla_decode_attention",
                             lambda *a: mla_decode_attention(*a, scale=scale), args, (0, 1, 4))
            ql, qr, ck, kr, pos = args
            seen, scored = start + s, sum(start + j + 1 for j in range(s))
            cost = costs.mla_decode_attention(1, s, h, t, r, rd,
                                              keys=(seen, seen, scored, scored))
            b_ms, b_by = cost.bound()
            q_cat = torch.cat([ql, qr], -1).transpose(1, 2).contiguous()
            k_cat, v = torch.cat([ck, kr], -1)[:, None], ck[:, None]
            mask = (torch.arange(t, device=device)[None, None, :] <= pos[:, :, None])[:, None]
            rows.append(dict(kernel="mla_decode_attention", B=1, S=s, T=t, H=h, R=r, r=rd,
                             start=start, splits=mla_splits(1, s, h, t), tolerance=TOLERANCE,
                             max_abs_err=err, rows_equal_single_row_calls=s < 16,
                             ms=graph_ms(call, 100),
                             plain_ms=timed_ms(lambda: mla_decode_attention_ref(
                                 *args, scale=scale), iters=5),
                             sdpa_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                                 q_cat, k_cat, v, attn_mask=mask, scale=scale,
                                 enable_gqa=True), 20),
                             bound_ms=b_ms, bound_by=b_by, bound_tf32_ms=cost.bound_tf32_ms()))
            log(f"mla chunk S={s} from {start} [{rows[-1]['splits']} splits]: "
                f"{rows[-1]['ms']:.4f} ms (plain {rows[-1]['plain_ms']:.3f}, sdpa "
                f"{rows[-1]['sdpa_ms']:.4f}, bound {b_ms:.4f} {b_by}) err {err:.2e}")
    return rows, max_err


def chunk_rows_as_prefill(device) -> list:
    """A chunk's rows against the same rows of run()'s prefill bucket (B1,
    512 rows from row 0, the tensor cores), GQA at olmo-1b widths and MLA at
    deepseek-v3 widths: rows from 130 and 288 at 16 rows (the bucket
    ``BatchedServer.chunk_span`` gives a chunk of a prompt whose own bucket
    is 16 or more) bit for bit the prefill's, gated; at 4 rows (split keys,
    the chunk's own bucket) the difference is reported."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import gqa_decode_attention, mla_decode_attention
    from repro_torch.serve.engine import _TC_ROWS

    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    t = MAX_LEN
    q, ck, cv, pos = attention_case(1, t, t, 16, 16, 128, gen, device, start=0)
    m = get_config("deepseek-v3-671b").mla
    h = get_config("deepseek-v3-671b").num_heads
    mla = [torch.randn(shape, generator=gen, device=device)
           for shape in ((1, t, h, m.kv_lora_rank), (1, t, h, m.qk_rope_head_dim),
                         (1, t, m.kv_lora_rank), (1, t, m.qk_rope_head_dim))]
    mla_scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    cases = (("gqa_decode_attention", (q,),
              lambda q, p: gqa_decode_attention(q, ck, cv, p, scale=1.0 / math.sqrt(128))),
             ("mla_decode_attention", mla[:2],
              lambda ql, qr, p: mla_decode_attention(ql, qr, mla[2], mla[3], p,
                                                     scale=mla_scale)))
    rows = []
    for name, qs, call in cases:
        whole = call(*qs, pos)
        for start in (130, 288):
            for s in (_TC_ROWS, 4):
                part = call(*(x[:, start:start + s].contiguous() for x in (*qs, pos)))
                want = whole[:, start:start + s]
                rows.append(dict(kernel=name, start=start, S=s, bitwise=torch.equal(part, want),
                                 max_abs_diff=(part - want).abs().max().item(),
                                 gated=s >= _TC_ROWS))
                if s >= _TC_ROWS and not rows[-1]["bitwise"]:
                    raise AssertionError(f"{name}: {s} chunk rows from {start} differ from the "
                                         f"prefill's by {rows[-1]['max_abs_diff']}")
    log("chunk rows as the prefill's: " + ", ".join(
        f"{r['kernel'].split('_')[0]} S{r['S']}@{r['start']} "
        f"{'bitwise' if r['bitwise'] else r['max_abs_diff']}" for r in rows))
    return rows


def check_fused_fxp16_af(device):
    """The fused dot+AF as ``--fxp16`` serves it: FxP16 banks, x at FxP16
    and the AF epilogue at FxP16 and its full depth, swish and identity, at
    olmo-1b's up/gate shape, at decode, a chunk's 32 rows and the largest
    bucket, against its plain version, bitwise; times and bounds."""
    import torch

    from repro_torch.core import FXP16, full_depth
    from repro_torch.kernels import costs
    from repro_torch.kernels.cordic_fused import fused_dot_af, fused_dot_af_ref
    from repro_torch.kernels.int_dot import plan

    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    k, n = 2048, 8192
    banks = prepared_weight(k, n, FXP16, gen, device, copies=9)
    w = banks[0]
    rows = []
    for m in (SLOTS, CHUNK_TOKENS, BUCKET):
        x = torch.randn((m, k), generator=gen, device=device)
        for af in ("swish", "identity"):
            kw = dict(af_mode=af, af_depth=full_depth(FXP16), af_fmt=FXP16)
            got = fused_dot_af(x, w.data, w.point, **kw)
            want = fused_dot_af_ref(x, w.data, w.point, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"fused_dot_af FxP16 AF {af} != plain at M={m}: "
                                     f"{(got != want).sum().item()} elements differ")
            it = iter(range(1 << 30))
            call = lambda: fused_dot_af(x, banks[next(it) % len(banks)].data,  # noqa: E731
                                        w.point, **kw)
            b_ms, b_by = costs.fused_dot_af(m, n, k, 2, af, full_depth(FXP16), FXP16).bound()
            rows.append(dict(model="olmo-1b --fxp16", M=m, K=k, N=n, af=af, af_fmt="fxp16",
                             af_depth=full_depth(FXP16), path=path_name(plan(m, n, k, 2, 2)),
                             bitwise_equal=True, max_abs_err=0.0,
                             ms=graph_ms(call, 30 if m <= 32 else 10),
                             plain_ms=timed_ms(lambda: fused_dot_af_ref(x, w.data, w.point, **kw),
                                               iters=3, warmup=1),
                             bound_ms=b_ms, bound_by=b_by))
            log(f"fused FxP16 AF M={m} {af}: {rows[-1]['ms']:.4f} ms (plain "
                f"{rows[-1]['plain_ms']:.3f}, bound {b_ms:.4f} {b_by})")
    del banks
    return rows


def check_int8_mac(device):
    """The MAC-array kernel as the int8 mode launches it: int8 banks from
    ``int8.quantize_weight`` (per-channel scales, K-major), per-token x
    scales, olmo-1b's shapes at decode, a chunk's 32 rows and the largest
    bucket, bitwise against its plain version (``time_mac``, with
    ``torch._int_mm`` as the library yardstick); and ``int8_dot`` on the card
    launches the kernel (its wrapper counts one launch a call) and equals
    its plain version on the CPU, bitwise."""
    import torch

    from repro_torch.core.backends.int8 import (
        int8_dot, k_major_bank, quantize_tokens, quantize_weight)
    from repro_torch.kernels.cordic_mac import mac_matmul

    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    rows = []
    for k, n in FUSED_SHAPES:
        copies = max(1, min(48, math.ceil(3e8 / (k * n))))
        ws = [quantize_weight(torch.randn((k, n), generator=gen, device=device) * 0.3)
              for _ in range(copies)]
        banks = [k_major_bank(q) for q, _ in ws]
        w_scale = ws[0][1]
        for m in (SLOTS, CHUNK_TOKENS, BUCKET):
            x = torch.randn((m, k), generator=gen, device=device) * 2
            x_q, x_scale = quantize_tokens(x)
            rows.append(time_mac("int8 mode", x_q, banks, x_scale, w_scale, False))
            before = mac_matmul.launches
            got = int8_dot(x, banks[0], w_scale=w_scale)
            if mac_matmul.launches != before + 1:
                raise AssertionError("int8_dot on the card did not launch the MAC-array kernel")
            want = int8_dot(x.cpu(), banks[0].cpu(), w_scale=w_scale.cpu())
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"int8_dot card != CPU at M={m} K={k} N={n}")
        del banks, ws
    return rows


def record_chunks(server) -> list:
    """Wrap ``server``'s chunk program so that each call records its
    ``(rows, start, prompt length)``; returns the list the calls append to."""
    chunk, admit = server.chunk_fns()
    calls = []

    def recorded(prompt, start, n):
        calls.append((n, start, len(prompt)))
        return chunk(prompt, start, n)

    server._chunk_fns = (recorded, admit)
    return calls


def frontend_run(server, reqs, monolithic=False, arrivals=None, late=(),
                 chunk_tokens=None):
    """Serve ``reqs`` through the streaming frontend (``ContinuousScheduler``,
    ``chunk_tokens`` rows a tick (default ``CHUNK_TOKENS``), or whole
    prompts), each request submitted
    ``arrivals[i]`` seconds after the start (default: all at once), and the
    requests ``late`` after the first tick; the scheduler ticked on this
    thread as the CLI's ``--frontend`` ticks it. Returns ``(streams, report,
    scheduler)``; the report's TTFT counts from each request's submit; with
    ``late`` requests it also holds ``long_prompt_gaps``."""
    import numpy as np
    import torch

    from repro_torch.serve.frontend import ContinuousScheduler, FrontendConfig

    at = [0.0] * len(reqs) if arrivals is None else list(arrivals)
    pending = sorted(zip(at, range(len(reqs))))
    sched = ContinuousScheduler(server, FrontendConfig(chunk_tokens=chunk_tokens or CHUNK_TOKENS,
                                                       monolithic_prefill=monolithic))
    submitted, late, interleaved = {}, list(late), bool(late)

    def submit(req):
        submitted[req.rid] = time.perf_counter() - server._t0
        sched.submit(req)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sched:
        while pending or late or not sched.idle:
            now = time.perf_counter() - t0
            while pending and pending[0][0] <= now:
                submit(reqs[pending.pop(0)[1]])
            did = sched.step()
            if late and sched.stats["ticks"]:
                for req in late:
                    submit(req)
                late = []
            if not did and pending:
                time.sleep(min(0.001, max(0.0, pending[0][0] - now)))
        out = dict(sched.results)
    wall = time.perf_counter() - t0
    tokens = sum(len(v) for v in out.values())
    ttft = [(server.emissions[rid][0][0] - submitted[rid]) * 1e3 for rid in out]
    itl = [(t1 - t0_) / n * 1e3 for em in server.emissions.values()
           for (t0_, _), (t1, n) in zip(em, em[1:]) for _ in range(n)]
    report = dict(wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
                  ttft_ms_mean=float(np.mean(ttft)), ttft_ms_p50=float(np.median(ttft)),
                  ttft_ms_max=float(np.max(ttft)), intertoken_ms_mean=float(np.mean(itl)),
                  intertoken_ms_p90=float(np.percentile(itl, 90)),
                  ticks=sched.stats["ticks"], bursts=sched.stats["bursts"],
                  prefill_rows=sched.stats["prefill_rows"],
                  max_prefill_rows_between_bursts=sched.stats["max_prefill_rows_between_bursts"],
                  graph_replays=server.graph_replays, host_transfers=server.host_transfers)
    if interleaved:
        report["long_prompt_gaps"] = long_prompt_gaps(server)
    return out, report, sched


def long_prompt_gaps(server) -> dict:
    """The decoding slots' emission gaps while request ``LONG_RID`` (the
    300-token prompt) was prefilling: from its admission (the observer's
    clock) to its first token. ``max_gap_ms`` is the longest wait of any
    decoding request between two of its emissions in that window,
    ``per_token_ms_mean`` each gap over the tokens it delivered."""
    admit = server.observer.requests[LONG_RID].admit - server._t0
    first = server.emissions[LONG_RID][0][0]
    gaps = [(t1 - t0, n) for rid, em in server.emissions.items() if rid != LONG_RID
            for (t0, _), (t1, n) in zip(em, em[1:]) if t1 > admit and t0 < first]
    if not gaps:
        raise AssertionError(f"no request decoded while request {LONG_RID} prefilled")
    return dict(window_ms=(first - admit) * 1e3, gaps=len(gaps),
                max_gap_ms=max(g for g, _ in gaps) * 1e3,
                per_token_ms_mean=sum(g for g, _ in gaps) / sum(n for _, n in gaps) * 1e3)


def same_as_run(label, out, reqs, run, gate_margins: bool = True) -> dict:
    """``out`` (a frontend run's streams, ``reqs`` its requests) against a
    ``run()`` of the same requests (``run``: its streams and margins):
    streams identical, margins within ``MARGIN_ATOL`` when ``gate_margins``
    (bitwise or not reported either way)."""
    streams, run_margins = run
    if out != streams:
        raise AssertionError(f"{label}: streams differ from run()'s: {out} vs {streams}")
    diffs = [abs(a - b) for got, want in zip(margins(reqs), run_margins)
             for a, b in zip(got, want)]
    worst = max(diffs)
    if gate_margins and not worst <= MARGIN_ATOL:
        raise AssertionError(f"{label}: top-2 margins differ from run()'s by {worst}")
    return dict(streams_identical=True, margins_identical=worst == 0.0,
                margins_max_abs_diff=worst, margins_gated=gate_margins,
                margins_differing=sum(d != 0.0 for d in diffs), margins_compared=len(diffs))


def frontend_accounting(label, server, cfg, reqs, chunks, captured_before=frozenset()) -> dict:
    """The launch counts of a chunked frontend run, exact, from the wrappers,
    as ``graph_accounting`` holds a ``run()``: each graph captured in this
    run issued, at its warm-up and its capture, what its program implies (a
    chunk bucket ``b``: one forward over ``b`` rows; the admit: none), and
    nothing else was issued from the host; the replays' launches are the
    chunks' forwards at their buckets (the scan: a single-row step a prompt
    row) and the decode steps over the slots. The chunks (``chunks``: the
    chunk program's recorded ``(rows, start, prompt length)``) cover each
    prompt from row 0 in order, at most ``CHUNK_TOKENS`` rows each, each at
    the bucket the server's ``chunk_span`` gives it; one replay a chunk (a
    scan row), one replay and one transfer an admit and a burst."""
    from collections import Counter

    from repro_torch.kernels import kernel_totals

    runner = server.programs
    per_forward = launches_per_forward(cfg)
    issued = {}
    for name, captured in runner.captured_launches.items():
        if name in captured_before:
            continue
        want = program_launches(name, server, cfg)
        check_instantiations(f"{label}: graph {name!r} at capture", captured, want)
        check_instantiations(f"{label}: graph {name!r} warm-up", runner.warmup_launches[name],
                             want)
        add_counts(issued, {k: 2 * v for k, v in captured.items()})
    check_instantiations(f"{label}: issued from the host (warm-ups and captures)",
                         wrapper_counts(), issued)
    lens = [len(r.prompt) for r in reqs]
    jobs = []
    for n, start, _ in chunks:
        if not 0 < n <= CHUNK_TOKENS:
            raise AssertionError(f"{label}: a chunk of {n} rows")
        if start == 0:
            jobs.append(0)
        if start != jobs[-1]:
            raise AssertionError(f"{label}: a chunk from row {start}, expected {jobs[-1]}")
        jobs[-1] += n
    if sorted(jobs) != sorted(lens):
        raise AssertionError(f"{label}: chunks cover prompts of {jobs}, the requests' are {lens}")
    want = by_instantiation(per_forward, server.slots, 1, server.decode_steps)
    bursts = server.decode_steps // server.burst
    replays = Counter()
    for name, n in runner.replays.items():
        replays[name.partition(" @")[0]] += n
    if server.batched_prefill:
        buckets = Counter(server.chunk_span(plen, start, n)[1] for n, start, plen in chunks)
        for b, c in buckets.items():
            add_counts(want, by_instantiation(per_forward, b, b, c))
        chunk_replays = Counter({int(k.split()[-1]): v for k, v in replays.items()
                                 if k.startswith("prefill_chunk")})
        if chunk_replays != buckets or replays["prefill admit"] != len(reqs):
            raise AssertionError(f"{label}: chunk replays {dict(chunk_replays)} and "
                                 f"{replays['prefill admit']} admits, the chunks imply "
                                 f"{dict(buckets)} and {len(reqs)}")
        steps = 0
    else:
        steps = sum(lens)
        add_counts(want, by_instantiation(per_forward, 1, 1, steps))
        if replays["prefill step"] != steps or replays["prefill finish"] != len(reqs):
            raise AssertionError(f"{label}: {replays['prefill step']} step and "
                                 f"{replays['prefill finish']} finish replays for {steps} "
                                 f"prompt rows and {len(reqs)} prompts")
    replayed = replayed_launches(runner)
    launches = check_launches(f"{label}: replayed", kernel_totals(replayed), per_forward,
                              times=model_forwards(server))
    check_instantiations(f"{label}: replayed", replayed, want)
    prefill_replays = (len(chunks) if server.batched_prefill else steps) + len(reqs)
    if not (server.host_transfers == len(reqs) + bursts
            and server.graph_replays == prefill_replays + bursts
            and server.prefill_steps == steps):
        raise AssertionError(f"{label}: {server.graph_replays} graph replays and "
                             f"{server.host_transfers} transfers for {len(chunks)} chunks, "
                             f"{len(reqs)} prompts, {bursts} bursts and {steps} scan steps")
    return launches


def chunked_identity(label, server, cfg, run) -> tuple:
    """The six requests through the frontend at ``CHUNK_TOKENS`` on a
    captured ``server`` (weights and graphs of its own): exact launch
    accounting (``frontend_accounting``), the interleaving bound, and the
    streams and margins against ``run`` (``same_as_run``; margins gated for
    archs without MoE, see ``MARGIN_ATOL``). Returns the
    report, with the frontend run's ``launches``, and the list the chunk
    program records its calls in (``record_chunks``)."""
    from repro_torch.obs import ServingObserver

    server.observer = ServingObserver(trace=False)
    chunks = record_chunks(server)
    zero_launches()
    reqs = requests(cfg)
    out, rep, _ = frontend_run(server, reqs)
    rep["launches"] = frontend_accounting(label, server, cfg, reqs, chunks)
    rep["chunks"] = len(chunks)
    rep["chunk_buckets"] = sorted({name for name in server.programs.graphs
                                   if name.startswith("prefill_chunk")})
    rep.update(same_as_run(label, out, reqs, run, gate_margins=cfg.moe is None))
    bound_rows = rep["max_prefill_rows_between_bursts"]
    if not 0 < bound_rows <= CHUNK_TOKENS:
        raise AssertionError(f"{label}: {bound_rows} prefill rows between two bursts")
    return rep, chunks


def chunked_frontend(device, label, cfg, weights, run) -> dict:
    """``chunked_identity`` on a captured server of ``weights`` (a serving
    phase's prepared tree; ``run`` its streams and margins)."""
    from repro_torch.models import get_model
    from repro_torch.serve.engine import BatchedServer

    server = BatchedServer(get_model(cfg), kernel_ctx(), weights, slots=SLOTS, max_len=MAX_LEN,
                           burst=BURST, device=device)
    rep, _ = chunked_identity(f"{label} frontend", server, cfg, run)
    del server
    free_card()
    return rep


def frontend_phases(device, olmo_run):
    """Full-width olmo-1b (16 layers, the weights of ``serve olmo-1b``)
    through the streaming frontend, prepared kernel mode, captured: the six
    requests submitted at once at ``CHUNK_TOKENS`` (chunked), against the
    captured ``run()`` of ``olmo_run`` (streams identical, margins within
    ``MARGIN_ATOL``, reported bitwise or not); the interleaving bound; exact
    launches by instantiation (each chunk bucket's graph × its replays), one
    transfer a prefill and a burst; a steady repeat (no capture, bitwise
    the first); the monolithic arm (``--monolithic-prefill``: run()'s
    programs, streams and margins bitwise run()'s), captured and repeated;
    the interleaving contrast, chunked and monolithic: ``SLOTS - 1``
    requests decoding when the 300-token prompt arrives after the first
    tick, with the decoding slots' emission gaps while it prefills
    (``long_prompt_gaps``); Poisson arrivals (``ARRIVAL_RATE``,
    ``ARRIVAL_SEED``): TTFT from each submit, launches exact; and half the
    chunk budget, captured = uncaptured bitwise. Under arrivals and at half
    the budget the chunk boundaries move; the streams and margins are still
    run()'s (``same_as_run``): each row runs on the attention kernel path
    run()'s bucket gives it (``BatchedServer.chunk_span``). Each run reports
    tokens/s, TTFT and inter-token latency."""
    import numpy as np
    import torch

    from repro_torch.models import get_model
    from repro_torch.serve.engine import BatchedServer

    cfg = olmo()
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    server = BatchedServer(model, kernel_ctx(), params, slots=SLOTS, max_len=MAX_LEN,
                           burst=BURST, device=device)
    del params
    report = dict(config="olmo-1b full width, 16 layers, dtype float32, kernel mode (prepared), "
                         "FxP8 accurate, attn_impl=decode_kernel, greedy, streaming frontend",
                  chunk_tokens=CHUNK_TOKENS, slots=SLOTS, max_len=MAX_LEN, burst=BURST,
                  prompt_lens=list(PROMPT_LENS), max_new=MAX_NEW)
    report["chunked"], chunks = chunked_identity("olmo-1b frontend", server, cfg, olmo_run)
    report["launches"] = report["chunked"]["launches"]
    first = report["chunked"]
    # steady: every chunk graph already captured
    chunks.clear()
    captured = frozenset(server.programs.graphs)
    zero_launches()
    reqs = requests(cfg)
    out, steady, _ = frontend_run(server, reqs)
    frontend_accounting("olmo-1b frontend steady", server, cfg, reqs, chunks, captured)
    steady.update(same_as_run("olmo-1b frontend steady", out, reqs, olmo_run))
    if (steady["margins_max_abs_diff"], steady["margins_differing"]) != (
            first["margins_max_abs_diff"], first["margins_differing"]):
        raise AssertionError("olmo-1b frontend: the steady repeat's margins differ from the "
                             "first frontend run's")
    report["chunked_steady"] = steady
    # the monolithic arm: run()'s programs, so run()'s streams and margins, bitwise
    for which in ("monolithic", "monolithic_steady"):
        captured = frozenset(server.programs.graphs)
        zero_launches()
        reqs = requests(cfg)
        out, rep, _ = frontend_run(server, reqs, monolithic=True)
        graph_accounting(f"olmo-1b frontend {which}", server, cfg, reqs,
                         captured_before=captured)
        rep.update(same_as_run(f"olmo-1b frontend {which}", out, reqs, olmo_run))
        if not rep["margins_identical"]:
            raise AssertionError(f"olmo-1b frontend {which}: margins differ from run()'s")
        report[which] = rep
    # the interleaving contrast: SLOTS - 1 requests decoding when the
    # 300-token prompt arrives (after the first tick), chunked and
    # monolithic; each arm twice, the second timed (no capture in it)
    early = [rid for rid in range(len(PROMPT_LENS)) if rid != LONG_RID][:SLOTS - 1]
    for arm in ("chunked", "monolithic"):
        for _ in range(2):
            reqs = requests(cfg)
            out, rep, _ = frontend_run(server, [reqs[rid] for rid in early],
                                       monolithic=arm == "monolithic", late=[reqs[LONG_RID]])
            want = {rid: olmo_run[0][rid] for rid in early + [LONG_RID]}
            if out != want:
                raise AssertionError(f"olmo-1b frontend interleaved {arm}: streams differ from "
                                     "run()'s")
        rep["requests"] = early + [LONG_RID]
        report[f"interleaved_{arm}"] = rep
    # Poisson arrivals
    arrivals = np.cumsum(np.random.default_rng(ARRIVAL_SEED).exponential(
        1.0 / ARRIVAL_RATE, size=len(PROMPT_LENS)))
    captured = frozenset(server.programs.graphs)
    chunks.clear()
    zero_launches()
    reqs = requests(cfg)
    out, arrived, _ = frontend_run(server, reqs, arrivals=arrivals)
    frontend_accounting("olmo-1b frontend arrivals", server, cfg, reqs, chunks, captured)
    arrived.update(same_as_run("olmo-1b frontend arrivals", out, reqs, olmo_run),
                   arrival_rate=ARRIVAL_RATE, arrival_seed=ARRIVAL_SEED,
                   arrivals_s=arrivals.tolist(), chunk_schedule=list(chunks))
    report["poisson_arrivals"] = arrived
    # another deterministic schedule, half the chunk budget: captured and
    # uncaptured (every launch from the host) bitwise equal, and run()'s
    runs = {}
    eager = BatchedServer(model, kernel_ctx(), server.params, slots=SLOTS, max_len=MAX_LEN,
                          burst=BURST, device=device, capture=False)
    for label, srv in (("captured", server), ("uncaptured", eager)):
        reqs = requests(cfg)
        out, rep, _ = frontend_run(srv, reqs, chunk_tokens=CHUNK_TOKENS // 2)
        runs[label] = (out, margins(reqs), rep, reqs)
    if runs["captured"][:2] != runs["uncaptured"][:2]:
        raise AssertionError("olmo-1b frontend at chunk budget "
                             f"{CHUNK_TOKENS // 2}: captured streams or margins differ from "
                             "the uncaptured run's")
    report["half_chunk_budget"] = dict(runs["captured"][2], chunk_tokens=CHUNK_TOKENS // 2,
                                       captured_equals_uncaptured=True,
                                       uncaptured_tokens_per_s=runs["uncaptured"][2][
                                           "tokens_per_s"],
                                       **same_as_run("olmo-1b frontend half chunk budget",
                                                     runs["captured"][0],
                                                     runs["captured"][3], olmo_run))
    del eager
    report["graphs"] = graphs_report(server.programs)
    log(f"olmo-1b frontend: {steady['tokens_per_s']:.2f} tok/s chunked (monolithic "
        f"{report['monolithic_steady']['tokens_per_s']:.2f}); gaps across the 300-token "
        f"prefill max {report['interleaved_chunked']['long_prompt_gaps']['max_gap_ms']:.2f} ms "
        f"(monolithic "
        f"{report['interleaved_monolithic']['long_prompt_gaps']['max_gap_ms']:.2f}); arrivals "
        f"TTFT mean {arrived['ttft_ms_mean']:.2f} ms")
    del server
    free_card()
    return report


def mode_ctx(mode: str, fmt=None):
    """The serving CLI's context for ``--mode mode``: exact has no policy."""
    import torch

    from repro_torch.core import FXP8, EngineContext, PrecisionPolicy

    return EngineContext(mode=mode, policy=None if mode == "exact"
                         else PrecisionPolicy.accurate(fmt or FXP8),
                         compute_dtype=torch.float32, attn_impl="decode_kernel")


def serve_mode(device, mode, cfg, params, per_call=False, uncaptured=True) -> tuple:
    """``params`` served in ``mode`` on the card, the six requests: a captured
    run with exact launch accounting, a steady repeat and (``uncaptured``)
    the uncaptured yardstick on the streams' first ``MODE_UNCAPTURED_HEAD``
    tokens, streams and f32 margins bitwise across them. Returns ``(report,
    (streams, margins))``."""
    from repro_torch.models import get_model
    from repro_torch.serve.engine import BatchedServer

    model = get_model(cfg)
    label = f"olmo-1b {cfg.num_layers} layers {mode}{' per-call' if per_call else ''}"
    make = lambda capture=True: BatchedServer(  # noqa: E731
        model, mode_ctx(mode), params, slots=SLOTS, max_len=MAX_LEN, burst=BURST,
        device=device, prepare_weights=not per_call, capture=capture)
    server = make()
    zero_launches()
    reqs = requests(cfg)
    first, first_run = timed_run(server, reqs)
    launches, _ = graph_accounting(label, server, cfg, reqs, per_call, mode=mode)
    run = (first, margins(reqs))
    captured = frozenset(server.programs.graphs)
    zero_launches()
    again_reqs = requests(cfg)
    again, steady = timed_run(server, again_reqs)
    graph_accounting(f"{label} steady", server, cfg, again_reqs, per_call, captured, mode=mode)
    if (again, margins(again_reqs)) != run:
        raise AssertionError(f"{label}: a repeat's streams or margins differ")
    report = dict(mode=mode, layers=cfg.num_layers, weights="per-call" if per_call else
                  "prepared", first_run=first_run, steady_run=steady,
                  tokens_per_s=steady["tokens_per_s"],
                  decode_ms_per_step=steady["decode_ms_per_step"], launches=launches,
                  launches_per_forward=launches_per_forward(cfg, per_call, mode),
                  repeat_identical=True, distinct_tokens=len({t for v in first.values()
                                                              for t in v}),
                  streams_head={rid: v[:8] for rid, v in first.items()})
    del server
    free_card()
    if uncaptured:
        eager = make(capture=False)
        zero_launches()
        head = min(MODE_UNCAPTURED_HEAD, MAX_NEW)
        eager_reqs = requests(cfg, max_new=head)
        eager_out, report["uncaptured_run"] = timed_run(eager, eager_reqs)
        uncaptured_accounting(f"{label} uncaptured", eager, cfg, eager_reqs, per_call, mode)
        if (eager_out, margins(eager_reqs)) != ({rid: v[:head] for rid, v in first.items()},
                                                [m[:head] for m in run[1]]):
            raise AssertionError(f"{label}: captured streams or margins differ from the "
                                 "uncaptured run's")
        report["uncaptured_identical"] = True
        del eager
        free_card()
    log(f"{label}: {report['tokens_per_s']:.2f} tok/s captured"
        + (f" (uncaptured {report['uncaptured_run']['tokens_per_s']:.2f})" if uncaptured
           else ""))
    return report, run


def modes_phases(device) -> dict:
    """The exact, carmen and int8 modes at full-width olmo-1b (16 layers,
    seeded weights, FxP8 accurate), prepared: captured = repeat =
    uncaptured, bitwise (``serve_mode``), the int8 mode's MAC-array launches
    exact; prepared = per call, bitwise, at ``PER_CALL_LAYERS`` layers; the
    same modes on reduced olmo-1b card vs CPU, streams identical; and CI's
    flow, ``--mode carmen --adaptive --metrics``, through the CLI's
    ``main`` at full width."""
    import contextlib
    import io

    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model

    report = {}
    cfg = olmo()
    params = get_model(cfg).init(torch.Generator(device=device).manual_seed(SEED))
    for mode in MODES:
        report[mode], _ = serve_mode(device, mode, cfg, params)
        emit({"mode": report[mode]})
    del params
    free_card()
    cut = olmo(PER_CALL_LAYERS)
    params = get_model(cut).init(torch.Generator(device=device).manual_seed(SEED))
    for mode in MODES:
        prepared, run = serve_mode(device, mode, cut, params, uncaptured=False)
        per_call, per_call_run = serve_mode(device, mode, cut, params, per_call=True,
                                            uncaptured=False)
        if per_call_run != run:
            raise AssertionError(f"olmo-1b {PER_CALL_LAYERS} layers {mode}: per-call streams or "
                                 "margins differ from the prepared run's")
        report[f"{mode} {PER_CALL_LAYERS} layers"] = dict(
            prepared=prepared, per_call=per_call, per_call_identical=True,
            launches=add_counts(dict(prepared["launches"]), per_call["launches"]))
    del params
    free_card()
    rcfg = reduced(get_config("olmo-1b"))
    rparams = scaled_init(get_model(rcfg))
    for mode in MODES:
        report[f"{mode} card vs cpu"] = card_vs_cpu(
            device, f"olmo-1b reduced, {mode}", rcfg, rparams, (5, 11, 40), 64, ctx=mode_ctx(mode))
    from repro_torch.launch import serve as cli

    buf = io.StringIO()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = cli.main(["--mode", "carmen", "--adaptive", "--metrics"])
    text = buf.getvalue()
    lines = {line.split(" ", 1)[0]: line.split(" ", 1)[1] for line in text.splitlines()
             if line.startswith(("telemetry: ", "metrics: ", "bank: ", "served "))}
    if sorted(out) != list(range(6)) or any(len(v) != 16 for v in out.values()) \
            or {"metrics:", "telemetry:", "bank:", "served"} - set(lines):
        raise AssertionError(f"the CLI's --mode carmen --adaptive --metrics: {text[-2000:]}")
    report["cli carmen adaptive metrics"] = dict(
        argv="--mode carmen --adaptive --metrics", wall_s=time.perf_counter() - t0,
        served=lines["served"], bank=lines["bank:"],
        telemetry=json.loads(lines["telemetry:"]), metrics=json.loads(lines["metrics:"]),
        launches_issued_from_host=nonzero(wrapper_counts()))
    free_card()
    return report


SIM_CYCLE_BUDGET = 0.75
SIM_DRIFT_TOL = 1e-9
# the adaptive olmo-1b CLI flow the simulator replays (full width on the card)
SIM_CLI = ("--mode", "kernel", "--adaptive", "--cycle-budget", str(SIM_CYCLE_BUDGET))


def replay_summary(result) -> dict:
    """What ``sim_phases`` reports of one replay."""
    sav = result.savings
    return dict(array=dict(n_pes=result.config["n_pes"],
                           sec_per_cycle=result.config["sec_per_cycle"]),
                totals=result.totals, phases=result.phases, counts=result.counts,
                est_cycle_savings_frac=sav["est_cycle_savings_frac"],
                reported_savings_frac=(sav["reported"] or {}).get("est_cycle_savings_frac"),
                rel_diff_vs_reported=sav["rel_diff_vs_reported"], measured=result.measured,
                points={p: {k: acc[k] for k in ("cycles", "steps", "tokens", "wall_s")}
                        for p, acc in result.points.items()})


def sim_phases(device) -> dict:
    """The PE-array simulator on the card: ``run_calibration`` at the
    reference's non-smoke sizes (each function timed as a CUDA-graph
    replay), its export saved and loaded back; the adaptive olmo-1b CLI
    flow (kernel mode, cycle budget ``SIM_CYCLE_BUDGET``) writing a JSONL
    trace; that trace replayed on the analytic array and on the card's
    calibration. Gates: the fit does not fall back, the analytic replay's
    savings agree with the served telemetry within ``SIM_DRIFT_TOL``, and it
    attributes every request and every token served. The calibration's
    constants and the calibrated replay are reported, not gated."""
    import contextlib
    import io

    from repro_torch.launch import serve as cli
    from repro_torch.sim import load_calibration, replay_trace, run_calibration, save_calibration
    from repro_torch.sim.analyze import report_dict, savings_drift

    out_dir = ROOT / "chiprun_out" / "sim"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    cal = run_calibration(device=device)
    measure_s = time.perf_counter() - t0
    path = save_calibration(cal, str(out_dir / "calibration.json"))
    loaded = load_calibration(path)
    if loaded != json.loads(json.dumps(cal)):
        raise AssertionError("the calibration export does not load back as saved")
    if cal["fit"]["mac_slope_fallback"]:
        raise AssertionError(f"the calibration fit fell back: no depth signal in "
                             f"{cal['source']['mac']['times_by_depth']}")
    trace = out_dir / "adaptive.jsonl"
    argv = [*SIM_CLI, "--trace-out", str(trace)]
    buf = io.StringIO()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        served = cli.main(argv)
    cli_s = time.perf_counter() - t0
    from repro_torch.kernels import kernel_totals

    launches = kernel_totals(nonzero(wrapper_counts()))
    telemetry = next(json.loads(line.split(" ", 1)[1]) for line in buf.getvalue().splitlines()
                     if line.startswith("telemetry: "))
    analytic = replay_trace(str(trace))
    calibrated = replay_trace(str(trace), calibration=loaded)
    for name, result in (("analytic", analytic), ("calibrated", calibrated)):
        (out_dir / f"replay_{name}.json").write_text(json.dumps(report_dict(result), indent=1))
    drift = savings_drift(analytic)
    if drift is None or abs(drift) > SIM_DRIFT_TOL:
        raise AssertionError(f"analytic replay's savings drift {drift} (tolerance "
                             f"{SIM_DRIFT_TOL})")
    tokens = sum(len(v) for v in served.values())
    per_request = {str(rid): len(v) for rid, v in served.items()}
    got = {rid: acc["tokens"] for rid, acc in analytic.requests.items()}
    if got != per_request or analytic.measured["tokens"] != tokens:
        raise AssertionError(f"the replay attributes tokens {got} (total "
                             f"{analytic.measured['tokens']}); served {per_request}")
    report = dict(
        calibration=dict(id=cal["id"], constants=cal["constants"], fit=cal["fit"],
                         measure_s=measure_s, source=cal["source"]),
        cli=dict(argv=" ".join(argv[:-2]), wall_s=cli_s, requests=len(served), tokens=tokens,
                 telemetry=telemetry),
        launches=launches,
        replay=dict(analytic=replay_summary(analytic), calibrated=replay_summary(calibrated)),
        savings_drift=drift, requests_attributed=len(got))
    log(f"sim: calibration {cal['id']} in {measure_s:.1f} s, constants {cal['constants']}; "
        f"replay savings analytic {analytic.savings['est_cycle_savings_frac']:.6f} "
        f"calibrated {calibrated.savings['est_cycle_savings_frac']:.6f} (reported "
        f"{telemetry.get('est_cycle_savings_frac')})")
    return report


TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 8, 64, 1e-3  # the train CLI's defaults
TRAIN_CKPT_STEP = 3
TRAIN_RESTART_STEPS = 3
TRAIN_MODE_STEPS = 3
TRAIN_RECORD_CALLS = 3


def train_config():
    """The training phase's model: full-width olmo-1b, 16 layers, f32."""
    return olmo()


def train_step_fn(cfg, mode: str, steps: int, remat: bool = True, mesh=None):
    """The train CLI's step for ``--mode mode --steps steps`` at full width
    (warm-up 10, cosine over ``steps``, remat on), on ``mesh`` if given."""
    from repro_torch.launch.train import engine_ctx
    from repro_torch.models import get_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import TrainConfig, make_train_step

    tcfg = TrainConfig(optimizer=opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=10, total_steps=steps),
                       remat=remat)
    ctx = dataclasses.replace(engine_ctx(mode), mesh=mesh)
    return make_train_step(get_model(cfg), ctx, tcfg)


def train_steps(step_fn, params, state, pipe, start: int, stop: int, on_step=None):
    """Steps ``start..stop-1``: returns ``(params, state, losses, ms)``, the
    loss tensors and each step's wall ms (synchronized)."""
    import torch

    losses, ms = [], []
    for i in range(start, stop):
        batch = pipe.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
        if on_step is not None:
            on_step(i, params, state, metrics)
    return params, state, losses, ms


def train_rate(ms: list) -> dict:
    """ms a step (mean past the first step) and tokens/s."""
    steady = ms[1:] or ms
    mean = sum(steady) / len(steady)
    return dict(ms_per_step=mean, first_step_ms=ms[0], tokens_per_s=TRAIN_BATCH * TRAIN_SEQ
                / (mean / 1e3), step_ms=ms)


def peak_gib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2**30


def same_tree(a, b) -> bool:
    import torch

    from repro_torch.train._tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y.to(x.device)) for x, y in zip(la, lb))


def int8_train_launches(cfg, steps: int, remat: bool = True) -> dict:
    """Kernel 6's launches in ``steps`` int8 train steps: every dot of the
    forward (q k v o, gate up down a layer, and lm_head), again for every
    layer's dots when ``remat`` recomputes the layer in the backward, and
    one backward launch (float(acc) at unit scales) for each dot whose
    output reaches the loss through a gradient: all but the gate's, which
    feeds only the multi-AF block (its integer casts pass none). At
    batch x seq rows every launch takes the int8 tensor-core path."""
    layer_dots = 7 * cfg.num_layers
    forward = layer_dots + 1
    backward = forward - cfg.num_layers
    per_step = forward + (layer_dots if remat else 0) + backward
    return {"cordic_mac/wgmma": per_step * steps}


def train_profile(cfg, mode: str, pipe, fresh) -> dict:
    """One train step of ``mode`` from ``fresh()`` weights, after a warm-up
    step, under ``torch.profiler``: wall and device-busy ms and where the
    device time goes (library matmuls, the port's kernels, the rest: torch's
    elementwise and reduction kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step_fn = train_step_fn(cfg, mode, TRAIN_STEPS)
    params, state = fresh()
    batch = pipe.batch(0)
    step_fn(params, state, batch)
    torch.cuda.synchronize()
    on_card = torch.device(pipe.device).type == "cuda"
    # device activity alone: a carmen step issues ~40,000 kernels, and host
    # events would double what the profiler must record
    with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        out = step_fn(params, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del out, params, state
    rows = kernel_breakdown(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    port = port_kernel_ms(rows)
    gemm_ms = sum(us for us, k, _ in rows
                  if not any(p in k for p in PORT_KERNELS)
                  and any(f in k.lower() for f in GEMM_KERNELS)) / 1e3
    port_ms = sum(v["device_ms"] for v in port.values())
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / wall_ms if wall_ms else 0.0,
                device_kernels=sum(r[2] for r in rows), library_matmul_ms=gemm_ms,
                port_kernels=port, other_kernels_ms=busy_ms - gemm_ms - port_ms,
                top_kernels=[dict(name=k[:100], device_ms=us / 1e3, calls=n)
                             for us, k, n in rows[:10]])


def train_phases(device) -> dict:
    """Training at full-width olmo-1b (``train_config``; ``TokenPipeline``
    seq ``TRAIN_SEQ``, batch ``TRAIN_BATCH``, lr ``TRAIN_LR``: the train
    CLI's defaults, remat on). Gates: exact mode, ``TRAIN_STEPS`` steps,
    every loss finite and the last below the first; its first step bitwise
    the same step with remat off (loss, gradient norm, parameters and
    moments); a checkpoint at step ``TRAIN_CKPT_STEP`` (the reference's
    layout, under ``build/``) restored into a fresh trainer gives the next
    ``TRAIN_RESTART_STEPS`` steps bitwise the uninterrupted run's (losses
    and parameters); carmen and int8, ``TRAIN_MODE_STEPS`` steps each,
    finite losses; int8's MAC-array launches exactly ``int8_train_launches``
    by instantiation, and no other kernel; each of its first
    ``TRAIN_RECORD_CALLS`` launches bitwise its plain version on the same
    inputs. Reports ms a step, tokens/s, each mode's peak GiB and where
    one profiled step's device time goes (``train_profile``). Every
    run starts from weights drawn anew from ``SEED``, and the phase holds
    no other tree on the card, so a peak is the trainer's own: its inputs,
    gradients and outputs while a step builds them (the exact run's peak
    is taken past its first step, which shares the card with the remat-off
    step it is compared with)."""
    import shutil

    import torch

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import kernel_totals
    from repro_torch.kernels.cordic_mac import mac_matmul_ref, ops as mac_ops
    from repro_torch.models import get_model
    from repro_torch.train import checkpoint, optimizer as opt
    from repro_torch.train._tree import tree_map

    cfg = train_config()
    model = get_model(cfg)
    pipe = TokenPipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, device=device)

    def fresh():
        params = model.init(torch.Generator(device=device).manual_seed(SEED), torch.float32)
        return params, opt.init_state(params)

    report = {}
    free_card()
    torch.cuda.reset_peak_memory_stats()
    off = {}
    off["params"], off["state"], (off["loss"],), _ = train_steps(
        train_step_fn(cfg, "exact", TRAIN_STEPS, remat=False), *fresh(), pipe, 0, 1,
        lambda i, p, s, m: off.update(grad_norm=m["grad_norm"]))
    report["remat"] = dict(peak_gib_remat_off=peak_gib())

    # exact mode, remat on: step 0 against the remat-off step, a checkpoint
    # at TRAIN_CKPT_STEP, the parameters after the restart's last step kept
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kept = {}

    def on_step(i, p, s, m):
        if i == 0:
            same = (torch.equal(off["loss"], m["loss"])
                    and torch.equal(off["grad_norm"], m["grad_norm"])
                    and same_tree(off["params"], p) and same_tree(off["state"], s))
            report["remat"].update(bitwise=same, loss=float(m["loss"]),
                                   grad_norm=float(m["grad_norm"]),
                                   peak_gib_both_steps=peak_gib())
            off.clear()
            if not same:
                raise AssertionError("remat changed the first step: its loss, gradient norm, "
                                     "parameters or moments differ from the remat-off step's")
            torch.cuda.reset_peak_memory_stats()
        if i + 1 == TRAIN_CKPT_STEP:
            t0 = time.perf_counter()
            writer = checkpoint.save(str(ckpt_dir), i + 1, p, background=True)
            checkpoint.save(str(ckpt_dir / "opt"), i + 1, s)
            writer.join()
            kept["save_s"] = time.perf_counter() - t0
        if i + 1 == TRAIN_CKPT_STEP + TRAIN_RESTART_STEPS:
            kept["params"] = tree_map(lambda t: t.to("cpu"), p)

    *_, losses, ms = train_steps(train_step_fn(cfg, "exact", TRAIN_STEPS), *fresh(), pipe, 0,
                                 TRAIN_STEPS, on_step)
    values = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in values) or not values[-1] < values[0]:
        raise AssertionError(f"exact training: losses {values}")
    report["exact"] = dict(steps=TRAIN_STEPS, losses=values, **train_rate(ms),
                           peak_gib=peak_gib(), checkpoint_save_s=kept["save_s"])
    free_card()
    report["exact"]["profiled_step"] = train_profile(cfg, "exact", pipe, fresh)
    free_card()

    # the restart: a fresh trainer from the checkpoint, bitwise the run above
    t0 = time.perf_counter()
    like = model.init(torch.Generator(device=device).manual_seed(SEED), torch.float32)
    restored = (checkpoint.restore(str(ckpt_dir), TRAIN_CKPT_STEP, like, device=device),
                checkpoint.restore(str(ckpt_dir / "opt"), TRAIN_CKPT_STEP, opt.init_state(like),
                                   device=device))
    del like
    restore_s = time.perf_counter() - t0
    last, _, restart_losses, _ = train_steps(
        train_step_fn(cfg, "exact", TRAIN_STEPS), *restored, pipe, TRAIN_CKPT_STEP,
        TRAIN_CKPT_STEP + TRAIN_RESTART_STEPS)
    del restored
    want = losses[TRAIN_CKPT_STEP:TRAIN_CKPT_STEP + TRAIN_RESTART_STEPS]
    if not all(torch.equal(a, b) for a, b in zip(restart_losses, want)) \
            or not same_tree(kept["params"], last):
        raise AssertionError(f"restart from step {TRAIN_CKPT_STEP}: losses "
                             f"{[float(v) for v in restart_losses]} vs {[float(v) for v in want]}"
                             " or parameters differ")
    report["restart"] = dict(bitwise=True, from_step=TRAIN_CKPT_STEP,
                             steps=TRAIN_RESTART_STEPS, restore_s=restore_s,
                             checkpoint_gib=sum(f.stat().st_size for f in ckpt_dir.rglob("*.npy"))
                             / 2**30)
    del last, kept
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    free_card()

    # carmen and int8: a few steps each
    for mode in ("carmen", "int8"):
        torch.cuda.reset_peak_memory_stats()
        recorded = []
        zero_launches()
        undo = recording(mac_ops, "_launch", recorded, TRAIN_RECORD_CALLS)
        try:
            *_, losses, ms = train_steps(train_step_fn(cfg, mode, TRAIN_MODE_STEPS), *fresh(),
                                         pipe, 0, TRAIN_MODE_STEPS)
        finally:
            undo()
        counts = nonzero(wrapper_counts())
        values = [float(v) for v in losses]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{mode} training: losses {values}")
        rep = dict(steps=TRAIN_MODE_STEPS, losses=values, **train_rate(ms), peak_gib=peak_gib())
        if mode == "int8":
            want_counts = int8_train_launches(cfg, TRAIN_MODE_STEPS)
            rep["launches_by_instantiation"] = check_instantiations("int8 training", counts,
                                                                    want_counts)
            rep["launches"] = kernel_totals(counts)
            for (x_q, w_q, x_scale, w_scale, relu), _, out in recorded:
                if not torch.equal(out, mac_matmul_ref(x_q, w_q, x_scale, w_scale,
                                                       fuse_relu=relu)):
                    raise AssertionError("int8 training: a MAC-array launch differs from its "
                                         f"plain version at {tuple(x_q.shape)} x "
                                         f"{tuple(w_q.shape)}")
            rep["bitwise_plain_calls"] = [[list(a[0].shape), list(a[1].shape)]
                                          for a, _, _ in recorded]
        elif counts:
            raise AssertionError(f"carmen training launched port kernels: {counts}")
        report[mode] = rep
        del recorded
        free_card()
        rep["profiled_step"] = train_profile(cfg, mode, pipe, fresh)
        free_card()
    log("train: " + ", ".join(
        f"{m} {report[m]['ms_per_step']:.1f} ms/step {report[m]['tokens_per_s']:.0f} tok/s "
        f"{report[m]['peak_gib']:.1f} GiB" for m in ("exact", "carmen", "int8")))
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
    scan prefill; mamba2 also sampled and through the streaming frontend
    (``chunked_frontend``: its step graph replayed a chunk row); each one's
    ``SCAN_FORWARD`` forward on
    the serving weights, the card freed between archs; then each reduced,
    card vs CPU. Adds each report to the dicts and prints it."""
    for name in SCAN_ARCH_LAYERS:
        cfg = scan_config(name)
        serving[name], streams, run_margins, weights = phase(
            f"serve {name}", serve_full_width, device, name, cfg)
        serving[name]["weights"] = weight_reckoning(cfg)
        emit({"serving": serving[name]})
        if name == "mamba2-780m":
            serving[f"{name} sampled"] = phase(f"serve {name} sampled", serve_sampled, device,
                                               cfg, weights, streams)
            emit({"serving": serving[f"{name} sampled"]})
            # the scan's chunked prefill: its step graph replayed a chunk row
            serving[f"{name} frontend"] = phase(f"frontend {name}", chunked_frontend, device,
                                                name, cfg, weights, (streams, run_margins))
            emit({"serving": serving[f"{name} frontend"]})
        forward[name] = phase(f"forward {name}", forward_phase, device, name, cfg, weights,
                              SCAN_FORWARD[name])
        emit({"forward": forward[name]})
        del weights
        free_card()
    for name in SCAN_ARCH_LAYERS:
        parity[name] = phase(f"{name} card vs cpu", scan_card_vs_cpu, device, name)
        emit({"card_vs_cpu": parity[name]})


# ---------------------------------------------------------------------------
# tp: tensor-parallel serving on a (data, model) mesh of ranks sharing the card
# ---------------------------------------------------------------------------

# the tp group: two gloo ranks on the one card (NCCL refuses two ranks on one
# device); 16 new tokens of the smoke's six prompts a run, uncaptured (gloo
# collectives cannot be captured)
TP_MAX_NEW = 16
TP_CUT_LAYERS = 4  # olmo-1b at (2, 1) and at (1, 1) under NCCL
# (2, 1) all-gathers every FSDP shard over gloo each step (~0.37 GB at 4
# layers, ~1.2 s a step on the card): its first two prompts, 8 new tokens
# and no collective snapshot keep the phase near 30 s
TP_FSDP_MAX_NEW = 8
TP_FSDP_PROMPTS = PROMPT_LENS[:2]
# the MoE archs at (1, 2), each rank holding half of the routed experts:
# llama4's pair with 32 of 128 (13.6 GB of f32 a rank at set-up, the mesh=None
# run 27 GB), deepseek-v3 at the smoke's 4 layers with 64 of 256 (one MoE layer)
TP_LLAMA4_EXPERTS = 32
TP_DEEPSEEK_EXPERTS = 64
# olmo-1b's row-parallel shards on a model axis of 2: wo (1024 of K, 2048)
# and down (4096 of K, 2048), at decode, the 16-row bucket and M 512
TP_KERNEL_SHAPES = ((1024, 2048), (4096, 2048))
TP_KERNEL_MS = (SLOTS, 16, BUCKET)
# the (1, 2) phases of kernel 6's split form and of the scan archs, each
# against its own mesh=None run: full-width olmo-1b in the int8 mode (its
# first two prompts: the mode's multi-AF block is ~11,500 torch kernels a
# forward, uncaptured), olmo-1b per call at PER_CALL_LAYERS, and the scan
# archs at stock widths cut in depth (mamba2-780m to 4 of 48 layers,
# zamba2-7b to one group of 9 Mamba2 layers and the shared block,
# seamless-m4t-large-v2 to 4 + 4 of 24 + 24 layers) and to the first two
# prompts (3 and 17 tokens: every prompt token is a single-token step with
# three gloo collectives a Mamba2 layer); 8 new tokens each
TP_NEW_PROMPTS = PROMPT_LENS[:2]
TP_NEW_MAX_NEW = 8
TP_SCAN_LAYERS = {"mamba2-780m": 4, "zamba2-7b": 9, "seamless-m4t-large-v2": 4}


def check_tp_kernels(device):
    """Kernel 1's split form (``fused_dot_partial`` then ``fused_epilogue``)
    against its plain twins, bitwise, at olmo-1b's local row-parallel shapes
    on the narrow and wgmma paths and FxP16 (imad), and the split identity
    itself: the epilogue of the int32 sum of two K halves' partials equals
    the fused kernel over the whole of K. The epilogue also runs every AF
    with bf16 rounding on and off, on full-range int32 sums. Times the card
    kernels, the plain versions, the bounds (``costs.py``) and
    ``torch._int_mm`` on the shard (the partial's library yardstick). Then
    kernel 6's split form the same way (:func:`check_mac_split`)."""
    import torch

    from repro_torch.core import FXP8, FXP16
    from repro_torch.kernels import costs
    from repro_torch.kernels.cordic_fused import (FUSED_AFS, fused_dot_af, fused_dot_partial,
                                                  fused_dot_partial_ref, fused_epilogue,
                                                  fused_epilogue_ref)
    from repro_torch.kernels.int_dot import plan, to_k_major

    gen = torch.Generator(device=device).manual_seed(SEED)
    rows, max_err = [], 0.0
    cases = [(FXP8, k, n, m) for k, n in TP_KERNEL_SHAPES for m in TP_KERNEL_MS]
    cases += [(FXP16, k, n, SLOTS) for k, n in TP_KERNEL_SHAPES]
    for fmt, k, n, m in cases:
        whole = prepared_weight(2 * k, n, fmt, gen, device)[0]
        halves = [to_k_major(whole.data[i * k:(i + 1) * k]) for i in range(2)]
        x = torch.randn((m, 2 * k), generator=gen, device=device)
        xs = [x[:, i * k:(i + 1) * k].contiguous() for i in range(2)]
        parts = [fused_dot_partial(xs[i], halves[i], whole.point) for i in range(2)]
        for i in range(2):
            if not torch.equal(parts[i], fused_dot_partial_ref(xs[i], halves[i], whole.point)):
                raise AssertionError(f"fused_dot_partial != plain at {fmt} M={m} K={k} N={n}")
        acc = parts[0] + parts[1]  # int32 adds wrap as the cross-rank sum does
        kw = dict(af_mode="identity", af_depth=fmt.frac + 1, af_fmt=fmt)
        got = fused_epilogue(acc, whole.point, **kw)
        if not torch.equal(got, fused_epilogue_ref(acc, whole.point, **kw)):
            raise AssertionError(f"fused_epilogue != plain at {fmt} M={m} N={n}")
        if not torch.equal(got, fused_dot_af(x, whole.data, whole.point, **kw)):
            raise AssertionError(f"split sum != fused over the whole of K at {fmt} M={m} "
                                 f"K={2 * k} N={n}")
        w, x0, elem = halves[0], xs[0], halves[0].element_size()
        iters = 60 if m <= 32 else 20
        ms = graph_ms(lambda: fused_dot_partial(x0, w, whole.point), iters)
        plain_ms = timed_ms(lambda: fused_dot_partial_ref(x0, w, whole.point), 5, 1)
        b_ms, b_by = costs.fused_dot_partial(m, n, k, elem).bound()
        lib = None
        if elem == 1:
            xq = torch.clamp(torch.round(x0 * 64), -128, 127).to(torch.int8)
            lib = int_mm_ms(xq, [w], iters)["k_major"]
        e_ms = graph_ms(lambda: fused_epilogue(acc, whole.point, **kw), iters)
        e_plain = timed_ms(lambda: fused_epilogue_ref(acc, whole.point, **kw), 5, 1)
        e_b, e_by = costs.fused_epilogue(m, n, "identity", fmt.frac + 1, fmt).bound()
        path = path_name(plan(m, n, k, elem, elem))
        rows.append(dict(M=m, K=k, N=n, fmt=str(fmt), path=path, bitwise_equal=True,
                         split_equals_fused=True, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, int_mm_ms=lib, epilogue_ms=e_ms,
                         epilogue_plain_ms=e_plain, epilogue_bound_ms=e_b,
                         epilogue_bound_by=e_by))
        log(f"tp partial {fmt} M={m} K={k} N={n} [{path}]: {ms:.4f} ms (plain {plain_ms:.3f}, "
            f"int_mm {lib}, bound {b_ms:.4f} {b_by}); epilogue {e_ms:.4f} ms (plain "
            f"{e_plain:.3f}, bound {e_b:.4f})")
    # the epilogue on full-range int32 sums: every AF, bf16 rounding on and off
    acc = torch.randint(-2**31, 2**31 - 1, (SLOTS, 2048), generator=gen, device=device,
                        dtype=torch.int64).to(torch.int32)
    for fmt in (FXP8, FXP16):
        point = prepared_weight(64, 64, fmt, gen, device)[0].point
        for af in FUSED_AFS:
            for compute_round in (False, True):
                kw = dict(af_mode=af, af_depth=fmt.frac + 1, af_fmt=fmt,
                          compute_round=compute_round)
                if not torch.equal(fused_epilogue(acc, point, **kw),
                                   fused_epilogue_ref(acc, point, **kw)):
                    raise AssertionError(f"fused_epilogue != plain: {fmt} {af} "
                                         f"compute_round={compute_round}")
        rows.append(dict(M=SLOTS, N=2048, fmt=str(fmt), af="all 7", compute_round="both",
                         full_range_int32=True, bitwise_equal=True))
    torch.cuda.synchronize()
    return rows + check_mac_split(device), max_err


def check_mac_split(device):
    """Kernel 6's split form (``mac_matmul_partial`` then ``mac_epilogue``)
    against its plain twins, bitwise, at olmo-1b's local row-parallel shapes
    (``TP_KERNEL_SHAPES``) at M 4, 16 (narrow) and 512 (wgmma), and FxP16
    int16 operands whose int32 sums wrap (imad); and the split identity: the
    epilogue (with and without ReLU) of the int32 sum of two K halves'
    partials equals ``mac_matmul`` over the whole of K. Times both kernels,
    their plain versions, their bounds (``costs.py``) and, at M > 16,
    ``torch._int_mm`` on the shard (the same int32 product)."""
    import torch

    from repro_torch.kernels import costs
    from repro_torch.kernels.cordic_mac import (mac_epilogue, mac_epilogue_ref, mac_matmul,
                                                mac_matmul_partial, mac_matmul_partial_ref)
    from repro_torch.kernels.int_dot import plan, to_k_major

    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    rows = []
    cases = [("fxp8", k, n, m) for k, n in TP_KERNEL_SHAPES for m in TP_KERNEL_MS]
    cases += [("fxp16", k, n, SLOTS) for k, n in TP_KERNEL_SHAPES]
    for case, k, n, m in cases:
        if case == "fxp8":
            x_q = torch.randint(-127, 128, (m, 2 * k), generator=gen, device=device).to(torch.int8)
            whole = torch.randint(-127, 128, (2 * k, n), generator=gen, device=device)
            whole = to_k_major(whole.to(torch.int8))
        else:  # near full range: each half's sums and their total pass 2^31
            x_q = torch.randint(30000, 32768, (m, 2 * k), generator=gen,
                                device=device).to(torch.int16)
            whole = to_k_major(torch.randint(24000, 32768, (2 * k, n), generator=gen,
                                             device=device).to(torch.int16))
        halves = [to_k_major(whole[i * k:(i + 1) * k]) for i in range(2)]
        xs = [x_q[:, i * k:(i + 1) * k].contiguous() for i in range(2)]
        x_scale = torch.rand((m, 1), generator=gen, device=device) * 1e-3
        w_scale = (torch.rand((1, n), generator=gen, device=device) - 0.5) * 1e-3
        parts = [mac_matmul_partial(xs[i], halves[i]) for i in range(2)]
        for i in range(2):
            if not torch.equal(parts[i], mac_matmul_partial_ref(xs[i], halves[i])):
                raise AssertionError(f"mac_matmul_partial != plain at {case} M={m} K={k} N={n}")
        acc = parts[0] + parts[1]  # int32 adds wrap as the cross-rank sum does
        for relu in (False, True):
            got = mac_epilogue(acc, x_scale, w_scale, fuse_relu=relu)
            if not torch.equal(got, mac_epilogue_ref(acc, x_scale, w_scale, fuse_relu=relu)):
                raise AssertionError(f"mac_epilogue != plain at {case} M={m} N={n} relu={relu}")
            if not torch.equal(got, mac_matmul(x_q, whole, x_scale, w_scale, fuse_relu=relu)):
                raise AssertionError(f"split sum != cordic_mac over the whole of K at {case} "
                                     f"M={m} K={2 * k} N={n} relu={relu}")
        w, x0, elem = halves[0], xs[0], x_q.element_size()
        iters = 60 if m <= 32 else 20
        ms = graph_ms(lambda: mac_matmul_partial(x0, w), iters)
        plain_ms = timed_ms(lambda: mac_matmul_partial_ref(x0, w), 5, 1)
        b_ms, b_by = costs.cordic_mac_partial(m, n, k, elem).bound()
        lib = int_mm_ms(x0, [w], iters)["k_major"]
        e_ms = graph_ms(lambda: mac_epilogue(acc, x_scale, w_scale), iters)
        e_plain = timed_ms(lambda: mac_epilogue_ref(acc, x_scale, w_scale), 5, 1)
        e_b, e_by = costs.cordic_mac_epilogue(m, n).bound()
        path = path_name(plan(m, n, k, elem, elem))
        rows.append(dict(kernel="cordic_mac_partial", M=m, K=k, N=n, fmt=case, path=path,
                         bitwise_equal=True, split_equals_whole=True, max_abs_err=0.0, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, int_mm_ms=lib,
                         epilogue_ms=e_ms, epilogue_plain_ms=e_plain, epilogue_bound_ms=e_b,
                         epilogue_bound_by=e_by))
        log(f"tp mac partial {case} M={m} K={k} N={n} [{path}]: {ms:.4f} ms (plain "
            f"{plain_ms:.3f}, int_mm {lib}, bound {b_ms:.4f} {b_by}); epilogue {e_ms:.4f} ms "
            f"(plain {e_plain:.3f}, bound {e_b:.4f})")
    torch.cuda.synchronize()
    return rows


def check_tp_attention(device):
    """The cache-attention kernels on a mesh rank's share of a decode step,
    their key splits planned from the whole batch and head counts
    (``plan_dims``): GQA at olmo-1b's decode (B4 S1 T512 H16 KV16 hd128) on
    the second half of the heads (a model rank of 2) and on the second half
    of the slots and heads (a (2, 2) rank), MLA at deepseek-v3's (B4 S1 T512
    H128 R512 r64) on the second half of the heads. Each local call's rows
    must equal the whole call's rows of those slots and heads bit for bit;
    whether they still would with splits planned from the local shapes is
    recorded. Times the local calls, their plain versions and bounds."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import costs
    from repro_torch.kernels.decode_attention import (gqa_decode_attention,
                                                      gqa_decode_attention_ref,
                                                      mla_decode_attention,
                                                      mla_decode_attention_ref)
    from repro_torch.kernels.decode_attention.ops import gqa_plan, mla_splits

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    rows = []
    b, t, h, hd = SLOTS, MAX_LEN, 16, 128
    q, ck, cv, pos = attention_case(b, 1, t, h, h, hd, gen, device)
    scale = 1.0 / math.sqrt(hd)
    whole = gqa_decode_attention(q, ck, cv, pos, scale=scale)
    for label, sl in (("heads 8-15 of 16", slice(0, b)), ("slots 2-3, heads 8-15", slice(2, 4))):
        lq, lk, lv, lp = (x[sl].contiguous() for x in (q, ck, cv, pos))
        lq, lk, lv = (x[:, :, 8:].contiguous() for x in (lq, lk, lv))
        lb = lq.shape[0]
        plan = (b, h, h)
        got = gqa_decode_attention(lq, lk, lv, lp, scale=scale, plan_dims=plan)
        if not torch.equal(got, whole[sl, :, 8:]):
            raise AssertionError(f"GQA on a rank's share ({label}) != the whole call's rows")
        unplanned = torch.equal(gqa_decode_attention(lq, lk, lv, lp, scale=scale),
                                whole[sl, :, 8:])
        call = lambda: gqa_decode_attention(lq, lk, lv, lp, scale=scale,  # noqa: E731
                                            plan_dims=plan)
        b_ms, b_by = costs.gqa_decode_attention(lb, 1, 8, t, 8, hd).bound()
        # the library's call on the same share: SDPA over the rank's heads
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (lq, lk, lv))
        mask = (torch.arange(t, device=device)[None, None, :] <= lp[:, :, None])[:, None]
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                 scale=scale), 60)
        rows.append(dict(kernel="gqa_decode_attention", share=label, B=lb, H=8, KV=8, T=t,
                         splits_global=gqa_plan(b, 1, h, t, h).splits,
                         splits_local=gqa_plan(lb, 1, 8, t, 8).splits,
                         bitwise_whole_rows=True, bitwise_without_plan=unplanned,
                         ms=graph_ms(call, 60),
                         plain_ms=timed_ms(lambda: gqa_decode_attention_ref(
                             lq, lk, lv, lp, scale=scale), 5, 1),
                         sdpa_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"tp attention GQA {label}: {rows[-1]['ms']:.4f} ms (sdpa {lib_ms:.4f}), splits "
            f"{rows[-1]['splits_global']} (local plan {rows[-1]['splits_local']})")
    cfg = get_config("deepseek-v3-671b")
    m, h = cfg.mla, cfg.num_heads
    r, rd = m.kv_lora_rank, m.qk_rope_head_dim
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + rd)
    ql = torch.randn((b, 1, h, r), generator=gen, device=device)
    qr = torch.randn((b, 1, h, rd), generator=gen, device=device)
    ckv = torch.randn((b, t, r), generator=gen, device=device)
    kr = torch.randn((b, t, rd), generator=gen, device=device)
    pos = torch.full((b, 1), t - 1, dtype=torch.int32, device=device)
    whole = mla_decode_attention(ql, qr, ckv, kr, pos, scale=scale)
    lql, lqr = ql[:, :, h // 2:].contiguous(), qr[:, :, h // 2:].contiguous()
    got = mla_decode_attention(lql, lqr, ckv, kr, pos, scale=scale, plan_dims=(b, h))
    if not torch.equal(got, whole[:, :, h // 2:]):
        raise AssertionError("MLA on a rank's heads != the whole call's rows")
    unplanned = torch.equal(mla_decode_attention(lql, lqr, ckv, kr, pos, scale=scale),
                            whole[:, :, h // 2:])
    call = lambda: mla_decode_attention(lql, lqr, ckv, kr, pos, scale=scale,  # noqa: E731
                                        plan_dims=(b, h))
    b_ms, b_by = costs.mla_decode_attention(b, 1, h // 2, t, r, rd).bound()
    # SDPA on the concatenation form of the rank's heads (as check_mla's yardstick)
    q_cat = torch.cat([lql, lqr], -1).transpose(1, 2).contiguous()
    k_cat, v = torch.cat([ckv, kr], -1)[:, None], ckv[:, None]
    mask = (torch.arange(t, device=device)[None, None, :] <= pos[:, :, None])[:, None]
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        q_cat, k_cat, v, attn_mask=mask, scale=scale, enable_gqa=True), 60)
    rows.append(dict(kernel="mla_decode_attention", share=f"heads {h // 2}-{h - 1} of {h}",
                     B=b, H=h // 2, T=t, splits_global=mla_splits(b, 1, h, t),
                     splits_local=mla_splits(b, 1, h // 2, t), bitwise_whole_rows=True,
                     bitwise_without_plan=unplanned, ms=graph_ms(call, 60),
                     plain_ms=timed_ms(lambda: mla_decode_attention_ref(
                         lql, lqr, ckv, kr, pos, scale=scale), 5, 1),
                     sdpa_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
    log(f"tp attention MLA {rows[-1]['share']}: {rows[-1]['ms']:.4f} ms (sdpa {lib_ms:.4f}), "
        f"splits "
        f"{rows[-1]['splits_global']} (local plan {rows[-1]['splits_local']})")
    torch.cuda.synchronize()
    return rows


# replicated kv heads: (arch, model axis, rank) at stock head counts; the
# rank's q heads read one kv head of the whole K/V (yi-9b at 8: q heads
# 20-23 on kv head 2; qwen3-8b at 16: q heads 6-7 on kv head 1)
KV_REPLICATED = (("yi-9b", 8, 5), ("qwen3-8b", 16, 3))
# (B, S, start): decode, then the prefill buckets 16, 64 and 512 from row 0
KV_REPLICATED_GQA = ((SLOTS, 1, None), (1, 16, 0), (1, 64, 0), (1, BUCKET, 0))


def check_kv_replicated(device):
    """Kernels 2 and 7 on a mesh rank's q heads against the whole kv heads
    (``head_offset``, ``groups``: read in place, never sliced), at stock
    head counts, hd 128 and T 512 (``KV_REPLICATED``): GQA at decode B4 S1
    (split keys, planned from the global B, H, KV) and at the prefill
    buckets 16, 64 and 512 from row 0 (tensor cores); flash at B1 S512,
    causal. Each rank call's rows must equal the whole unmeshed call's rows
    for those heads bit for bit, and its plain version to ``TOLERANCE``.
    Times each rank call, its plain version and SDPA over the rank's heads
    (K/V repeated to them outside the timing), beside its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import costs
    from repro_torch.kernels.decode_attention import (TOLERANCE, gqa_decode_attention,
                                                      gqa_decode_attention_ref)
    from repro_torch.kernels.decode_attention.ops import gqa_plan
    from repro_torch.kernels.decode_attention.ref import kv_rows
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    rows, t, hd = [], MAX_LEN, 128
    for arch, m, rank in KV_REPLICATED:
        cfg = get_config(arch)
        h, kv = cfg.num_heads, cfg.num_kv_heads
        h_loc, groups = h // m, h // kv
        h0 = rank * h_loc
        share = dict(head_offset=h0, groups=groups)
        kv_read = (h0 + h_loc - 1) // groups - h0 // groups + 1
        label = f"{arch} rank {rank} of {m}: q heads {h0}-{h0 + h_loc - 1} of {h}"
        for b, s, start in KV_REPLICATED_GQA:
            q, ck, cv, pos = attention_case(b, s, t, h, kv, hd, gen, device, start)
            scale = 1.0 / math.sqrt(hd)
            whole = gqa_decode_attention(q, ck, cv, pos, scale=scale)[:, :, h0:h0 + h_loc]
            lq = q[:, :, h0:h0 + h_loc].contiguous()
            call = lambda: gqa_decode_attention(  # noqa: E731
                lq, ck, cv, pos, scale=scale, plan_dims=(b, h, kv), **share)
            got = call()
            if not torch.equal(got, whole):
                raise AssertionError(f"GQA on {label} at B{b} S{s} != the whole call's rows")
            want = gqa_decode_attention_ref(lq, ck, cv, pos, scale=scale, **share)
            err = (got - want).abs().max().item()
            if not err <= TOLERANCE:
                raise AssertionError(f"GQA on {label} at B{b} S{s}: max|diff| {err} against "
                                     f"its plain version > {TOLERANCE}")
            qt = lq.transpose(1, 2).contiguous()
            kt, vt = (kv_rows(c, h_loc, **share).transpose(1, 2).contiguous() for c in (ck, cv))
            mask = (torch.arange(t, device=device)[None, None, :] <= pos[:, :, None])[:, None]
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale), 60)
            b_ms, b_by, b3_ms = attention_bounds(lq, kv_read, t, pos)
            path, splits = gqa_plan(b, s, h, t, kv)
            rows.append(dict(kernel="gqa_decode_attention", share=label, B=b, S=s, T=t,
                             H=h_loc, KV=kv, kv_read=kv_read, hd=hd, path=path, splits=splits,
                             positions="decode" if s == 1 else "from row 0",
                             bitwise_whole_rows=True, tolerance=TOLERANCE, max_abs_err=err,
                             ms=graph_ms(call, 60),
                             plain_ms=timed_ms(lambda: gqa_decode_attention_ref(
                                 lq, ck, cv, pos, scale=scale, **share), 5, 1),
                             sdpa_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bound_tf32_ms=b3_ms))
            log(f"kv replicated GQA {label} B{b} S{s} [{path}, {splits} splits]: "
                f"{rows[-1]['ms']:.4f} ms (plain {rows[-1]['plain_ms']:.3f}, sdpa "
                f"{lib_ms:.4f}, bound {b_ms:.4f} {b_by}) err {err:.2e}")
        s = BUCKET
        q, k, v = (torch.randn((1, s, n, hd), generator=gen, device=device)
                   for n in (h, kv, kv))
        lq = q[:, :, h0:h0 + h_loc].contiguous()
        whole = flash_attention(q, k, v, causal=True)[:, :, h0:h0 + h_loc]
        call = lambda: flash_attention(lq, k, v, causal=True, **share)  # noqa: E731
        got = call()
        if not torch.equal(got, whole):
            raise AssertionError(f"flash on {label} != the whole call's rows")
        want = flash_attention_ref(lq, k, v, causal=True, **share)
        err = (got - want).abs().max().item()
        if not err <= TOLERANCE:
            raise AssertionError(f"flash on {label}: max|diff| {err} against its plain "
                                 f"version > {TOLERANCE}")
        qt = lq.transpose(1, 2).contiguous()
        kt, vt = (kv_rows(c, h_loc, **share).transpose(1, 2).contiguous() for c in (k, v))
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                          60)
        cost = costs.flash_attention(1, s, h_loc, kv_read, hd, 4, True)
        b_ms, b_by = cost.bound()
        rows.append(dict(kernel="flash_attention", share=label, B=1, S=s, H=h_loc, KV=kv,
                         kv_read=kv_read, hd=hd, causal=True, bitwise_whole_rows=True,
                         tolerance=TOLERANCE, max_abs_err=err, ms=graph_ms(call, 60),
                         plain_ms=timed_ms(lambda: flash_attention_ref(
                             lq, k, v, causal=True, **share), 5, 1),
                         sdpa_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         bound_tf32_ms=cost.bound_tf32_ms()))
        log(f"kv replicated flash {label} S{s}: {rows[-1]['ms']:.4f} ms (plain "
            f"{rows[-1]['plain_ms']:.3f}, sdpa {lib_ms:.4f}, bound {b_ms:.4f} {b_by}) "
            f"err {err:.2e}")
    torch.cuda.synchronize()
    return rows


# the meshed dry run's cell on the card machine: rank 0 of the 16x16 mesh in
# a fake process group, on meta tensors (no card work)
DRYRUN_MESH_CELL = ("olmo-1b", "decode_32k", "kernel")


def dryrun_mesh_cell() -> dict:
    """One meshed dry-run cell (``launch.dryrun --mesh single``, kernel mode,
    prepared) in a subprocess of its own, as the CLI runs it: its record
    must be ``ok``, with the reference's keys and collectives by kind."""
    arch, shape, mode = DRYRUN_MESH_CELL
    out = ROOT / "chiprun_out" / "dryrun_mesh"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--mesh", "single", "--mode", mode, "--prepared", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"dryrun --mesh single exited {proc.returncode}: "
                           f"{proc.stderr[-1500:]}{proc.stdout[-500:]}")
    rec = json.loads((out / f"{arch}__{shape}__single__{mode}__prepared.json").read_text())
    missing = [k for k in ("flops_dev", "hbm_bytes_dev", "coll_bytes_dev", "coll_by_kind",
                           "memory", "fits_one_card") if k not in rec]
    if rec.get("status") != "ok" or missing or not rec["coll_by_kind"]:
        raise AssertionError(f"dryrun --mesh single: status {rec.get('status')}, missing "
                             f"{missing}, collectives {rec.get('coll_by_kind')}: "
                             f"{rec.get('error')}")
    log(f"dryrun mesh single {arch} {shape}: {wall:.1f} s, flops {rec['flops_dev']:.3e}, "
        f"coll {rec['coll_by_kind']}")
    return {k: rec[k] for k in ("arch", "shape", "mesh", "mesh_shape", "rank", "mode",
                                "status", "trace_s", "flops_dev", "hbm_bytes_dev",
                                "coll_bytes_dev", "coll_by_kind", "memory", "fits_one_card")
            } | {"wall_s": wall}


def tp_scan_cfg(name: str):
    """A scan arch at stock widths, f32, its depth cut to ``TP_SCAN_LAYERS``
    (seamless's encoder too, which the served decoder never runs)."""
    cfg = tp_cfg(name, TP_SCAN_LAYERS[name])
    if cfg.encdec is not None:
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, encoder_layers=TP_SCAN_LAYERS[name]))
    return cfg


def tp_cfg(name: str, layers=None, experts=None):
    """``name`` at stock widths, f32, cut to ``layers`` and ``experts``."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(name), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))
    return cfg


def row_parallel_dots(cfg) -> int:
    """The row-parallel dots of one decode forward of ``cfg`` on a model axis
    that splits every head count and MLP width (the archs the smoke meshes
    at 2): attention ``o`` and the dense and shared MLPs' ``down`` a layer
    (a MoE layer's routed experts are EP, not row-parallel), a Mamba2
    layer's ``out_proj``, zamba2's shared block's ``o`` and ``down`` a
    group, a seamless decoder layer's self and cross ``o`` and ``down``."""
    if cfg.family == "ssm":
        return cfg.num_layers
    if cfg.family == "hybrid":
        return cfg.num_layers + 2 * hybrid_groups(cfg)
    if cfg.family == "audio":
        return 3 * cfg.num_layers
    moe = moe_layers(cfg)
    rows = 2 * (cfg.num_layers - moe)
    if moe:
        rows += (1 + bool(cfg.moe.num_shared_experts)) * moe
    return rows


def tp_launches_per_forward(cfg, model_split: int, mode: str = "kernel",
                            per_call: bool = False) -> dict:
    """``launches_per_forward`` on a model axis of ``model_split``: every
    row-parallel dot (:func:`row_parallel_dots`) is one partial-sum and one
    epilogue launch in place of a whole one: kernel 1's in prepared kernel
    mode, kernel 6's in the int8 mode and per call."""
    want = launches_per_forward(cfg, per_call, mode)
    if model_split == 1:
        return want
    rows = row_parallel_dots(cfg)
    dot = "cordic_mac" if mode == "int8" or per_call else "fused_dot_af"
    split = ("cordic_mac_partial", "cordic_mac_epilogue") if dot == "cordic_mac" else (
        "fused_dot_partial", "fused_epilogue")
    want[dot] -= rows
    for name in split:
        want[name] = rows
    return want


def tp_instantiations(cfg, server, reqs, model_split: int, mode: str = "kernel",
                      per_call: bool = False) -> dict:
    """Launches by instantiation of one rank's uncaptured meshed run: one
    forward a request over its bucket (the scan archs: one single-row
    forward a prompt token, on every rank), and the decode steps over the
    rank's local slots."""
    from repro_torch.serve.kvcache import bucket_length

    per_forward = tp_launches_per_forward(cfg, model_split, mode, per_call)
    want = by_instantiation(per_forward, server._local_slots, 1, server.decode_steps)
    if scan_prefill(cfg):
        return add_counts(want, by_instantiation(per_forward, 1, 1,
                                                 sum(len(r.prompt) for r in reqs)))
    for r in reqs:
        b = bucket_length(len(r.prompt), server.max_len)
        add_counts(want, by_instantiation(per_forward, b, b))
    return want


def digest(t) -> str:
    """sha256 of a tensor's bytes (a bitwise comparison across processes)."""
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def tp_serve(cfg, mesh, device, forward_batch=None, max_new=None, snapshot=True, lens=None,
             mode="kernel", per_call=False):
    """Serve ``cfg`` on ``mesh`` (None: one device) uncaptured on the card,
    the smoke's prompts (or ``lens``) and ``max_new`` (default
    ``TP_MAX_NEW``) new tokens, in ``mode`` (prepared, or ``per_call``),
    from the seeded weights (this rank's shards of them; in the int8 mode
    the whole tree, which the server prepares whole and then shards); with
    ``forward_batch`` (B, S) also a cache-free ``forward`` under
    ``attn_impl="flash"``. Returns the streams, margins, run record,
    launches and, meshed, the run's collective bytes and (``snapshot``) one
    greedy burst's."""
    import numpy as np
    import torch

    from repro_torch.kernels import kernel_totals
    from repro_torch.models import get_model
    from repro_torch.serve.engine import BatchedServer
    from repro_torch.sharding import collectives

    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=device).manual_seed(SEED),
                        mesh=None if mode == "int8" else mesh)
    server = BatchedServer(model, kernel_ctx() if mode == "kernel" else mode_ctx(mode), params,
                           slots=SLOTS, max_len=MAX_LEN, burst=BURST, device=device,
                           capture=False, mesh=mesh, prepare_weights=not per_call)
    del params
    setup_peak = torch.cuda.max_memory_allocated() / 2**30
    reqs = requests(cfg, lens=lens, max_new=max_new or TP_MAX_NEW)
    zero_launches()
    collectives.reset_counts()
    out, run = timed_run(server, reqs)
    counts = wrapper_counts()
    rep = dict(streams={int(k): v for k, v in out.items()}, margins=margins(reqs), run=run,
               setup_peak_gib=setup_peak, launches=kernel_totals(nonzero(counts)),
               by_instantiation=nonzero(counts), decode_steps=server.decode_steps,
               prefill_steps=server.prefill_steps)
    m = mesh.size("model") if mesh is not None else 1
    want = tp_instantiations(cfg, server, reqs, m, mode, per_call)
    if nonzero(counts) != nonzero(want):
        raise AssertionError(f"{cfg.name} {mode}{' per call' if per_call else ''} mesh {mesh}: "
                             f"launches {nonzero(counts)} != {nonzero(want)}")
    if mesh is not None:
        rep["collectives_run"] = collectives.counts()
        rep["sharding"] = server.shardings.snapshot()
        if snapshot:
            rep["collective_snapshot"] = server.collective_snapshot()
    if forward_batch is not None:
        ctx = dataclasses.replace(server.ctx, attn_impl="flash")  # the mesh and its FSDP specs
        tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, forward_batch).astype(np.int64)).to(device)
        zero_launches()
        with torch.no_grad():
            logits, _ = model.forward(server.params, {"tokens": tokens}, ctx)
        torch.cuda.synchronize()
        fw = kernel_totals(nonzero(wrapper_counts()))
        want_fw = dict(forward_launches(cfg, "flash"))
        if m > 1:
            rows = row_parallel_dots(cfg)
            want_fw.update(fused_dot_af=want_fw["fused_dot_af"] - rows,
                           fused_dot_partial=rows, fused_epilogue=rows)
        if fw != want_fw:
            raise AssertionError(f"{cfg.name} forward mesh {mesh}: launches {fw} != {want_fw}")
        rep["forward"] = dict(batch=list(forward_batch), launches=fw, logits=digest(logits))
    del server
    free_card()
    return rep


def tp_rank(rank, world, shape, jobs):
    """One spawned rank of a tp phase (``launch.mesh.spawn``): its ``shape``
    mesh over the process group, then :func:`tp_serve` of each job in turn
    (each frees the card before the next)."""
    import torch

    from repro_torch.launch.mesh import mesh_from_shape

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_from_shape(shape)
    device = torch.device("cuda", torch.cuda.current_device())
    return [tp_serve(job["cfg"], mesh, device, job.get("forward"), job.get("max_new"),
                     job.get("snapshot", True), job.get("lens"), job.get("mode", "kernel"),
                     job.get("per_call", False)) for job in jobs]


def tp_meshed(shape, runs, backend="gloo") -> dict:
    """Serve every ``(label, base, job)`` of ``runs`` on one ``shape`` mesh of
    spawned ranks sharing the card (one spawn for them all): each rank's
    streams and f32 top-2 margins (and, for a job with a ``forward``, the
    forward's logits) must equal its one-device run ``base`` bit for bit.
    Returns label -> record."""
    from repro_torch.launch.mesh import spawn

    world = shape[0] * shape[1]
    t0 = time.perf_counter()
    per_rank = spawn(tp_rank, world, args=(shape, [job for _, _, job in runs]),
                     backend=backend, device="cuda:0", timeout=900)
    wall = time.perf_counter() - t0
    out = {}
    for i, (label, base, job) in enumerate(runs):
        reps = [ranks[i] for ranks in per_rank]
        for r, rep in enumerate(reps):
            if rep["streams"] != base["streams"]:
                raise AssertionError(f"{label}: rank {r}'s streams differ from mesh=None's")
            if rep["margins"] != base["margins"]:
                raise AssertionError(f"{label}: rank {r}'s top-2 margins differ from "
                                     "mesh=None's")
            if job.get("forward") and rep["forward"]["logits"] != base["forward"]["logits"]:
                raise AssertionError(f"{label}: rank {r}'s forward logits differ from "
                                     "mesh=None's")
        out[label] = dict(config=label, mesh=list(shape), backend=backend, ranks=world,
                          spawn_wall_s=wall, streams_equal=True, margins_bitwise=True,
                          rank0={k: v for k, v in reps[0].items()
                                 if k not in ("streams", "margins")},
                          launches=reps[0]["launches"], tokens=reps[0]["run"]["tokens"],
                          mesh_none_run=base["run"],
                          rank_launches=[rep["by_instantiation"] for rep in reps])
    return out


def tp_phases(device) -> dict:
    """Tensor-parallel serving on the card, each configuration against the
    same server's mesh=None uncaptured run, streams and f32 top-2 margins
    bitwise, each rank's launches exact by instantiation (column dots
    fused, row dots partial-sum + epilogue): on a (1, 2) mesh of two gloo
    ranks sharing the card, full-width olmo-1b (16 layers, also a flash
    forward's logits bitwise), llama4's dense/MoE pair and deepseek-v3 (MLA,
    4 layers) with their routed experts cut (``TP_*_EXPERTS``), and, cut to
    ``TP_NEW_PROMPTS`` and ``TP_NEW_MAX_NEW`` tokens, full-width olmo-1b in
    the int8 mode and per call at ``PER_CALL_LAYERS`` (row dots: kernel 6's
    partial-sum + epilogue) and the scan archs at ``TP_SCAN_LAYERS`` (their
    single-token prefill steps on every rank), all in one spawn; olmo-1b at
    4 layers on (2, 1), its FSDP gathers cut to
    ``TP_FSDP_PROMPTS`` and ``TP_FSDP_MAX_NEW`` tokens, and on (1, 1) under
    NCCL (world size 1). Two ranks time-share the card and gloo moves every
    collective through the host: the tok/s are a smoke reading, not a
    tensor-parallel speed."""
    out = {}
    runs = []
    for label, cfg, forward in (
            ("olmo-1b (1,2)", olmo(), (1, BUCKET)),
            ("llama4-maverick-400b-a17b (1,2)",
             tp_cfg("llama4-maverick-400b-a17b", 2, TP_LLAMA4_EXPERTS), None),
            ("deepseek-v3-671b (1,2)",
             tp_cfg("deepseek-v3-671b", DEEPSEEK_LAYERS, TP_DEEPSEEK_EXPERTS), None)):
        log(f"tp {label} mesh=None")
        runs.append((label, tp_serve(cfg, None, device, forward_batch=forward),
                     dict(cfg=cfg, forward=forward)))
    # kernel 6's split form (the int8 mode, per call) and the scan archs
    cut = dict(max_new=TP_NEW_MAX_NEW, lens=TP_NEW_PROMPTS)
    for label, cfg, kw in (
            ("olmo-1b int8 (1,2)", olmo(), dict(mode="int8")),
            (f"olmo-1b per-call {PER_CALL_LAYERS} layers (1,2)", olmo(PER_CALL_LAYERS),
             dict(per_call=True)),
            *((f"{name} {TP_SCAN_LAYERS[name]} layers (1,2)", tp_scan_cfg(name), {})
              for name in TP_SCAN_LAYERS)):
        log(f"tp {label} mesh=None")
        runs.append((label, tp_serve(cfg, None, device, **cut, **kw),
                     dict(cfg=cfg, **cut, **kw)))
    log("tp (1,2): olmo-1b, llama4-maverick, deepseek-v3, olmo-1b int8 and per call, "
        "mamba2, zamba2, seamless")
    out.update(tp_meshed((1, 2), runs))
    for label in ("llama4-maverick-400b-a17b (1,2)", "deepseek-v3-671b (1,2)"):
        out[label]["weights"] = weight_reckoning(runs[[r[0] for r in runs].index(label)][2]["cfg"])
    cut = olmo(TP_CUT_LAYERS)
    fsdp = dict(max_new=TP_FSDP_MAX_NEW, lens=TP_FSDP_PROMPTS)
    log("tp olmo-1b 4 layers (2,1)")
    out.update(tp_meshed((2, 1), [("olmo-1b 4 layers (2,1)", tp_serve(cut, None, device, **fsdp),
                                   dict(cfg=cut, snapshot=False, **fsdp))]))
    log("tp olmo-1b 4 layers (1,1) nccl")
    out.update(tp_meshed((1, 1), [("olmo-1b 4 layers (1,1) nccl", tp_serve(cut, None, device),
                                   dict(cfg=cut))], backend="nccl"))
    import torch

    top = out["olmo-1b (1,2)"]
    out["record"] = dict(
        kind=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi(),
        wall_s=top["rank0"]["run"]["wall_s"], tokens_per_s=top["rank0"]["run"]["tokens_per_s"],
        mesh_none_tokens_per_s=top["mesh_none_run"]["tokens_per_s"],
        collective_bytes_run=top["rank0"]["collectives_run"]["collective_bytes"],
        collective_bytes_burst=top["rank0"]["collective_snapshot"]["collective_bytes"])
    return out


# ---------------------------------------------------------------------------
# train_tp: training on a (data, model) mesh of two gloo ranks sharing the card
# ---------------------------------------------------------------------------

# steps a run: the first from the seeded weights, the second from where
# mesh=None's first ended, each against the same step on mesh=None. Runs
# from their own first steps parted by 3.0e-4 in int8's second loss on the
# card: their first steps' parameters differ by reduction-order ulps
# (<= 9.2e-7, at channel maxima and in the embedding), which the int8
# forward's rounding amplifies; at the same parameters the meshed second
# loss is mesh=None's bitwise (benchmarks/int8_mesh_probe.py)
TP_TRAIN_STEPS = 2
# (2, 1) FSDP-gathers every weight over gloo and sums every gradient there
# (~0.9 GB a layer and the 0.4 GB tied embedding each way a step): olmo-1b
# cut to 2 of its 16 layers; (1, 2) runs all 16
TP_TRAIN_FSDP_LAYERS = 2
TP_TRAIN_RUNS = (("olmo-1b exact (1,2)", (1, 2), "exact", None),
                 ("olmo-1b int8 (1,2)", (1, 2), "int8", None),
                 (f"olmo-1b {TP_TRAIN_FSDP_LAYERS} layers exact (2,1)", (2, 1), "exact",
                  TP_TRAIN_FSDP_LAYERS))
# the meshed step against mesh=None: tests/test_torch_train.py's tolerances
# in the exact and int8 modes
TP_TRAIN_TOL = dict(loss=1e-5, grad=1e-5)
# the wrappers' launch functions whose first calls are held bitwise against
# their plain versions (the CPU rehearsal names the plain versions here)
TP_TRAIN_RECORD = {"partial": "_launch_partial", "epilogue": "_launch_epilogue"}


def tp_int8_train_launches(cfg, steps: int, remat: bool = True) -> dict:
    """Kernel 6's launches on a rank of a model axis that splits every head
    count and MLP width, in ``steps`` int8 train steps: the column-parallel
    dots (q k v gate up a layer, the lm_head) as ``int8_train_launches``
    counts them (forward, again under remat, and a backward launch for all
    but the gate's); the row-parallel ones (o and down) as a partial-sum and
    an epilogue launch, forward and again under remat, and none backward
    (the epilogue's backward takes the scales' gradient from the int32 sum
    it saved)."""
    cols = 5 * cfg.num_layers
    rows = 2 * cfg.num_layers * (2 if remat else 1)
    whole = (cols + 1) + (cols if remat else 0) + (cols - cfg.num_layers + 1)
    return {"cordic_mac/wgmma": whole * steps, "cordic_mac_partial/wgmma": rows * steps,
            "cordic_mac_epilogue/elementwise": rows * steps}


def recording(module, name: str, calls: list, n: int):
    """Wrap ``module.name`` so that its first ``n`` calls are kept (inputs
    cloned, output cloned); returns the undo."""
    import torch

    fn = getattr(module, name)

    def run(*args, **kw):
        out = fn(*args, **kw)
        if len(calls) < n:
            calls.append(([a.clone() if torch.is_tensor(a) else a for a in args], dict(kw),
                          out.clone()))
        return out

    setattr(module, name, run)
    return lambda: setattr(module, name, fn)


def leaf_max(t, spec, mesh):
    """max |t| over the whole leaf of which ``t`` is this rank's shard."""
    from repro_torch.sharding import collectives
    from repro_torch.sharding.partition import sharded_axes

    out = t.abs().amax().reshape(1)
    for axis in sharded_axes(spec, mesh):
        out = collectives.amax(out, (0,), mesh, axis)
    return float(out)


def close_to_mesh_none(label, sh, got, want, met, base, tol, lr):
    """A meshed step's loss, gradient norm, parameter and moment shards
    (``got``: params, m, v, leaf lists) against mesh=None's (``want``, this
    rank's slices of them; ``base``: loss and gradient norm), to the CPU
    test's criteria: loss within ``tol["loss"]`` relative, the norm within
    ten times the gradient tolerance; ``m`` (the clipped gradient times
    1 - b1) within the gradient tolerance of its leaf's largest, ``v``
    within twice that; a parameter within ``2 lr`` and within 1e-6 where
    the gradient is settled. Returns the worst of each, relative."""
    from repro_torch.train import optimizer as opt

    if abs(float(met["loss"]) - base["loss"]) > tol["loss"] * abs(base["loss"]) or \
            abs(float(met["grad_norm"]) - base["grad_norm"]) > \
            10 * tol["grad"] * base["grad_norm"]:
        raise AssertionError(f"{label}: loss {float(met['loss'])!r}, grad norm "
                             f"{float(met['grad_norm'])!r} against mesh=None's "
                             f"{base['loss']!r}, {base['grad_norm']!r}")
    cfg = opt.AdamWConfig()
    clip = (1 - cfg.b1) * min(1.0, cfg.grad_clip / (base["grad_norm"] + 1e-9))
    worst = dict(m=0.0, v=0.0, params=0.0)
    for i, spec in enumerate(sh_specs(sh)):
        (p, m, v), (p0, m0, v0) = [(x[0][i], x[1][i], x[2][i]) for x in (got, want)]
        m_scale = max(leaf_max(m0, spec, sh.mesh), 1e-30)
        v_scale = max(leaf_max(v0, spec, sh.mesh), 1e-30)
        dm = float((m - m0).abs().max()) / m_scale
        dv = float((v - v0).abs().max()) / v_scale
        dp = (p - p0).abs()
        g0 = m0.abs() / clip
        settled = g0 > max(1e-6, 10 * tol["grad"] * m_scale / clip)
        d_settled = float(dp[settled].max()) if bool(settled.any()) else 0.0
        if dm > tol["grad"] or dv > 2 * tol["grad"] or float(dp.max()) > 2 * lr + 1e-6 \
                or d_settled > 1e-6:
            raise AssertionError(f"{label}: leaf {i}: m {dm}, v {dv} (of the leaf's largest), "
                                 f"parameters {float(dp.max())} ({d_settled} where settled)")
        worst = dict(m=max(worst["m"], dm), v=max(worst["v"], dv),
                     params=max(worst["params"], float(dp.max())))
    return worst


def sh_specs(sh) -> list:
    """The partition specs of a placement's leaves, in flatten order."""
    def walk(node):
        if isinstance(node, dict):
            return [s for k in sorted(node) for s in walk(node[k])]
        return [node]

    return walk(sh.specs)


def train_tp_run(rank, world, mesh, device, label, mode, layers, ckpt_dir):
    """One ``TP_TRAIN_RUNS`` run on a rank: ``TP_TRAIN_STEPS`` steps of
    olmo-1b (``layers``, full width, remat on) on mesh=None, one rank at a
    time (each keeps its slices of the first step's parameters and moments),
    then on ``mesh``, the first step held against mesh=None's
    (:func:`close_to_mesh_none`) and the second, from mesh=None's first
    step's shards, by its loss and gradient norm; in the int8 mode every
    launch of kernel 6 counted (``tp_int8_train_launches``) and its first
    split-form calls bitwise their plain versions; with ``ckpt_dir`` the meshed parameters
    saved with ``shardings=`` and restored on mesh=None bitwise."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import kernel_totals
    from repro_torch.kernels.cordic_mac import ops as mac_ops, ref as mac_ref
    from repro_torch.models import get_model
    from repro_torch.sharding import collectives
    from repro_torch.sharding.partition import shard_params, train_shardings
    from repro_torch.train import checkpoint, optimizer as opt
    from repro_torch.train._tree import tree_leaves, tree_unflatten

    cfg = olmo(layers)
    model = get_model(cfg)
    pipe = TokenPipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, device=device)
    specs = model.serving_specs()
    sh = train_shardings(specs, mesh)
    tol = TP_TRAIN_TOL

    def shards(tree):
        """This rank's shards of a whole tree's leaves, in flatten order."""
        return tree_leaves(shard_params(tree, specs, mesh))

    def init(m=None):
        params = model.init(torch.Generator(device=device).manual_seed(SEED), torch.float32,
                            mesh=m)
        return params, opt.init_state(params)

    # mesh=None, one rank after the other (a full-width run holds ~36-48 GiB)
    base = []
    for r in range(world):
        if r == rank:
            step_fn = train_step_fn(cfg, mode, TP_TRAIN_STEPS)
            params, state = init()
            for i in range(TP_TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, met = step_fn(params, state, pipe.batch(i))
                torch.cuda.synchronize()
                base.append(dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                                 lr=float(met["lr"]), ms=(time.perf_counter() - t0) * 1e3))
                if i == 0:
                    want = (shards(params), shards(state.m), shards(state.v))
            del params, state, step_fn
            free_card()
        dist.barrier()

    # the mesh
    calls = {k: [] for k in TP_TRAIN_RECORD}
    undo = [recording(mac_ops, name, calls[k], TRAIN_RECORD_CALLS)
            for k, name in TP_TRAIN_RECORD.items()] if mode == "int8" else []
    torch.cuda.reset_peak_memory_stats()
    step_fn = train_step_fn(cfg, mode, TP_TRAIN_STEPS, mesh=mesh)
    params, state = init(mesh)
    zero_launches()
    rep = dict(steps=[], mesh=list(mesh.shape.values()), mode=mode, layers=cfg.num_layers)
    try:
        for i in range(TP_TRAIN_STEPS):
            collectives.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, met = step_fn(params, state, pipe.batch(i))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            step = dict(ms=ms, loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                        mesh_none=base[i], collectives=collectives.counts())
            if i == 0:
                got = (tree_leaves(params), tree_leaves(state.m), tree_leaves(state.v))
                step["worst"] = close_to_mesh_none(f"{label} step 0", sh, got, want, met,
                                                   base[0], tol, base[0]["lr"])
                # the next step starts where mesh=None's first step ended, so
                # that it is the same step as mesh=None's second
                params = tree_unflatten(params, want[0])
                state = opt.AdamWState(state.step, tree_unflatten(state.m, want[1]),
                                       tree_unflatten(state.v, want[2]))
                del got, want
            elif abs(step["loss"] - base[i]["loss"]) > tol["loss"] * abs(base[i]["loss"]) or \
                    abs(step["grad_norm"] - base[i]["grad_norm"]) > \
                    10 * tol["grad"] * base[i]["grad_norm"]:
                raise AssertionError(f"{label} step {i}: loss {step['loss']!r}, grad norm "
                                     f"{step['grad_norm']!r} against mesh=None's "
                                     f"{base[i]['loss']!r}, {base[i]['grad_norm']!r}")
            rep["steps"].append(step)
            if rank == 0:
                log(f"train_tp {label} step {i}: {ms:.1f} ms (mesh=None {base[i]['ms']:.1f}), "
                    f"loss {step['loss']:.6f}")
    finally:
        for u in undo:
            u()
    counts = nonzero(wrapper_counts())
    rep.update(peak_gib=peak_gib(), launches=kernel_totals(counts), by_instantiation=counts,
               ms_per_step=sum(s["ms"] for s in rep["steps"][1:]) / max(TP_TRAIN_STEPS - 1, 1),
               mesh_none_ms_per_step=sum(b["ms"] for b in base[1:]) / max(TP_TRAIN_STEPS - 1, 1))
    if mode == "int8":
        want_counts = tp_int8_train_launches(cfg, TP_TRAIN_STEPS)
        rep["launches_by_instantiation"] = check_instantiations(label, counts, want_counts)
        plain = {"partial": lambda a, kw: mac_ref.mac_matmul_partial_ref(*a[:2]),
                 "epilogue": lambda a, kw: mac_ref.mac_epilogue_ref(
                     *a[:3], fuse_relu=a[3] if len(a) > 3 else kw.get("fuse_relu", False))}
        for kind, recorded in calls.items():
            if not recorded:
                raise AssertionError(f"{label}: no {kind} launch recorded")
            for args, kw, out in recorded:
                if not torch.equal(out, plain[kind](args, kw)):
                    raise AssertionError(f"{label}: a {kind} launch differs from its plain "
                                         f"version at {[tuple(a.shape) for a in args[:2]]}")
        rep["bitwise_plain_calls"] = {k: [list(a[0].shape) for a, _, _ in v]
                                      for k, v in calls.items()}
    elif counts:
        raise AssertionError(f"{label}: the exact mode launched port kernels: {counts}")
    del calls
    if ckpt_dir is not None:  # written on the mesh, restored on mesh=None
        t0 = time.perf_counter()
        checkpoint.save(ckpt_dir, TP_TRAIN_STEPS, params, shardings=sh)
        rep["checkpoint_save_s"] = time.perf_counter() - t0
        mine = [t.to("cpu") for t in tree_leaves(params)]
        del params, state
        free_card()
        whole = checkpoint.restore(ckpt_dir, TP_TRAIN_STEPS, model.abstract_params(),
                                   device="cpu")
        if not all(torch.equal(a, b) for a, b in zip(shards(whole), mine)):
            raise AssertionError(f"{label}: the checkpoint restored on mesh=None differs from "
                                 "the meshed parameters")
        rep["checkpoint_restores_bitwise"] = True
        del whole, mine
        dist.barrier()
        if rank == 0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    free_card()
    return rep


def train_tp_rank(rank, world, runs, ckpt_dir, device=None):
    """One spawned rank of the train_tp phase: each run on its mesh, on
    ``device`` (default: the rank's card)."""
    import torch

    from repro_torch.launch.mesh import mesh_from_shape

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = device or torch.device("cuda", torch.cuda.current_device())
    meshes, out = {}, {}
    for label, shape, mode, layers in runs:
        if shape not in meshes:
            meshes[shape] = mesh_from_shape(shape)
        out[label] = train_tp_run(rank, world, meshes[shape], device, label, mode, layers,
                                  ckpt_dir if mode == "exact" and shape == (1, 2) else None)
    return out


def train_tp_phases(device) -> dict:
    """Training on a mesh of two gloo ranks sharing the card
    (``TP_TRAIN_RUNS``, one spawn): full-width olmo-1b (16 layers, f32,
    ``TRAIN_BATCH`` x ``TRAIN_SEQ``, remat on) on (1, 2) in the exact and
    int8 modes and at ``TP_TRAIN_FSDP_LAYERS`` layers on (2, 1), each
    ``TP_TRAIN_STEPS`` steps against mesh=None's on the card
    (:func:`train_tp_run`); the exact (1, 2) run's parameters checkpointed
    with ``shardings=`` and restored on mesh=None bitwise. Reports each
    rank's ms a step, peak GiB and collective bytes a step. Two ranks
    time-share the card and gloo moves every collective through the host:
    a smoke reading, not a tensor-parallel speed."""
    import torch

    from repro_torch.launch.mesh import spawn

    t0 = time.perf_counter()
    per_rank = spawn(train_tp_rank, 2,
                     args=(TP_TRAIN_RUNS, str(ROOT / "build" / "train_tp_ckpt")),
                     backend="gloo", device="cuda:0", timeout=900)
    wall = time.perf_counter() - t0
    out = {}
    for label, *_ in TP_TRAIN_RUNS:
        reps = [ranks[label] for ranks in per_rank]
        out[label] = dict(rank0=reps[0], launches=reps[0]["launches"],
                          rank_peak_gib=[r["peak_gib"] for r in reps],
                          rank_ms_per_step=[r["ms_per_step"] for r in reps],
                          rank_launches=[r["by_instantiation"] for r in reps])
    out["record"] = dict(kind=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi(),
                         spawn_wall_s=wall)
    log("train_tp: " + ", ".join(
        f"{label} {rep['rank0']['ms_per_step']:.1f} ms/step (mesh=None "
        f"{rep['rank0']['mesh_none_ms_per_step']:.1f}) {max(rep['rank_peak_gib']):.1f} GiB"
        for label, rep in out.items() if label != "record"))
    return out


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


PHASE_GROUPS = ("kernels", "olmo", "bank", "resilience", "frontend", "modes", "tp", "sim",
                "train", "parity", "deepseek", "archs", "scan")


def main(argv=()) -> int:
    """Every phase, with no arguments; ``--phases`` runs the named groups of
    ``PHASE_GROUPS`` only (a quicker check while working on one path; "bank",
    "resilience" and "frontend" need "olmo"), writes their report and prints
    no ``kernels`` and no ``ok`` line."""
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="on-card smoke test of the PyTorch/CUDA port")
    ap.add_argument("--phases", default=None,
                    help=f"comma-separated groups of {PHASE_GROUPS} (default: all)")
    args = ap.parse_args(list(argv))
    groups = None if args.phases is None else set(args.phases.split(","))
    if groups is not None and not groups <= set(PHASE_GROUPS):
        ap.error(f"--phases takes groups of {PHASE_GROUPS}")
    if groups is not None and groups & {"bank", "resilience", "frontend"}:
        groups.add("olmo")

    def want(group: str) -> bool:
        return groups is None or group in groups

    def setup():
        """The port's modules from ``src/`` beside this script, and a card."""
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.configs import get_config, reduced
        from repro_torch.kernels import _build
        from repro_torch.models import get_model

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available")
        return get_config, reduced, _build, get_model

    get_config, reduced, _build, get_model = phase("setup", setup)
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
    calibration = order = analysis = None
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
        chunk_rows, chunk_err = phase("check_chunk_attention", check_chunk_attention, device)
        chunk_as_prefill = phase("chunk_rows_as_prefill", chunk_rows_as_prefill, device)
        fxp16_af_rows = phase("check_fused_fxp16_af", check_fused_fxp16_af, device)
        int8_rows = phase("check_int8_mac", check_int8_mac, device)
        checks = {"fused_dot_af": fused_rows, "fused_dot_af_fxp16": hifi_rows,
                  "plan_alternatives": plan_rows, "cordic_mac": mac_rows,
                  "gqa_decode_attention": attn_rows, "gqa_path_alternatives": gqa_plan_rows,
                  "mla_decode_attention": mla_rows,
                  "af_elementwise": af_rows, "af_softmax": softmax_rows,
                  "flash_attention": flash_rows, "mla_flash_attention": mla_flash_rows,
                  "chunk_attention": chunk_rows, "chunk_rows_as_prefill": chunk_as_prefill,
                  "fused_dot_af_fxp16_af": fxp16_af_rows,
                  "cordic_mac_int8_mode": int8_rows}
        emit({"kernel_checks": checks})
        free_card()
        paths["softmax activate"] = phase("softmax_path", softmax_path, device)
        emit({"softmax_path": paths["softmax activate"]})

    if want("olmo"):
        serving["olmo-1b"], streams, olmo_margins, weights = phase(
            "serve olmo-1b", serve_full_width, device, "olmo-1b", olmo())
        emit({"serving": serving["olmo-1b"]})
        analysis = phase("analysis olmo-1b", analysis_phase, device, weights,
                         serving["olmo-1b"])
        emit({"analysis": analysis})
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
    if want("frontend"):
        # the streaming frontend, held against the plain run above
        serving["olmo-1b frontend"] = phase("frontend olmo-1b", frontend_phases, device,
                                            (streams, olmo_margins))
        emit({"serving": serving["olmo-1b frontend"]})
        free_card()
    if want("modes"):
        for key, rep in phase("modes olmo-1b", modes_phases, device).items():
            (parity if "card vs cpu" in key else serving)[f"olmo-1b {key}"] = rep
    tp = tp_rows = train_tp = dryrun_mesh = None
    if want("tp"):
        # kernel 1's split form, then tensor-parallel serving on ranks that
        # share the card
        tp_rows, tp_err = phase("check_tp_kernels", check_tp_kernels, device)
        checks["fused_split"] = tp_rows
        checks["attention_local_heads"] = phase("check_tp_attention", check_tp_attention, device)
        checks["attention_kv_replicated"] = phase("check_kv_replicated", check_kv_replicated,
                                                  device)
        emit({"kernel_checks": {"fused_split": tp_rows,
                                "attention_local_heads": checks["attention_local_heads"],
                                "attention_kv_replicated": checks["attention_kv_replicated"]}})
        free_card()
        dryrun_mesh = phase("dryrun mesh single", dryrun_mesh_cell)
        emit({"dryrun_mesh": dryrun_mesh})
        tp = phase("tp", tp_phases, device)
        for key, rep in tp.items():
            if key != "record":
                serving[f"{key} tp"] = rep
        emit({"tp": tp["record"]})
        free_card()
        # training on a mesh: kernel 6's split form under autograd
        train_tp = phase("train_tp", train_tp_phases, device)
        emit({"train_tp": train_tp})
        free_card()
    sim = training = None
    if want("sim"):
        sim = phase("sim olmo-1b", sim_phases, device)
        emit({"sim": sim})
        free_card()
    if want("train"):
        training = phase("train olmo-1b", train_phases, device)
        emit({"train": training})
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
        serving["deepseek-v3-671b"], ds_streams, ds_margins, weights = phase(
            "serve deepseek-v3-671b", serve_full_width, device, "deepseek-v3-671b", deepseek())
        emit({"serving": serving["deepseek-v3-671b"]})
        free_card()
        # the serving weights: 63 GB of f32 are not built twice
        forward["deepseek-v3-671b"] = phase("forward deepseek-v3-671b", forward_phase, device,
                                            "deepseek-v3-671b", deepseek(), weights, (1, BUCKET))
        emit({"forward": forward["deepseek-v3-671b"]})
        serving["deepseek-v3-671b frontend"] = phase(
            "frontend deepseek-v3-671b", chunked_frontend, device, "deepseek-v3-671b",
            deepseek(), weights, (ds_streams, ds_margins))
        emit({"serving": serving["deepseek-v3-671b frontend"]})
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
            analysis=analysis, forward=forward, card_vs_cpu=parity, sim=sim, train=training,
            tp=tp, train_tp=train_tp, dryrun_mesh=dryrun_mesh),
            indent=1))
        log(f"chip_smoke: groups {sorted(groups)} done")
        return 0
    paths.update(serving)
    paths.update({f"{label} forward": rep for label, rep in forward.items()})
    paths["olmo-1b calibration"] = calibration
    paths["olmo-1b sim (adaptive CLI)"] = sim
    paths["olmo-1b train int8"] = training["int8"]
    paths.update({f"{label} train_tp": rep for label, rep in train_tp.items()
                  if label != "record"})

    def launches(name):
        by_path = {label: rep["launches"][name] for label, rep in paths.items()
                   if rep.get("launches", {}).get(name)}
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
        # kernel 1's split form at olmo-1b's down shard on a model axis of 2, decode
        rep_tp = next(r for r in tp_rows if (r.get("M"), r.get("K"), r.get("N"), r["fmt"]) ==
                      (SLOTS, 4096, 2048, "Q1.6") and "kernel" not in r)
        rep_epi = dict(ms=rep_tp["epilogue_ms"], plain_ms=rep_tp["epilogue_plain_ms"],
                       bound_ms=rep_tp["epilogue_bound_ms"], bound_by=rep_tp["epilogue_bound_by"])
        # kernel 6's at the same shard at M 512 (wgmma), where torch._int_mm
        # computes the same int32 product
        rep_mp = next(r for r in tp_rows if (r.get("kernel"), r["M"], r.get("K"), r["fmt"]) ==
                      ("cordic_mac_partial", BUCKET, 4096, "fxp8"))
        rep_me = dict(ms=rep_mp["epilogue_ms"], plain_ms=rep_mp["epilogue_plain_ms"],
                      bound_ms=rep_mp["epilogue_bound_ms"], bound_by=rep_mp["epilogue_bound_by"])
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
                 mla_flash_err, rep_mf, rep_mf["sdpa_ms"]),
                ("fused_dot_partial", "cordic_fused/csrc/cordic_fused.cu",
                 "cordic_fused/kernel.py:104", tp_err, rep_tp, rep_tp["int_mm_ms"]),
                ("fused_epilogue", "cordic_fused/csrc/cordic_fused.cu",
                 "cordic_fused/kernel.py:77", tp_err, rep_epi, None),
                ("cordic_mac_partial", "cordic_mac/csrc/cordic_mac.cu", "cordic_mac/kernel.py:36",
                 0.0, rep_mp, rep_mp["int_mm_ms"]),
                ("cordic_mac_epilogue", "cordic_mac/csrc/cordic_mac.cu",
                 "cordic_mac/kernel.py:53", 0.0, rep_me, None)):
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
        serving=serving, analysis=analysis, forward=forward, calibration=calibration,
        replay_order=order, card_vs_cpu=parity, sim=sim, train=training, tp=tp,
        train_tp=train_tp, dryrun_mesh=dryrun_mesh, kernels=kernels), indent=1))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
