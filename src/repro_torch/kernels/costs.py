"""The work of one call of each hand-written kernel, from its shapes, its path
and its activation: the HBM bytes it must move (each input read once, each
output written once) and its operations, keyed by the rate that bounds them.

One formula a kernel. The wrappers report it for every call they launch, or
would launch on a meta tensor (``kernels.kernel_call``), to the cost analyzer
(``launch/cost_analysis.py``); ``chip_smoke.py`` prints it as each kernel's
bound (``PERF.md`` §6). The attention formulas take the keys a call reads:
the dry run and the wrappers, which never read the positions, pass the
cache length (every query row scores every key); the smoke's rows pass what
their positions need.

The peaks are an H100 SXM's (NVIDIA data sheet, dense). The int32 rate is
64 int32 lanes an SM (half the 128 f32 lanes, no fused multiply-add) x 132
SMs at the 1.98 GHz that gives the f32 figure.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12
# the link term of the roofline: NVLink 4, 900 GB/s both ways, 450 GB/s each
NVLINK_BYTES_PER_S = 450e9
# operations/s by kind: int8 on the tensor cores, int32 on the CUDA cores,
# f32 FMA on the CUDA cores, TF32 and bf16 on the tensor cores
PEAKS = {
    "int8": 1.979e15,
    "int32": 64 * 132 * 1.98e9,
    "f32": 67e12,
    "tf32": 494.7e12,
    "bf16": 989e12,
}


@dataclasses.dataclass(frozen=True)
class Work:
    """``ops`` operations of one ``kind``, which a bound names ``label``."""
    kind: str
    ops: float
    label: str = "operations"


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One call's HBM bytes, its work terms (each bounded alone: a kernel
    runs its tensor-core and CUDA-core work side by side), ``dot_flops``
    (2 x its multiply-adds) and, for the attention kernels, the TF32
    products a multiply-add takes on the tensor cores."""
    hbm_bytes: float
    work: Tuple[Work, ...]
    dot_flops: float = 0.0
    tf32_passes: float = 0.0

    def ops_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for w in self.work:
            out[w.kind] = out.get(w.kind, 0.0) + w.ops
        return out

    def bound(self) -> Tuple[float, str]:
        """(least ms, what bounds it): the larger of the bytes over the HBM
        rate and each work term over its peak."""
        best = (self.hbm_bytes / HBM_BYTES_PER_S * 1e3, "bytes")
        for w in self.work:
            t = w.ops / PEAKS[w.kind] * 1e3
            if t > best[0]:
                best = (t, w.label)
        return best

    def bound_tf32_ms(self) -> float:
        """The least ms on the TF32 tensor cores at ``tf32_passes`` products
        a multiply-add: the larger of the bytes and the TF32 flops."""
        return max(self.hbm_bytes / HBM_BYTES_PER_S,
                   self.tf32_passes * self.dot_flops / PEAKS["tf32"]) * 1e3


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


def softmax_int_ops(depth: int) -> int:
    """int32 operations per element of the row softmax at internal depth
    ``depth``, counted as the function needs them (once per element, as
    :func:`af_int_ops` counts them): the quantize/requantize/dequantize
    chain, the CORDIC exp and divide loops, the shift, the two reductions'
    adds and compares."""
    return 12 + (6 * depth + 12) + 6 * depth + 8


def _int_dot_work(m: int, n: int, k: int, int16: bool) -> Work:
    """The multiply-adds of an integer dot: two operations each on the int8
    tensor cores; one int32 multiply-add instruction each on the CUDA cores
    for int16 operands, which no tensor core takes."""
    if int16:
        return Work("int32", 1.0 * m * n * k)
    return Work("int8", 2.0 * m * n * k)


def fused_dot_af(m: int, n: int, k: int, w_bytes: int, af: str, af_depth: int,
                 af_fmt) -> KernelCost:
    """Kernel 1: x f32 (M, K) by the (K, N) bank of ``w_bytes`` a weight,
    the int32[5] point, out f32 (M, N); past identity, the CORDIC epilogue's
    int32 operations on every output at the AF's internal depth."""
    from repro_torch.core.activations import internal_depth

    work = [_int_dot_work(m, n, k, w_bytes > 1)]
    if af != "identity":
        work.append(Work("int32", af_int_ops(af, internal_depth(af_depth, af_fmt)) * m * n,
                         "operations (AF int32)"))
    return KernelCost(m * k * 4 + k * n * w_bytes + m * n * 4 + 20, tuple(work),
                      dot_flops=2.0 * m * n * k)


def fused_dot_partial(m: int, n: int, k: int, w_bytes: int) -> KernelCost:
    """Kernel 1's partial-sum instantiation: x f32 (M, K) by the (K, N) bank
    of ``w_bytes`` a weight, the int32[5] point, out int32 (M, N)."""
    return KernelCost(m * k * 4 + k * n * w_bytes + m * n * 4 + 20,
                      (_int_dot_work(m, n, k, w_bytes > 1),), dot_flops=2.0 * m * n * k)


def fused_epilogue(m: int, n: int, af: str, af_depth: int, af_fmt) -> KernelCost:
    """Kernel 1's epilogue alone: int32 sums (M, N) in, f32 (M, N) out, the
    point; past identity, the CORDIC AF's int32 operations on every output."""
    from repro_torch.core.activations import internal_depth

    work = ()
    if af != "identity":
        work = (Work("int32", af_int_ops(af, internal_depth(af_depth, af_fmt)) * m * n,
                     "operations (AF int32)"),)
    return KernelCost(8.0 * m * n + 20, work)


def cordic_mac(m: int, n: int, k: int, elem: int) -> KernelCost:
    """Kernel 6: x_q (M, K) and the (K, N) bank of ``elem`` bytes, the f32
    scales (M + N), out f32 (M, N)."""
    return KernelCost(m * k * elem + k * n * elem + (m + n) * 4 + m * n * 4,
                      (_int_dot_work(m, n, k, elem > 1),), dot_flops=2.0 * m * n * k)


def af_elementwise(numel: int, mode: str, depth: int, fmt) -> KernelCost:
    """Kernel 4: f32 in and out, the AF's int32 operations on every element
    at the internal depth of the I/O-format ``depth``."""
    from repro_torch.core.activations import internal_depth

    ops = af_int_ops(mode, internal_depth(depth, fmt))
    return KernelCost(8.0 * numel, (Work("int32", float(ops) * numel),))


def af_softmax(numel: int, depth: int, fmt) -> KernelCost:
    """Kernel 5: f32 in and out, the softmax's int32 operations on every element."""
    from repro_torch.core.activations import internal_depth

    ops = softmax_int_ops(internal_depth(depth, fmt))
    return KernelCost(8.0 * numel, (Work("int32", float(ops) * numel),))


def gqa_decode_attention(b: int, s: int, h: int, t: int, kv: int, hd: int,
                         keys: Optional[Tuple[int, int]] = None) -> KernelCost:
    """Kernel 2: q and out (B, S, H, hd) f32, the int32 positions, and the
    K and V rows read; ``keys`` = (K/V rows read, summed over the batch
    rows; keys scored, summed over the query rows), by default every query
    row against all ``t`` cache rows. Two products (Q.K, P.V) of hd
    multiply-adds a (query, key, head)."""
    rows, scored = keys if keys is not None else (b * t, b * s * t)
    nbytes = rows * kv * hd * 4 * 2 + 2 * (b * s * h * hd) * 4 + b * s * 4
    flops = 4.0 * h * hd * scored
    return KernelCost(nbytes, (Work("f32", flops),), dot_flops=flops, tf32_passes=3.0)


def mla_decode_attention(b: int, s: int, h: int, t: int, r: int, rd: int,
                         keys: Optional[Tuple[int, int, int, int]] = None) -> KernelCost:
    """Kernel 3: q_lat, q_rope and the latent out, the positions, and the
    latent rows read; ``keys`` = (rows read for scores, rows read for the
    values, both summed over the batch rows; keys scored, keys averaged,
    both summed over the query rows: a masked row scores none and averages
    every c_kv row), by default every query against all ``t`` rows."""
    rows_qk, rows_v, scored, averaged = (keys if keys is not None
                                         else (b * t, b * t, b * s * t, b * s * t))
    nbytes = ((rows_qk * (r + rd) + (rows_v - rows_qk) * r + b * s * h * (r + rd + r)) * 4
              + b * s * 4)
    flops = 2.0 * h * (scored * (r + rd) + averaged * r)
    return KernelCost(nbytes, (Work("f32", flops),), dot_flops=flops, tf32_passes=3.0)


def causal_pairs(b: int, sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs a causal (or full) attention of one head scores."""
    if not causal:
        return b * sq * sk
    return b * sum(min(i + 1, sk) for i in range(sq))


def flash_attention(b: int, s: int, h: int, kv: int, d: int, elem: int,
                    causal: bool) -> KernelCost:
    """Kernel 7: q and out (B, S, H, D), k and v (B, S, KV, D) of ``elem``
    bytes; bf16 operands bound at the bf16 tensor-core rate, and on the TF32
    units one pass for Q.K^T (both bf16) and two for P.V (P f32, split)."""
    pairs = h * causal_pairs(b, s, s, causal)
    nbytes = (2 * b * s * h * d + 2 * b * s * kv * d) * elem
    flops = 4.0 * d * pairs
    bf16 = elem == 2
    return KernelCost(nbytes, (Work("bf16" if bf16 else "f32", flops),), dot_flops=flops,
                      tf32_passes=1.5 if bf16 else 3.0)


def mla_flash_attention(b: int, s: int, h: int, r: int, rd: int,
                        causal: bool = True) -> KernelCost:
    """Kernel 8: q_lat, q_rope, c_kv, k_rope and the latent out, f32."""
    pairs = h * causal_pairs(b, s, s, causal)
    nbytes = (b * s * h * r + b * s * h * rd + b * s * r + b * s * rd + b * s * h * r) * 4
    flops = 2.0 * pairs * (r + rd + r)
    return KernelCost(nbytes, (Work("f32", flops),), dot_flops=flops, tf32_passes=3.0)


def peak_seconds(ops_by_kind: Dict[str, float]) -> float:
    """Seconds the operations take at each kind's peak, summed over kinds."""
    return math.fsum(v / PEAKS[k] for k, v in ops_by_kind.items())
