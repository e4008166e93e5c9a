// Fused prepared CORDIC dot + activation epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cordic_fused/kernel.py:fused_kernel
// (pallas_call built in repro/kernels/cordic_fused/ops.py:_grid_call, entry
// fused_dot_af). Per output element it computes, bit for bit:
//   1. quantize x onto the FxP grid: round half to even, clip to [qmin, qmax]
//      from the params vector (NaN -> 0, as JAX's saturating cast);
//   2. read the prepared signed-digit weight integers (int8 at FxP8, int16 at
//      FxP16; the TPU kernel recovered them from an f32 grid);
//   3. exact int32 dot, accumulated in uint32 so that overflow wraps like
//      XLA's int32 dot_general (integer sums are order independent, so
//      tiling K and splitting it across blocks changes no bit);
//   4. descale (acc * 2^-x_frac) * 2^-w_frac with exact powers of two;
//   5. optional bf16 round;
//   6. the CORDIC activation picked at run time by `mode` (an index into
//      FUSED_AFS), on the guard-bit internal format, as core/activations.py
//      computes it.
//
// The execution point (depth, x_frac, qmin, qmax, w_frac) is read at run time
// from the device vector `point`, so a new point reuses the same launch and
// rebuilds nothing. The AF mode is a plain launch argument, not params[5] of
// a device vector as on the TPU: there af_mode is a static argument of the
// jitted wrapper and rides the params vector only so that one compiled Pallas
// kernel serves every mode, which a CUDA launch argument gives for free. The
// mode belongs to the call site (gate -> swish, the rest identity), never to
// the execution point, so a captured CUDA graph may freeze it; the point must
// stay a device vector that a graph reads on replay.
//
// What bounds it on an H100: at decode (M = slots <= 8) the bytes of the
// int8 weights (one full olmo-1b step streams ~1.18 GB, >= 0.35 ms at
// 3.35 TB/s); at a prefill bucket the integer multiply-adds. Design: an
// output-tile kernel with a K loop over shared-memory tiles and int32
// multiply-adds on the CUDA cores. When there are few output tiles it splits
// K across blocks so that enough blocks stream the weights; partial sums meet
// in a uint32 workspace through atomicAdd (wrapping, order free), and the
// last block of each output tile runs the epilogue. Tensor cores (mma/wgmma on int8) and
// TMA pipelines are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// layout of the int32 AF table (built by ops.py from core/cordic.py)
constexpr int T_DEPTH = 0;
constexpr int T_IO_FRAC = 1, T_IO_QMIN = 2, T_IO_QMAX = 3;
constexpr int T_IN_FRAC = 4, T_IN_QMIN = 5, T_IN_QMAX = 6;
constexpr int T_INV_GAIN = 7, T_ZMAX = 8, T_LN2 = 9;
constexpr int T_C_CUBIC = 10, T_C_GELU = 11, T_C_HALF = 12, T_C_LAMBDA = 13, T_C_ALPHA = 14;
constexpr int T_SHIFT = 16, T_ATANH = 48;
constexpr int AF_TAB_LEN = 80;

// params-vector indices (make_point)
constexpr int P_XFRAC = 1, P_XQMIN = 2, P_XQMAX = 3, P_WFRAC = 4;

__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int wmul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
__device__ __forceinline__ int wneg(int a) { return (int)(0u - (unsigned)a); }
__device__ __forceinline__ int shl(int a, int s) { return (int)((unsigned)a << s); }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// floor division for b > 0 (C++ '/' truncates toward zero)
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

// exact 2^e as a float for e in [-126, 127]
__device__ __forceinline__ float pow2f(int e) { return __int_as_float((127 + e) << 23); }

// fxp.quantize: f32 * 2^frac, round half to even, saturating cast (NaN -> 0), clip
__device__ __forceinline__ int quantize(float v, int frac, int qmin, int qmax) {
  return clampi(__float2int_rn(v * pow2f(frac)), qmin, qmax);
}

// fxp.requantize
__device__ __forceinline__ int requantize(int raw, int src, int dst, int qmin, int qmax) {
  int out;
  if (dst >= src) {
    out = shl(raw, dst - src);
  } else {
    int sh = src - dst;
    out = wadd(raw, 1 << (sh - 1)) >> sh;
  }
  return clampi(out, qmin, qmax);
}

// linear rotation: y = x * value(z), z in Q1 with `one` = 2^frac
__device__ int cordic_mul(int x, int z, int depth, int one) {
  int y = 0;
  for (int k = 0; k < depth; ++k) {
    const int xs = x >> k, zs = one >> k;
    if (z >= 0) { y = wadd(y, xs); z = wsub(z, zs); }
    else        { y = wsub(y, xs); z = wadd(z, zs); }
  }
  return y;
}

// linear vectoring: z = num / den
__device__ int cordic_div(int num, int den, int depth, int one) {
  int y = num, z = 0;
  for (int k = 0; k < depth; ++k) {
    const int xs = den >> k, zs = one >> k;
    if ((y >= 0) == (den >= 0)) { y = wsub(y, xs); z = wadd(z, zs); }
    else                        { y = wadd(y, xs); z = wsub(z, zs); }
  }
  return z;
}

// hyperbolic rotation from 1/A_h: returns cosh(z) + sinh(z)
__device__ int hyperbolic_exp_core(int z, const int* tab) {
  const int depth = tab[T_DEPTH], zmax = tab[T_ZMAX];
  z = clampi(z, -zmax, zmax);
  int x = tab[T_INV_GAIN], y = 0;
  for (int i = 0; i < depth; ++i) {
    const int k = tab[T_SHIFT + i], a = tab[T_ATANH + i];
    const int xs = y >> k, ys = x >> k;
    if (z >= 0) { x = wadd(x, xs); y = wadd(y, ys); z = wsub(z, a); }
    else        { x = wsub(x, xs); y = wsub(y, ys); z = wadd(z, a); }
  }
  return wadd(x, y);
}

// cordic.cordic_exp on the internal format
__device__ int cordic_exp(int x, const int* tab) {
  const int ln2 = tab[T_LN2];
  int q = floordiv(wadd(shl(x, 1), ln2), 2 * ln2);
  const int r = wsub(x, wmul(q, ln2));
  int e = hyperbolic_exp_core(r, tab);
  q = clampi(q, -31, 29 - tab[T_IN_FRAC]);
  return q >= 0 ? shl(e, q) : (e >> (-q));
}

__device__ __forceinline__ int exp_neg(int x, const int* tab) { return cordic_exp(min(x, 0), tab); }
__device__ __forceinline__ int iabs(int x) { return x < 0 ? wneg(x) : x; }

__device__ int tanh_raw(int x, const int* tab) {
  const int depth = tab[T_DEPTH], one = 1 << tab[T_IN_FRAC];
  const int t = exp_neg(wneg(shl(iabs(x), 1)), tab);
  const int mag = cordic_div(wsub(one, t), wadd(one, t), depth, one);
  return x >= 0 ? mag : wneg(mag);
}

__device__ int sigmoid_raw(int x, const int* tab) {
  const int depth = tab[T_DEPTH], one = 1 << tab[T_IN_FRAC];
  const int t = exp_neg(wneg(iabs(x)), tab);
  return cordic_div(x >= 0 ? one : t, wadd(one, t), depth, one);
}

__device__ __forceinline__ int mul_raw(int a, int b, const int* tab) {
  const int frac = tab[T_IN_FRAC];
  const int lim = (1 << (frac + 1)) - 1;
  return cordic_mul(a, clampi(b, -lim, lim), tab[T_DEPTH], 1 << frac);
}

__device__ __forceinline__ int sat(int v, const int* tab) {
  return clampi(v, tab[T_IN_QMIN], tab[T_IN_QMAX]);
}

// core/activations.multi_af; mode indexes FUSED_AFS = (identity, relu, gelu,
// tanh, sigmoid, swish, selu)
__device__ int multi_af(int x, int mode, const int* tab) {
  const int one = 1 << tab[T_IN_FRAC];
  switch (mode) {
    case 1:  // relu
      return max(x, 0);
    case 2: {  // gelu, tanh form
      const int x2 = mul_raw(x, x, tab);
      const int x2c = mul_raw(x2, tab[T_C_CUBIC], tab);
      const int x3c = mul_raw(x, x2c, tab);
      const int arg = mul_raw(wadd(x, x3c), tab[T_C_GELU], tab);
      const int t = tanh_raw(arg, tab);
      const int out = mul_raw(x, wadd(one, t), tab);
      return sat(mul_raw(out, tab[T_C_HALF], tab), tab);
    }
    case 3:  // tanh
      return sat(tanh_raw(x, tab), tab);
    case 4:  // sigmoid
      return sat(sigmoid_raw(x, tab), tab);
    case 5:  // swish
      return sat(mul_raw(x, sigmoid_raw(x, tab), tab), tab);
    case 6: {  // selu
      const int e = exp_neg(x, tab);
      const int neg = mul_raw(wsub(e, one), tab[T_C_ALPHA], tab);
      return sat(mul_raw(x > 0 ? x : neg, tab[T_C_LAMBDA], tab), tab);
    }
    default:
      return x;
  }
}

// cordic_fused.kernel.af_epilogue for one f32 dot output. Not inlined: the
// output-tile loops call it once per accumulator.
__device__ __noinline__ float af_epilogue(float h, int mode, int compute_round, const int* tab) {
  if (mode == 0) return h;
  if (compute_round) h = __bfloat162float(__float2bfloat16_rn(h));
  const int io_frac = tab[T_IO_FRAC], in_frac = tab[T_IN_FRAC];
  const int xq = quantize(h, io_frac, tab[T_IO_QMIN], tab[T_IO_QMAX]);
  const int xi = requantize(xq, io_frac, in_frac, tab[T_IN_QMIN], tab[T_IN_QMAX]);
  const int raw = multi_af(xi, mode, tab);
  const int o = requantize(raw, in_frac, io_frac, tab[T_IO_QMIN], tab[T_IO_QMAX]);
  return __int2float_rn(o) * pow2f(-io_frac);
}

template <typename WT> struct Vec16;
template <> struct Vec16<int8_t> { static constexpr int N = 16; };
template <> struct Vec16<int16_t> { static constexpr int N = 8; };

// One block computes a BM x BN output tile over the K range of its split
// (blockIdx.y). Thread (tx, ty) owns rows ty + i*TY and columns tx + j*TX.
template <typename WT, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
fused_dot_af_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                    const int* __restrict__ point, const int* __restrict__ af_tab,
                    float* __restrict__ out, unsigned* __restrict__ ws,
                    int* __restrict__ tile_count, int M, int N, int K, int k_per_split,
                    int mode, int compute_round, int vec) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  constexpr int VEC = Vec16<WT>::N;
  __shared__ int xs[BK][BM + 1];
  __shared__ __align__(16) int wsm[BK][BN];
  __shared__ int tab[AF_TAB_LEN];
  __shared__ int last_block;

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * BM;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  for (int i = tid; i < AF_TAB_LEN; i += NT) tab[i] = af_tab[i];
  const int x_frac = point[P_XFRAC], qmin = point[P_XQMIN], qmax = point[P_XQMAX];
  const int w_frac = point[P_WFRAC];
  const float x_scale = pow2f(x_frac);
  __syncthreads();

  unsigned acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // x tile (BM x BK), quantized on the way into shared memory
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      int q = 0;
      if (gm < M && gk < k_end) {
        const float v = x[(size_t)gm * K + gk] * x_scale;
        q = clampi(__float2int_rn(v), qmin, qmax);
      }
      xs[c][r] = q;
    }
    // weight tile (BK x BN): 16-byte loads where the row allows it
    if (vec) {
      for (int i = tid; i < BK * (BN / VEC); i += NT) {
        const int r = i / (BN / VEC), c = (i % (BN / VEC)) * VEC;
        const int gk = k0 + r, gn = n0 + c;
        int4 raw = make_int4(0, 0, 0, 0);
        if (gk < k_end && gn < N) raw = *reinterpret_cast<const int4*>(w + (size_t)gk * N + gn);
        const unsigned words[4] = {(unsigned)raw.x, (unsigned)raw.y, (unsigned)raw.z,
                                   (unsigned)raw.w};
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if constexpr (sizeof(WT) == 1) {
            wsm[r][c + e] = (int)(signed char)(words[e / 4] >> (8 * (e % 4)));
          } else {
            wsm[r][c + e] = (int)(short)(words[e / 2] >> (16 * (e % 2)));
          }
        }
      }
    } else {
      for (int i = tid; i < BK * BN; i += NT) {
        const int r = i / BN, c = i % BN;
        const int gk = k0 + r, gn = n0 + c;
        wsm[r][c] = (gk < k_end && gn < N) ? (int)w[(size_t)gk * N + gn] : 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      unsigned a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = (unsigned)xs[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = (unsigned)wsm[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  const float x_descale = pow2f(-x_frac), w_descale = pow2f(-w_frac);
  if (gridDim.y > 1) {
    // split K: add this block's partial sums, then the last block of the
    // output tile reads the totals and runs the epilogue
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gm = m0 + ty + i * TY, gn = n0 + tx + j * TX;
        if (gm < M && gn < N) atomicAdd(ws + (size_t)gm * N + gn, acc[i][j]);
      }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile = blockIdx.z * gridDim.x + blockIdx.x;
      last_block = (atomicAdd(tile_count + tile, 1) == (int)gridDim.y - 1);
    }
    __syncthreads();
    if (!last_block) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gm = m0 + ty + i * TY, gn = n0 + tx + j * TX;
        if (gm < M && gn < N) acc[i][j] = __ldcg(ws + (size_t)gm * N + gn);
      }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + ty + i * TY, gn = n0 + tx + j * TX;
      if (gm < M && gn < N) {
        const float h = (__int2float_rn((int)acc[i][j]) * x_descale) * w_descale;
        out[(size_t)gm * N + gn] = af_epilogue(h, mode, compute_round, tab);
      }
    }
}

template <typename WT, int BM, int BN, int BK, int TM, int TN>
void launch(const float* x, const void* w, const int* point, const int* af_tab, float* out,
            unsigned* ws, int* tile_count, int M, int N, int K, int splits, int k_per_split,
            int mode, int compute_round, int vec, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, splits, (M + BM - 1) / BM);
  dim3 block((BM / TM) * (BN / TN));
  fused_dot_af_kernel<WT, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      x, static_cast<const WT*>(w), point, af_tab, out, ws, tile_count, M, N, K, k_per_split,
      mode, compute_round, vec);
}

template <typename WT>
void dispatch(int config, const float* x, const void* w, const int* point, const int* af_tab,
              float* out, unsigned* ws, int* tile_count, int M, int N, int K, int splits,
              int k_per_split, int mode, int compute_round, int vec, cudaStream_t stream) {
  switch (config) {
    case 0:  // decode: M <= 8
      launch<WT, 8, 128, 32, 1, 4>(x, w, point, af_tab, out, ws, tile_count, M, N, K, splits,
                                   k_per_split, mode, compute_round, vec, stream);
      break;
    case 1:  // small blocks: M <= 32
      launch<WT, 32, 128, 32, 4, 4>(x, w, point, af_tab, out, ws, tile_count, M, N, K, splits,
                                    k_per_split, mode, compute_round, vec, stream);
      break;
    default:  // prefill buckets
      launch<WT, 128, 128, 16, 8, 8>(x, w, point, af_tab, out, ws, tile_count, M, N, K, splits,
                                     k_per_split, mode, compute_round, vec, stream);
      break;
  }
}

}  // namespace

extern "C" int cordic_fused_launch(const float* x, const void* w, int w_bytes, const int* point,
                                   const int* af_tab, float* out, unsigned* ws, int* tile_count,
                                   int M, int N, int K, int config, int splits, int k_per_split,
                                   int mode, int compute_round, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bytes == 1) {
    dispatch<int8_t>(config, x, w, point, af_tab, out, ws, tile_count, M, N, K, splits,
                     k_per_split, mode, compute_round, vec, s);
  } else if (w_bytes == 2) {
    dispatch<int16_t>(config, x, w, point, af_tab, out, ws, tile_count, M, N, K, splits,
                      k_per_split, mode, compute_round, vec, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
