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

#include "cordic_af.cuh"

namespace {

// params-vector indices (make_point)
constexpr int P_XFRAC = 1, P_XQMIN = 2, P_XQMAX = 3, P_WFRAC = 4;

// cordic_fused.kernel.af_epilogue for one f32 dot output. Not inlined: the
// output-tile loops call it once per accumulator.
__device__ __noinline__ float af_epilogue(float h, int mode, int compute_round, const int* tab) {
  if (mode == 0) return h;
  if (compute_round) h = __bfloat162float(__float2bfloat16_rn(h));
  return af_chain(h, mode, tab);
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
