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
// last block of each output tile runs the epilogue. That integer main loop is
// kernels/include/int_dot.cuh, shared with the cordic_mac kernel. Tensor
// cores (mma/wgmma on int8) and TMA pipelines are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cordic_af.cuh"
#include "int_dot.cuh"

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

// quantize x onto the FxP grid on its way into the tile
struct QuantizeX {
  const float* __restrict__ x;
  int K, qmin, qmax;
  float scale;
  __device__ __forceinline__ int operator()(int gm, int gk) const {
    return clampi(__float2int_rn(x[(size_t)gm * K + gk] * scale), qmin, qmax);
  }
};

// One block computes a BM x BN output tile over the K range of its split
// (blockIdx.y); the last block of the tile runs the epilogue.
template <typename WT, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
fused_dot_af_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                    const int* __restrict__ point, const int* __restrict__ af_tab,
                    float* __restrict__ out, unsigned* __restrict__ ws,
                    int* __restrict__ tile_count, int M, int N, int K, int k_per_split,
                    int mode, int compute_round, int vec) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  __shared__ int tab[AF_TAB_LEN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * BM;

  for (int i = tid; i < AF_TAB_LEN; i += NT) tab[i] = af_tab[i];
  const int x_frac = point[P_XFRAC], w_frac = point[P_WFRAC];
  const QuantizeX xload{x, K, point[P_XQMIN], point[P_XQMAX], pow2f(x_frac)};
  __syncthreads();

  unsigned acc[TM][TN];
  if (!int_dot_tile<WT, BM, BN, BK, TM, TN>(acc, xload, w, ws, tile_count, M, N, K,
                                             k_per_split, vec))
    return;

  const float x_descale = pow2f(-x_frac), w_descale = pow2f(-w_frac);
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

template <typename WT>
struct FusedLaunch {
  template <int BM, int BN, int BK, int TM, int TN>
  struct Tile {
    static void launch(dim3 grid, dim3 block, cudaStream_t stream, const float* x, const void* w,
                       const int* point, const int* af_tab, float* out, unsigned* ws,
                       int* tile_count, int M, int N, int K, int k_per_split, int mode,
                       int compute_round, int vec) {
      fused_dot_af_kernel<WT, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
          x, static_cast<const WT*>(w), point, af_tab, out, ws, tile_count, M, N, K,
          k_per_split, mode, compute_round, vec);
    }
  };
};

}  // namespace

extern "C" int cordic_fused_launch(const float* x, const void* w, int w_bytes, const int* point,
                                   const int* af_tab, float* out, unsigned* ws, int* tile_count,
                                   int M, int N, int K, int config, int splits, int k_per_split,
                                   int mode, int compute_round, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bytes == 1) {
    dispatch_tiles<FusedLaunch<int8_t>::Tile>(config, M, N, splits, s, x, w, point,
                                                       af_tab, out, ws, tile_count, M, N, K,
                                                       k_per_split, mode, compute_round, vec);
  } else if (w_bytes == 2) {
    dispatch_tiles<FusedLaunch<int16_t>::Tile>(config, M, N, splits, s, x, w, point,
                                                        af_tab, out, ws, tile_count, M, N, K,
                                                        k_per_split, mode, compute_round, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
