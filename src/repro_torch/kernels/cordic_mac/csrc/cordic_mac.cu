// CARMEN's MAC array as a blocked integer matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cordic_mac/kernel.py:_mac_kernel
// (pallas_call in mac_matmul, reached through ops.cordic_mac by the per-call
// kernel-backend dot). Per output element it computes, bit for bit as
// kernels/cordic_mac/ref.py:mac_matmul_ref:
//   1. acc = sum_k x_q[m, k] * w_q[k, n], int8 or int16 operands, the int32
//      accumulator wrapping modulo 2^32 like XLA's int32 dot_general (FxP16
//      can overflow at K = 8192);
//   2. out = (float(acc) * x_scale[m]) * w_scale[n], two f32 multiplies in
//      that order;
//   3. out = max(out, 0) when fuse_relu is set (the multi-AF block's ReLU
//      bypass), NaN kept as jnp.maximum keeps it.
//
// What bounds it on an H100: at decode (M = slots = 4) the int8 weight bytes
// (a 2048 x 8192 bank is 16.8 MB, >= 5 us at 3.35 TB/s); at a prefill bucket
// (M = 512) the integer multiply-adds. Design: the split-K output-tile loop of
// kernels/include/int_dot.cuh on the CUDA cores, the one the fused dot+AF
// kernel runs; x arrives already quantized, and the epilogue is the scale
// multiply. The kernel masks the ragged edges itself, so nothing is padded
// to the TPU's 256-tiles. Tensor cores (mma/wgmma on int8) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_dot.cuh"

namespace {

// the quantized activation operand, read straight into the tile
template <typename XT>
struct LoadX {
  const XT* __restrict__ x;
  int K;
  __device__ __forceinline__ int operator()(int gm, int gk) const {
    return (int)x[(size_t)gm * K + gk];
  }
};

template <typename XT, typename WT, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
mac_matmul_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                  const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                  float* __restrict__ out, unsigned* __restrict__ ws,
                  int* __restrict__ tile_count, int M, int N, int K, int k_per_split,
                  int fuse_relu, int vec) {
  constexpr int TX = BN / TN, TY = BM / TM;
  unsigned acc[TM][TN];
  if (!int_dot_tile<WT, BM, BN, BK, TM, TN>(acc, LoadX<XT>{x, K}, w, ws, tile_count, M, N, K,
                                             k_per_split, vec))
    return;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * BM;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
    const float xs = x_scale[gm];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) {
        float v = (__int2float_rn((int)acc[i][j]) * xs) * w_scale[gn];
        if (fuse_relu && v < 0.f) v = 0.f;
        out[(size_t)gm * N + gn] = v;
      }
    }
  }
}

template <typename XT, typename WT>
struct MacLaunch {
  template <int BM, int BN, int BK, int TM, int TN>
  struct Tile {
    static void launch(dim3 grid, dim3 block, cudaStream_t stream, const void* x, const void* w,
                       const float* x_scale, const float* w_scale, float* out, unsigned* ws,
                       int* tile_count, int M, int N, int K, int k_per_split, int fuse_relu,
                       int vec) {
      mac_matmul_kernel<XT, WT, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
          static_cast<const XT*>(x), static_cast<const WT*>(w), x_scale, w_scale, out, ws,
          tile_count, M, N, K, k_per_split, fuse_relu, vec);
    }
  };
};

template <typename XT>
int dispatch_w(int w_bytes, int config, int splits, cudaStream_t s, const void* x, const void* w,
               const float* x_scale, const float* w_scale, float* out, unsigned* ws,
               int* tile_count, int M, int N, int K, int k_per_split, int fuse_relu, int vec) {
  if (w_bytes == 1) {
    dispatch_tiles<MacLaunch<XT, int8_t>::template Tile>(config, M, N, splits, s, x, w, x_scale,
                                                         w_scale, out, ws, tile_count, M, N, K,
                                                         k_per_split, fuse_relu, vec);
  } else if (w_bytes == 2) {
    dispatch_tiles<MacLaunch<XT, int16_t>::template Tile>(config, M, N, splits, s, x, w,
                                                          x_scale, w_scale, out, ws, tile_count,
                                                          M, N, K, k_per_split, fuse_relu, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K) int8/int16 (x_bytes 1/2), w: (K, N) int8/int16 (w_bytes 1/2),
// x_scale: (M,) f32, w_scale: (N,) f32, out: (M, N) f32. ws and tile_count
// are the zeroed split-K scratch (null when splits == 1).
extern "C" int cordic_mac_launch(const void* x, int x_bytes, const void* w, int w_bytes,
                                 const float* x_scale, const float* w_scale, float* out,
                                 unsigned* ws, int* tile_count, int M, int N, int K, int config,
                                 int splits, int k_per_split, int fuse_relu, int vec,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bytes == 1)
    return dispatch_w<int8_t>(w_bytes, config, splits, s, x, w, x_scale, w_scale, out, ws,
                              tile_count, M, N, K, k_per_split, fuse_relu, vec);
  if (x_bytes == 2)
    return dispatch_w<int16_t>(w_bytes, config, splits, s, x, w, x_scale, w_scale, out, ws,
                               tile_count, M, N, K, k_per_split, fuse_relu, vec);
  return (int)cudaErrorInvalidValue;
}
