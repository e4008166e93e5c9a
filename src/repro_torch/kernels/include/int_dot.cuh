// The integer main loop shared by the fused dot+AF kernel
// (cordic_fused/csrc/cordic_fused.cu) and the MAC-array matmul
// (cordic_mac/csrc/cordic_mac.cu): one block's BM x BN tile of the exact
// int32 product x_int . w over its split of K, on the CUDA cores.
//
// Sums accumulate in uint32, so overflow wraps modulo 2^32 like XLA's int32
// dot_general. Integer sums are order independent: tiling K and splitting it
// across blocks changes no bit. When the grid splits K (gridDim.y > 1) the
// blocks of an output tile add their partial sums into a zeroed uint32
// workspace with atomicAdd (wrapping, order free); the last block to arrive
// reads the totals back and alone returns true, to run the caller's epilogue.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Vec16;  // elements of T in one 16-byte load
template <> struct Vec16<int8_t> { static constexpr int N = 16; };
template <> struct Vec16<int16_t> { static constexpr int N = 8; };

// Thread (tx, ty) of the tile owns rows ty + i*TY and columns tx + j*TX,
// with TX = BN / TN and TY = BM / TM. `xload(gm, gk)` returns the integer x
// operand of an in-range element; `vec` says that every weight row allows
// 16-byte loads (N a multiple of the vector and w 16-byte aligned).
template <typename WT, int BM, int BN, int BK, int TM, int TN, typename XLoad>
__device__ __forceinline__ bool int_dot_tile(unsigned (&acc)[TM][TN], const XLoad& xload,
                                             const WT* __restrict__ w,
                                             unsigned* __restrict__ ws,
                                             int* __restrict__ tile_count, int M, int N,
                                             int K, int k_per_split, int vec) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  constexpr int VEC = Vec16<WT>::N;
  __shared__ int xs[BK][BM + 1];
  __shared__ __align__(16) int wsm[BK][BN];
  __shared__ int last_block;

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * BM;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // x tile (BM x BK), stored transposed
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < k_end) ? xload(gm, gk) : 0;
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

  if (gridDim.y == 1) return true;
  // split K: add this block's partial sums; the last block of the output
  // tile reads the totals
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
  if (!last_block) return false;
  __threadfence();
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + ty + i * TY, gn = n0 + tx + j * TX;
      if (gm < M && gn < N) acc[i][j] = __ldcg(ws + (size_t)gm * N + gn);
    }
  return true;
}

// The three tile configurations (BM, BN, BK, TM, TN), picked by the host's
// plan (kernels/int_dot.py) from M, and the launch that instantiates them.
// `Kernel` is a functor template: Kernel<BM, BN, BK, TM, TN>::launch(grid,
// block, args...) launches the caller's __global__ instantiation.
template <template <int, int, int, int, int> class Kernel, typename... Args>
void dispatch_tiles(int config, int M, int N, int splits, cudaStream_t stream, Args... args) {
  switch (config) {
    case 0:  // decode: M <= 8
      Kernel<8, 128, 32, 1, 4>::launch(dim3((N + 127) / 128, splits, (M + 7) / 8), dim3(256),
                                       stream, args...);
      break;
    case 1:  // small blocks: M <= 32
      Kernel<32, 128, 32, 4, 4>::launch(dim3((N + 127) / 128, splits, (M + 31) / 32),
                                        dim3(256), stream, args...);
      break;
    default:  // prefill buckets
      Kernel<128, 128, 16, 8, 8>::launch(dim3((N + 127) / 128, splits, (M + 127) / 128),
                                         dim3(256), stream, args...);
      break;
  }
}

}  // namespace
