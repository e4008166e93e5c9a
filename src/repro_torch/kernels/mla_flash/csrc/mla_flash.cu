// Cache-free causal flash attention for Multi-head Latent Attention, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mla_flash/kernel.py:_mla_flash_kernel
// (pallas_call in mla_flash). For every batch row b, query row s and head h
// it computes, in f32:
//   scores_t = (q_lat . c_kv_t + q_rope . k_rope_t) * scale  for t <= s
//            = -1e30                                          for t > s
//   out      = softmax(scores) . c_kv                         (latent, R wide)
// over the sequence's own keys t < T (non-causal: every key visible). The
// model's scale is applied once, here; the Pallas wrapper folds it into q
// and divides by sqrt(R + r) inside the kernel, the same product.
//
// What bounds it on an H100: at deepseek-v3 width (H = 128, R = 512, r = 64)
// the f32 multiply-adds: H * (2R + r) per visible (query, key) pair, against
// (R + r) floats of latent per key read once; ~36 GFLOP at S = 512 against
// 1.2 MB of latent. Every head attends over the same latent rows, so the
// Pallas kernel broadcasts one latent tile to a block of heads. Here one
// block takes one query row and a group of 32 heads and streams the keys in
// 32-row tiles of [c_kv | k_rope] through shared memory (cp.async, double
// buffered), so each tile serves 32 (query, head) rows for the score and,
// since c_kv is both the key's latent part and the value, for P . c_kv too:
// one load per tile for both. The loop is the MLA cache-decode kernel's
// (include/mla_attention.cuh) with the query index as its position.
//
// Blocks: a block's reuse of a tile is its row count (queries x heads).
// Shared memory caps it: two tiles of 32 x 580 floats and 32 query rows of
// 576 floats are 222 KB at full width, one block of 8 warps per SM, so more
// queries per block would mean fewer heads per block, not more reuse. The
// accumulator is 32 rows x 512 f32 = 64 registers a thread (4 heads x 4
// float4 columns), no spill. Tiles above the diagonal are skipped; that is
// exact: tile 0 holds key 0 <= s, so the running max is finite after it and
// a fully masked tile would add exp(-1e30 - m) = 0 with alpha = 1. Queries
// run longest first (s = S - 1 down to 0), so the long causal rows do not
// trail the grid. Tensor cores and TMA are later work.
#include <cuda_runtime.h>
#include <math.h>

#include "mla_attention.cuh"

namespace {

template <int NV>
__global__ void __launch_bounds__(mla::NT)
mla_flash_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
                 const float* __restrict__ c_kv, const float* __restrict__ k_rope,
                 float* __restrict__ out, int S, int H, int T, int R, int RD, int causal,
                 float scale) {
  const int b = blockIdx.z, s = S - 1 - blockIdx.x;
  mla::rows<NV>(q_lat, q_rope, c_kv, k_rope, out, nullptr, b, s, blockIdx.y * mla::HG, 0, S, H,
                T, R, RD, 1, causal ? s : T - 1, scale);
}

template <int NV>
int launch(const float* q_lat, const float* q_rope, const float* c_kv, const float* k_rope,
           float* out, int B, int S, int H, int T, int R, int RD, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = mla::smem_bytes(R, RD);
  static size_t smem_set = 48 * 1024;  // what a launch may use without opting in
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_flash_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid(S, (H + mla::HG - 1) / mla::HG, B);
  mla_flash_kernel<NV><<<grid, mla::NT, smem, stream>>>(q_lat, q_rope, c_kv, k_rope, out, S, H,
                                                        T, R, RD, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_lat (B, S, H, R), q_rope (B, S, H, RD), c_kv (B, T, R), k_rope (B, T, RD),
// out (B, S, H, R), all f32 and contiguous; R and RD multiples of 4 and c_kv,
// k_rope 16-byte aligned (the wrapper checks).
extern "C" int mla_flash_launch(const float* q_lat, const float* q_rope, const float* c_kv,
                                const float* k_rope, float* out, int B, int S, int H, int T,
                                int R, int RD, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || RD < 0 || R % 4 || RD % 4 || S <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  if (R <= 128)
    return launch<1>(q_lat, q_rope, c_kv, k_rope, out, B, S, H, T, R, RD, causal, scale, st);
  if (R <= 256)
    return launch<2>(q_lat, q_rope, c_kv, k_rope, out, B, S, H, T, R, RD, causal, scale, st);
  if (R <= 512)
    return launch<4>(q_lat, q_rope, c_kv, k_rope, out, B, S, H, T, R, RD, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
