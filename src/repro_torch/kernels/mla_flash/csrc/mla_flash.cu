// Cache-free causal flash attention for Multi-head Latent Attention, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mla_flash/kernel.py:_mla_flash_kernel
// (pallas_call in mla_flash). For every batch row b, query row s and head h
// it computes, in f32:
//   scores_t = (q_lat . c_kv_t + q_rope . k_rope_t) * scale  for t <= s (causal)
//            = -1e30                                          for t > s (causal)
//   out      = softmax(scores) . c_kv                         (latent, R wide)
// over the sequence's own keys t < T; without the causal mask every key is
// visible. The model's scale is applied once, here; the Pallas wrapper
// folds it into q and divides by sqrt(R + r) inside the kernel, the same
// product.
//
// What bounds it on an H100: at deepseek-v3 width (H = 128, R = 512, r = 64)
// the multiply-adds: H * (2R + r) per visible (query, key) pair, against
// (R + r) floats of latent per key read once; ~36 GFLOP at S = 512 against
// 1.2 MB of latent. Every head attends over the same latent rows, so the
// Pallas kernel broadcasts one latent tile to a block of heads. Here one
// block takes one query row and 32 of its heads as the rows of the MLA
// cache kernel's tensor-core tile loop (include/mla_attention.cuh: 3xTF32
// mma.sync for Q K^T and P . c_kv), with the query index as its position:
// the keys stream in 32-row tiles of [c_kv | k_rope] through shared memory,
// and since c_kv is both the key's latent part and the value, one staged
// tile serves both products for all 32 heads. Tiles above the diagonal are
// skipped; that is exact, since every row of a block has the same query
// index. Queries run longest first (s = S - 1 down to 0), so the long causal
// rows do not trail the grid. One block of 8 warps an SM (224 KB of shared
// memory at full width).
#include <cuda_runtime.h>
#include <math.h>

#include "mla_attention.cuh"

namespace {

__global__ void __launch_bounds__(mla::NT, 1)
mla_flash_tc_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
                    const float* __restrict__ c_kv, const float* __restrict__ k_rope,
                    float* __restrict__ out, int S, int H, int T, int R, int RD, int causal,
                    float scale) {
  const int b = blockIdx.z, s = S - 1 - blockIdx.x;
  mla::rows(q_lat, q_rope, c_kv, k_rope, out, nullptr, b, s, blockIdx.y * mla::ROWS, 0, S, H, T,
            R, RD, 1, causal ? s : T - 1, scale);
}

}  // namespace

// q_lat (B, S, H, R), q_rope (B, S, H, RD), c_kv (B, T, R), k_rope (B, T, RD),
// out (B, S, H, R), all f32 and contiguous; R and RD multiples of 4, R <= 512,
// R + RD <= 576, c_kv and k_rope 16-byte aligned (the wrapper checks).
extern "C" int mla_flash_launch(const float* q_lat, const float* q_rope, const float* c_kv,
                                const float* k_rope, float* out, int B, int S, int H, int T,
                                int R, int RD, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || T <= 0 || R <= 0 || RD < 0 || R % 4 || RD % 4 ||
      R > 16 * mla::CW * mla::NP || mla::width(R, RD) > 32 * mla::KQ)
    return (int)cudaErrorInvalidValue;
  static bool opted = false;  // above 48 KB a launch must opt in, once, for the largest R + r
  if (!opted) {
    if (const int e = tile::opt_in(mla_flash_tc_kernel, mla::smem_bytes(512, 64))) return e;
    opted = true;
  }
  dim3 grid(S, (H + mla::ROWS - 1) / mla::ROWS, B);
  mla_flash_tc_kernel<<<grid, mla::NT, mla::smem_bytes(R, RD), st>>>(
      q_lat, q_rope, c_kv, k_rope, out, S, H, T, R, RD, causal, scale);
  return (int)cudaGetLastError();
}
