// Absorbed-form MLA attention over the slot latent cache for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py:
// _mla_decode_kernel (pallas_call in mla_decode). For every batch row b,
// query row s and head h it computes, in f32:
//   scores_t = (q_lat . c_kv_t + q_rope . k_rope_t) * scale  for t <= pos[b, s]
//            = -1e30                                          otherwise
//   out      = softmax(scores) . c_kv                         (latent, R wide)
// P is not cast to the cache dtype (unlike the GQA kernel): the latent
// output stays f32, as in the reference.
//
// What bounds it on an H100: at full width (H = 128 heads, R = 512, r = 64)
// the multiply-adds, not the bytes: every head reads the same latent cache
// row (MLA is MQA-shaped in latent space), so the cache is small next to the
// H * (2R + r) multiply-adds per key. The Pallas grid is (b, h), so each head
// re-reads the whole cache. Here one block takes one query row and 32 of its
// heads as the rows of a tensor-core tile loop (include/mla_attention.cuh,
// shared with the cache-free MLA flash kernel: 3xTF32 mma.sync for Q K^T and
// P . c_kv, keys in 32-row tiles of [c_kv | k_rope] through shared memory),
// so every head of the block uses each tile and all rows share the query's
// position: tiles past it are skipped, which is exact.
//
// A decode step has too few (query, head block) blocks to fill the card
// (B = 4 slots: 16 blocks, one an SM at 224 KB of shared memory), so the host
// splits the keys of each block across `splits` blocks; each writes its
// running max, sum and unnormalised output to a workspace and a second
// kernel (attn::merge_splits, shared with the GQA kernel) merges them. A
// prefill bucket has blocks to spare and runs unsplit. Against the plain
// two-pass softmax the f32 reduction order differs, which costs a few ulps.
#include <cuda_runtime.h>
#include <math.h>

#include "mla_attention.cuh"

namespace {

__global__ void __launch_bounds__(mla::NT, 1)
mla_decode_tc_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
                     const float* __restrict__ c_kv, const float* __restrict__ k_rope,
                     const int* __restrict__ pos, float* __restrict__ out,
                     float* __restrict__ ws, int S, int H, int T, int R, int RD, int splits,
                     float scale) {
  // the last query rows first: in a prefill they see the most keys
  const int split = blockIdx.z % splits, b = blockIdx.z / splits, s = S - 1 - blockIdx.x;
  mla::rows(q_lat, q_rope, c_kv, k_rope, out, ws, b, s, blockIdx.y * mla::ROWS, split, S, H, T,
            R, RD, splits, pos[b * S + s], scale);
}

}  // namespace

// q_lat (B, S, H, R), q_rope (B, S, H, RD), c_kv (B, T, R), k_rope (B, T, RD),
// pos (B, S), out (B, S, H, R), contiguous; R and RD multiples of 4, R <= 512,
// R + RD <= 576, c_kv and k_rope 16-byte aligned (the wrapper checks); ws
// holds B*S*H*splits*(R + 4) floats when splits > 1: each split's R outputs,
// its max and its sum, padded to 16 bytes.
extern "C" int mla_decode_launch(const float* q_lat, const float* q_rope, const float* c_kv,
                                 const float* k_rope, const int* pos, float* out, float* ws,
                                 int B, int S, int H, int T, int R, int RD, int splits,
                                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || T <= 0 || R <= 0 || RD < 0 || R % 4 || RD % 4 ||
      R > 16 * mla::CW * mla::NP || mla::width(R, RD) > 32 * mla::KQ || splits < 1)
    return (int)cudaErrorInvalidValue;
  static bool opted = false;  // above 48 KB a launch must opt in, once, for the largest R + r
  if (!opted) {
    if (const int e = tile::opt_in(mla_decode_tc_kernel, mla::smem_bytes(512, 64))) return e;
    opted = true;
  }
  dim3 grid(S, (H + mla::ROWS - 1) / mla::ROWS, B * splits);
  mla_decode_tc_kernel<<<grid, mla::NT, mla::smem_bytes(R, RD), st>>>(
      q_lat, q_rope, c_kv, k_rope, pos, out, ws, S, H, T, R, RD, splits, scale);
  if (splits > 1) attn::merge_splits(ws, out, (long long)B * S * H, R, splits, st);
  return (int)cudaGetLastError();
}
