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
// the f32 multiply-adds, not the bytes: every head reads the same latent
// cache row (MLA is MQA-shaped in latent space), so the cache is small next
// to the H * (2R + r) operations per key. The Pallas grid is (b, h), so each
// head re-reads the whole cache. Here (the loop is include/mla_attention.cuh,
// shared with the cache-free MLA flash kernel) one block takes one query row and a
// group of HG heads and streams the keys in tiles of TK rows of
// [c_kv | k_rope] through shared memory, double-buffered with cp.async, so
// that every head of the group uses each tile. Each warp owns RPW heads: a
// lane scores one key of the tile for all of them (each 16-byte read of the
// key serves RPW heads), then the warp walks the tile's keys for P . c_kv
// with the online softmax (running max and sum, rescaled per tile), lane l
// owning output dims 4l..4l+3 (+128 per step). Tiles past the query's
// position are skipped: their weight is exactly 0.
//
// At full width a block holds 222 KB of shared memory (two 32-key tiles of
// 576 floats and 32 query rows), one block of 8 warps per SM. A decode step
// has too few (query, head group) blocks to fill the card (B = 4 slots: 16),
// so the host splits the keys of each block across `splits` blocks; each
// writes its running max, sum and unnormalised output to a workspace and a
// second kernel (attn::merge_splits, shared with the GQA kernel) merges
// them. A prefill bucket has blocks to spare and runs unsplit. Against the
// plain two-pass softmax the f32 reduction order differs, which costs a few
// ulps. Tensor cores (the (HG x R) x (R x TK) score tile is a small GEMM)
// and TMA are later work.
#include <cuda_runtime.h>
#include <math.h>

#include "mla_attention.cuh"

namespace {

using mla::NT;

template <int NV>
__global__ void __launch_bounds__(NT)
mla_decode_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
                  const float* __restrict__ c_kv, const float* __restrict__ k_rope,
                  const int* __restrict__ pos, float* __restrict__ out,
                  float* __restrict__ ws, int S, int H, int T, int R, int RD, int splits,
                  float scale) {
  const int split = blockIdx.z % splits, b = blockIdx.z / splits, s = blockIdx.x;
  mla::rows<NV>(q_lat, q_rope, c_kv, k_rope, out, ws, b, s, blockIdx.y * mla::HG, split, S, H,
                T, R, RD, splits, pos[b * S + s], scale);
}

template <int NV>
int launch(const float* q_lat, const float* q_rope, const float* c_kv, const float* k_rope,
           const int* pos, float* out, float* ws, int B, int S, int H, int T, int R, int RD,
           int splits, float scale, cudaStream_t stream) {
  const size_t smem = mla::smem_bytes(R, RD);
  static size_t smem_set = 48 * 1024;  // what a launch may use without opting in
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid(S, (H + mla::HG - 1) / mla::HG, B * splits);
  mla_decode_kernel<NV><<<grid, NT, smem, stream>>>(q_lat, q_rope, c_kv, k_rope, pos, out, ws,
                                                     S, H, T, R, RD, splits, scale);
  if (splits > 1) attn::merge_splits(ws, out, (long long)B * S * H, R, splits, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// R and RD must be multiples of 4 and c_kv, k_rope 16-byte aligned (the
// wrapper checks); ws holds B*S*H*splits*(R + 4) floats when splits > 1:
// each split's R outputs, its max and its sum, padded to 16 bytes.
extern "C" int mla_decode_launch(const float* q_lat, const float* q_rope, const float* c_kv,
                                 const float* k_rope, const int* pos, float* out, float* ws,
                                 int B, int S, int H, int T, int R, int RD, int splits,
                                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || RD < 0 || R % 4 || RD % 4 || splits < 1) return (int)cudaErrorInvalidValue;
  if (R <= 128)
    return launch<1>(q_lat, q_rope, c_kv, k_rope, pos, out, ws, B, S, H, T, R, RD, splits, scale, st);
  if (R <= 256)
    return launch<2>(q_lat, q_rope, c_kv, k_rope, pos, out, ws, B, S, H, T, R, RD, splits, scale, st);
  if (R <= 512)
    return launch<4>(q_lat, q_rope, c_kv, k_rope, pos, out, ws, B, S, H, T, R, RD, splits, scale, st);
  return (int)cudaErrorInvalidValue;
}
