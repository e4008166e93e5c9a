// Helpers shared by the attention kernels (GQA and MLA cache decode, flash
// and MLA flash): warp reductions, 16-byte cp.async copies, a 4-wide dot,
// and the merge of the cache kernels' key splits.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace attn {

constexpr float NEG_INF_MASK = -1e30f;  // the reference's mask value

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte global -> shared copy that bypasses registers; a zero source size
// fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }
// wait until every committed group has landed
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// Merges the key splits of the GQA and MLA cache kernels, one warp a
// (b, s, h) row: out = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i over
// the row's splits, in split order, with the row's R <= 32 * NC outputs in
// registers. The lanes compute 32 splits' weights e^(m_i - M) at a time and
// pass them round by shuffles, so no split waits on a load of its max
// before its outputs are read. The workspace holds, for every row and split
// in turn, the split's R unnormalised outputs, its running max and its sum,
// padded to R + 4 floats. A split with no keys (max -inf) adds nothing.
template <int NC>
static __global__ void __launch_bounds__(128)
merge_splits_kernel(const float* __restrict__ ws, float* __restrict__ out, long long rows, int R,
                    int splits) {
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int WS = R + 4;
  const float* w = ws + row * splits * (size_t)WS;
  float m = -INFINITY;
  for (int i = lane; i < splits; i += 32) m = fmaxf(m, w[i * WS + R]);
  m = warp_max(m);
  float l = 0.f, a[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) a[j] = 0.f;
  for (int base = 0; base < splits; base += 32) {
    const float mi = base + lane < splits ? w[(base + lane) * WS + R] : -INFINITY;
    const float ei = mi == -INFINITY ? 0.f : expf(mi - m);
    const int n = min(32, splits - base);
    for (int k = 0; k < n; ++k) {
      const float e = __shfl_sync(0xffffffffu, ei, k);
      if (e == 0.f) continue;  // no keys, or a weight that rounds to 0: adds nothing
      const float* wi = w + (size_t)(base + k) * WS;
      l += e * wi[R + 1];
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if (lane + 32 * j < R) a[j] += e * wi[lane + 32 * j];
    }
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (lane + 32 * j < R) out[row * R + lane + 32 * j] = a[j] * inv;
}

// R <= 512
static inline void merge_splits(const float* ws, float* out, long long rows, int R, int splits,
                                cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + 3) / 4);
  if (R <= 128)
    merge_splits_kernel<4><<<blocks, 128, 0, stream>>>(ws, out, rows, R, splits);
  else
    merge_splits_kernel<16><<<blocks, 128, 0, stream>>>(ws, out, rows, R, splits);
}

}  // namespace attn
