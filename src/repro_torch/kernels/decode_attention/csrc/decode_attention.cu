// Per-query-causal GQA attention over the slot KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py:
// _gqa_decode_kernel (pallas_call in gqa_decode). It computes, for every
// batch row b, head h and query row s:
//   scores_t = (q . k_t) * scale        for t <= pos[b, s], else -1e30
//   out      = softmax(scores) . V
// over the whole cache (B, T, KV, hd) in f32. The kv head is h / groups,
// resolved by index: keys and values are never repeated.
//
// What bounds it on an H100: the bytes of the K and V cache, read once
// (B * T * KV * hd * 4 * 2 bytes). Design: one block per (query tile, head,
// batch row); a loop over T in tiles of 32 keys staged in shared memory (the
// (S, T) score tile of a prefill bucket does not fit in 227 KB), with the
// online softmax (running max and sum, rescaled per tile), so K and V are
// read once. Tiles past max(pos) + 1 of the block's query rows are skipped:
// their weight is exactly 0. Against the plain two-pass softmax the f32
// reduction order differs, which costs a few ulps.
#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"

namespace {

constexpr int TK = 32;       // keys per tile: one per lane
constexpr int NWARPS = 4;    // warps per block
constexpr int RPW = 2;       // query rows per warp
constexpr int QT = NWARPS * RPW;
using attn::NEG_INF_MASK;
using attn::warp_max;
using attn::warp_sum;

template <int HD>
__global__ void __launch_bounds__(NWARPS * 32)
gqa_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ pos,
                  float* __restrict__ out, int S, int H, int T, int KV, int groups,
                  float scale) {
  constexpr int DPL = HD / 32;  // output dims per lane
  __shared__ float ks[TK][HD + 1];
  __shared__ float vs[TK][HD + 1];
  __shared__ float qs[QT][HD];
  __shared__ int qpos[QT];
  __shared__ int t_end_s;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int kvh = h / groups;
  const int nq = min(QT, S - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < nq * HD; i += NWARPS * 32) {
    const int r = i / HD, d = i % HD;
    qs[r][d] = q[((size_t)(b * S + q0 + r) * H + h) * HD + d];
  }
  if (tid < nq) qpos[tid] = pos[b * S + q0 + tid];
  __syncthreads();
  if (tid == 0) {
    int mx = qpos[0];
    for (int r = 1; r < nq; ++r) mx = max(mx, qpos[r]);
    // every key is masked for a row with pos < 0: the softmax is then uniform
    // over all T keys, as in the plain version, so no tile may be skipped
    t_end_s = mx >= 0 ? min(T, mx + 1) : T;
  }
  __syncthreads();
  const int t_end = t_end_s;

  float m_run[RPW], l_run[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
  }

  const size_t row_stride = (size_t)KV * HD;
  const float* kb = k + (size_t)b * T * row_stride + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * T * row_stride + (size_t)kvh * HD;

  for (int t0 = 0; t0 < t_end; t0 += TK) {
    for (int i = tid; i < TK * (HD / 4); i += NWARPS * 32) {
      const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
      const int t = t0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (t < T) {
        kv = *reinterpret_cast<const float4*>(kb + (size_t)t * row_stride + c);
        vv = *reinterpret_cast<const float4*>(vb + (size_t)t * row_stride + c);
      }
      ks[r][c] = kv.x; ks[r][c + 1] = kv.y; ks[r][c + 2] = kv.z; ks[r][c + 3] = kv.w;
      vs[r][c] = vv.x; vs[r][c + 1] = vv.y; vs[r][c + 2] = vv.z; vs[r][c + 3] = vv.w;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + i * NWARPS;
      if (r >= nq) break;
      const int t = t0 + lane;
      float s = -INFINITY;  // keys past the cache end do not exist
      if (t < T) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qs[r][d], ks[lane][d], dot);
        s = (t <= qpos[r]) ? dot * scale : NEG_INF_MASK;
      }
      const float m_new = fmaxf(m_run[i], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + warp_sum(p);
      m_run[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] *= alpha;
#pragma unroll 8
      for (int j = 0; j < TK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[i][d] = fmaf(pj, vs[j][lane + 32 * d], acc[i][d]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + i * NWARPS;
    if (r >= nq) break;
    float* o = out + ((size_t)(b * S + q0 + r) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < DPL; ++d) o[lane + 32 * d] = acc[i][d] / l_run[i];
  }
}

template <int HD>
void launch(const float* q, const float* k, const float* v, const int* pos, float* out, int B,
            int S, int H, int T, int KV, float scale, cudaStream_t stream) {
  dim3 grid((S + QT - 1) / QT, H, B);
  gqa_decode_kernel<HD><<<grid, NWARPS * 32, 0, stream>>>(q, k, v, pos, out, S, H, T, KV,
                                                          H / KV, scale);
}

}  // namespace

extern "C" int gqa_decode_launch(const float* q, const float* k, const float* v, const int* pos,
                                 float* out, int B, int S, int H, int T, int KV, int hd,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: launch<32>(q, k, v, pos, out, B, S, H, T, KV, scale, s); break;
    case 64: launch<64>(q, k, v, pos, out, B, S, H, T, KV, scale, s); break;
    case 128: launch<128>(q, k, v, pos, out, B, S, H, T, KV, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
