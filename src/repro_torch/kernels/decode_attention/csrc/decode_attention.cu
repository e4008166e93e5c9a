// Per-query-causal GQA attention over the slot KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py:
// _gqa_decode_kernel (pallas_call in gqa_decode). It computes, for every
// batch row b, head h and query row s:
//   scores_t = (q . k_t) * scale        for t <= pos[b, s], else -1e30
//   out      = softmax(scores) . V
// over the whole cache (B, T, KV, hd) in f32. The kv head is
// (h0 + h) / groups, resolved by index: keys and values are never repeated.
// h0 and groups are 0 and H / KV for a whole call; a tensor-parallel rank
// whose q heads are split over the model axis while the kv heads are not
// (replicated kv heads) passes its first q head's global index and the
// global group count, and reads its kv heads in place in the whole cache.
// A row with pos < 0 sees every key masked: its softmax is uniform over all
// T keys.
//
// Two paths, chosen by the host (decode_attention/ops.py: gqa_plan):
//
// * S >= 16 (a prefill bucket): bound by its multiply-adds (4 * hd per
//   visible (query, key) pair). gqa_decode_tc_kernel runs the tensor-core
//   tile loop of include/gqa_tile.cuh (3xTF32 mma.sync, 64 query rows of
//   one head a block, 32-key K/V tiles double-buffered with cp.async, online
//   softmax on the accumulators, P kept in registers) with the slot
//   positions as the mask.
// * S < 16 (decode, bursts, buckets 4 and 8): bound by the bytes of the K and
//   V cache, read once. One (batch row, kv head) has too few query rows to
//   fill the card, so gqa_decode_split_kernel splits the key tiles of each
//   (batch row, kv head, 16-row group) across `splits` blocks (about two
//   blocks an SM); every block streams its share in 32-key tiles with 16-byte
//   cp.async loads, double-buffered, and serves all S * groups query rows of
//   its kv head from each tile on the CUDA cores (a lane scores one key; the
//   warp walks the tile's keys for P . V). Each split writes its running max,
//   sum and unnormalised output to a workspace; attn::merge_splits
//   (include/attention.cuh, shared with the MLA kernel) merges them. A split
//   with no keys (max -inf) adds nothing.
//
// Split i takes key tiles i, i + splits, ...; tiles past max(pos) + 1 of a
// block's query rows are skipped: their weight is exactly 0. Against the plain two-pass softmax the f32 reduction order
// differs, which costs a few ulps.
#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"
#include "gqa_tile.cuh"

namespace {

using attn::NEG_INF_MASK;
using attn::warp_max;
using attn::warp_sum;

template <int HD>
__global__ void __launch_bounds__(tile::Config<float, HD>::NT)
gqa_decode_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ pos,
                     float* __restrict__ out, int S, int H, int T, int KV, int h0,
                     int groups, float scale, tile::Order order) {
  int bh, rank;
  order.item(blockIdx.x, bh, rank);
  const int b = bh / H, h = bh % H;
  const size_t q_off = ((size_t)b * S * H + h) * HD;
  const size_t kv_off = ((size_t)b * T * KV + (h0 + h) / groups) * HD;
  tile::attend<float, HD>(q + q_off, k + kv_off, v + kv_off, out + q_off,
                                 (size_t)H * HD, (size_t)KV * HD, rank, order.nqb, S, T,
                                 tile::Positions{pos + (size_t)b * S}, scale);
}

constexpr int TK = 32;                 // keys per tile: one per lane
constexpr int NWARPS = 4;              // warps per block
constexpr int RPW = 4;                 // query rows per warp
constexpr int RB = NWARPS * RPW;       // query rows per block
constexpr int NT = NWARPS * 32;

// dynamic shared memory of a split block: two stages of K and V [TK][HD + 4]
// (16-byte rows; a quarter warp's 16-byte reads of 8 key rows hit distinct
// banks) and the block's query rows [RB][HD]
template <int HD>
constexpr size_t split_smem_bytes() {
  return ((size_t)4 * TK * (HD + 4) + (size_t)RB * HD) * sizeof(float);
}

// grid (row_blocks * splits, kv heads read, B): blockIdx.y is the kv head
// h0 / groups + y; its q heads among the call's H are [lo, lo + gk) (all
// `groups` of them in a whole call, fewer at the ends of a rank's share),
// and rows r = s * gk + i are query s of head lo + i
template <int HD>
__global__ void __launch_bounds__(NT)
gqa_decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ pos,
                        float* __restrict__ out, float* __restrict__ ws, int S, int H, int T,
                        int KV, int h0, int groups, int splits, float scale) {
  // output dims per lane: lane l owns dims l, l + 32, ...; the last group is
  // partial unless HD is a multiple of 32 (HD = 112: 4 groups, the last of 16)
  constexpr int DPL = (HD + 31) / 32;
  constexpr int KS = HD + 4;    // K/V shared row stride
  static_assert(HD % 4 == 0, "the split kernel copies and dots 4 floats at a time");
  static_assert(DPL * 32 >= HD && (DPL - 1) * 32 < HD, "every output dim has one lane");
  extern __shared__ __align__(16) float smem[];
  float* kvs = smem;                 // [2][K, V][TK][KS]
  float* qs = smem + 4 * TK * KS;    // [RB][HD]
  __shared__ int qpos[RB];
  __shared__ int t_end_s;

  const int split = blockIdx.x % splits, rb = blockIdx.x / splits;
  const int kvh = h0 / groups + blockIdx.y, b = blockIdx.z;
  const int lo = max(kvh * groups, h0) - h0, gk = min((kvh + 1) * groups, h0 + H) - h0 - lo;
  const int R = S * gk, r0 = rb * RB, nr = min(RB, R - r0);
  if (nr <= 0) return;  // a kv head with fewer q heads than the grid's widest
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < nr * (HD / 4); i += NT) {
    const int r = i / (HD / 4), d = (i % (HD / 4)) * 4;
    const int s = (r0 + r) / gk, hh = lo + (r0 + r) % gk;
    *reinterpret_cast<float4*>(qs + r * HD + d) =
        *reinterpret_cast<const float4*>(q + ((size_t)(b * S + s) * H + hh) * HD + d);
  }
  if (tid < nr) qpos[tid] = pos[b * S + (r0 + tid) / gk];
  __syncthreads();
  if (tid == 0) {
    int mx = qpos[0];
    bool neg = false;
    for (int r = 0; r < nr; ++r) {
      mx = max(mx, qpos[r]);
      neg |= qpos[r] < 0;
    }
    // a row with pos < 0 needs every key (uniform softmax)
    t_end_s = (neg || mx >= T) ? T : mx + 1;
  }
  __syncthreads();
  // split `split` takes every splits-th key tile from tile `split` on, up to
  // the block's last visible key: a query row's keys fall into the same
  // splits, in the same order, whatever rows share its block (a verify's S
  // rows of a slot get the bits the single-row decode of each position
  // gets: a tile masked for a row leaves its running max, sum and output as
  // they were), and a short visible range still spreads over the splits
  const int n_tiles = (t_end_s + TK - 1) / TK;

  const size_t row_stride = (size_t)KV * HD;
  const float* kb = k + (size_t)b * T * row_stride + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * T * row_stride + (size_t)kvh * HD;
  auto stage = [&](int tile, int buf) {
    float* dst = kvs + buf * 2 * TK * KS;
    for (int i = tid; i < 2 * TK * (HD / 4); i += NT) {
      const int which = i / (TK * (HD / 4)), j = i % (TK * (HD / 4));
      const int r = j / (HD / 4), c = (j % (HD / 4)) * 4;
      const int t = tile * TK + r;
      const bool ok = t < T;
      const float* src = (which ? vb : kb) + (size_t)(ok ? t : 0) * row_stride + c;
      attn::cp_async16(dst + which * TK * KS + r * KS + c, src, ok);
    }
  };

  float m_run[RPW], l_run[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
  }

  if (split < n_tiles) stage(split, 0);
  attn::cp_async_commit();
  for (int tile = split; tile < n_tiles; tile += splits) {
    const int buf = (tile / splits) & 1;
    if (tile + splits < n_tiles) stage(tile + splits, buf ^ 1);
    attn::cp_async_commit();
    attn::cp_async_wait_one();
    __syncthreads();
    const float* ks = kvs + buf * 2 * TK * KS;
    const float* vs = ks + TK * KS;
    const int t = tile * TK + lane;
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; d += 4) {
      const float4 kf = *reinterpret_cast<const float4*>(ks + lane * KS + d);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + i * NWARPS;
        if (r < nr) s[i] = attn::dot4(*reinterpret_cast<const float4*>(qs + r * HD + d), kf, s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + i * NWARPS;
      if (r >= nr) break;
      // keys past the cache end do not exist
      const float sc = t >= T ? -INFINITY : t <= qpos[r] ? s[i] * scale : NEG_INF_MASK;
      const float m_new = fmaxf(m_run[i], warp_max(sc));
      const float p = expf(sc - m_new);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + warp_sum(p);
      m_run[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] *= alpha;
#pragma unroll 8
      for (int j = 0; j < TK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int d = 0; d < DPL; ++d)
          if (lane + 32 * d < HD) acc[i][d] = fmaf(pj, vs[j * KS + lane + 32 * d], acc[i][d]);
      }
    }
    __syncthreads();  // the next stage overwrites this buffer
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + i * NWARPS;
    if (r >= nr) break;
    const int s = (r0 + r) / gk, hh = lo + (r0 + r) % gk;
    const size_t row = (size_t)(b * S + s) * H + hh;
    if (splits == 1) {
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        if (lane + 32 * d < HD) out[row * HD + lane + 32 * d] = acc[i][d] / l_run[i];
    } else {
      float* w = ws + (row * splits + split) * (HD + 4);
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        if (lane + 32 * d < HD) w[lane + 32 * d] = acc[i][d];
      if (lane == 0) {
        w[HD] = m_run[i];
        w[HD + 1] = l_run[i];
      }
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const int* pos, float* out, float* ws,
           int B, int S, int H, int T, int KV, int h0, int groups, int splits, int tc,
           float scale, cudaStream_t stream) {
  if (tc) {
    using C = tile::Config<float, HD>;
    static int sms = 0, resident = 0;  // set once, with the shared-memory opt-in
    if (!resident) {
      if (const int e = tile::opt_in(gqa_decode_tc_kernel<HD>, C::SMEM)) return e;
      if (const int e = tile::residency(gqa_decode_tc_kernel<HD>, C::NT, C::SMEM, sms, resident))
        return e;
    }
    const tile::Order order = tile::order(sms, resident, B * H, S);
    gqa_decode_tc_kernel<HD><<<order.nqb * order.n_bh, C::NT, C::SMEM, stream>>>(
        q, k, v, pos, out, S, H, T, KV, h0, groups, scale, order);
    return (int)cudaGetLastError();
  }
  constexpr size_t smem = split_smem_bytes<HD>();
  static bool opted = false;  // above 48 KB a launch must opt in, once
  if (!opted) {
    if (const int e = tile::opt_in(gqa_decode_split_kernel<HD>, smem)) return e;
    opted = true;
  }
  // the widest kv head's rows set the row blocks; the kv heads read are
  // those of q heads h0 .. h0 + H - 1
  const int row_blocks = (S * min(groups, H) + RB - 1) / RB;
  const int n_kv = (h0 + H - 1) / groups - h0 / groups + 1;
  dim3 grid(row_blocks * splits, n_kv, B);
  gqa_decode_split_kernel<HD><<<grid, NT, smem, stream>>>(q, k, v, pos, out, ws, S, H, T, KV,
                                                          h0, groups, splits, scale);
  if (splits > 1) attn::merge_splits(ws, out, (long long)B * S * H, HD, splits, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, hd), k and v (B, T, KV, hd), out (B, S, H, hd), pos (B, S),
// contiguous and 16-byte aligned (the wrapper checks). q head h reads kv
// head (h0 + h) / groups: h0 = 0 and groups = H / KV for a whole call, a
// rank's first global q head and the global group count for a rank's share
// of the q heads against the whole kv heads. tc != 0 takes the
// tensor-core path (S >= 16 in gqa_plan); otherwise the split-key path, with
// ws holding B*S*H*splits*(hd + 4) floats when splits > 1: each split's hd
// outputs, its max and its sum, padded to 16 bytes.
extern "C" int gqa_decode_launch(const float* q, const float* k, const float* v, const int* pos,
                                 float* out, float* ws, int B, int S, int H, int T, int KV,
                                 int hd, int h0, int groups, int splits, int tc, float scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || T <= 0 || KV <= 0 || h0 < 0 || groups < 1 ||
      (h0 + H - 1) / groups >= KV || splits < 1)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, pos, out, ws, B, S, H, T, KV, h0, groups, splits, tc, scale, s);
    case 64:
      return launch<64>(q, k, v, pos, out, ws, B, S, H, T, KV, h0, groups, splits, tc, scale, s);
    case 112:
      return launch<112>(q, k, v, pos, out, ws, B, S, H, T, KV, h0, groups, splits, tc, scale,
                         s);
    case 128:
      return launch<128>(q, k, v, pos, out, ws, B, S, H, T, KV, h0, groups, splits, tc, scale,
                         s);
    default: return (int)cudaErrorInvalidValue;
  }
}
