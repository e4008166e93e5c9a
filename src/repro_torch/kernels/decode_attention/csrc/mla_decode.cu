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
// head re-reads the whole cache. Here one block takes one query row and a
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
// so the host splits the keys of each block across
// `splits` blocks; each writes its running max, sum and unnormalised output
// to a workspace and a second kernel merges them. A prefill bucket has
// blocks to spare and runs unsplit. Against the plain two-pass softmax the
// f32 reduction order differs, which costs a few ulps. Tensor cores (the
// (HG x R) x (R x TK) score tile is a small GEMM) and TMA are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TK = 32;                // keys per tile: one per lane
constexpr int NWARPS = 8;             // warps per block
constexpr int RPW = 4;                // heads per warp
constexpr int HG = NWARPS * RPW;      // heads per block
constexpr int NT = NWARPS * 32;
constexpr float NEG_INF_MASK = -1e30f;

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
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// NV: float4 output columns per lane, R <= 128 * NV. Dynamic shared memory
// holds two key tiles kv[TK][KS] (KS = R + r + 4 keeps rows 16-byte aligned
// and a quarter-warp's 16-byte reads on distinct banks) and qs[HG][R + r].
// With splits > 1 a block covers its share of the key tiles and writes
// (acc, max, sum) to ws; otherwise it writes the normalised output.
template <int NV>
__global__ void __launch_bounds__(NT)
mla_decode_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
                  const float* __restrict__ c_kv, const float* __restrict__ k_rope,
                  const int* __restrict__ pos, float* __restrict__ out,
                  float* __restrict__ ws, int S, int H, int T, int R, int RD, int splits,
                  float scale) {
  extern __shared__ __align__(16) float smem[];
  const int RR = R + RD, KS = RR + 4, R4 = R / 4, RR4 = RR / 4;
  float* qs = smem + 2 * TK * KS;  // [HG][RR]

  const int split = blockIdx.z % splits, b = blockIdx.z / splits;
  const int h0 = blockIdx.y * HG, s = blockIdx.x;
  const int nh = min(HG, H - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t q_row = (size_t)(b * S + s) * H;

  for (int r = warp; r < nh; r += NWARPS) {
    for (int d = lane; d < R; d += 32) qs[r * RR + d] = q_lat[(q_row + h0 + r) * R + d];
    for (int d = lane; d < RD; d += 32) qs[r * RR + R + d] = q_rope[(q_row + h0 + r) * RD + d];
  }
  const int qpos = pos[b * S + s];
  // every key is masked for a row with pos < 0: the softmax is then uniform
  // over all T keys, as in the plain version, so no tile may be skipped
  const int t_end = qpos >= 0 ? min(T, qpos + 1) : T;
  const int n_tiles = (t_end + TK - 1) / TK;
  const int per = (n_tiles + splits - 1) / splits;
  const int tile0 = split * per, tile1 = min(n_tiles, tile0 + per);

  const float* cb = c_kv + (size_t)b * T * R;
  const float* kb = k_rope + (size_t)b * T * RD;
  // one warp per key row of a tile: lanes copy its R / 4 + r / 4 float4s
  auto stage = [&](int tile, float* dst) {
    for (int r = warp; r < TK; r += NWARPS) {
      const int t = tile * TK + r;
      const bool valid = t < T;
      const int tc = valid ? t : 0;
      for (int c = lane; c < RR4; c += 32) {
        const float* src = c < R4 ? cb + (size_t)tc * R + 4 * c : kb + (size_t)tc * RD + 4 * (c - R4);
        cp_async16(dst + r * KS + 4 * c, src, valid);
      }
    }
  };

  float m_run[RPW], l_run[RPW];
  float4 acc[RPW][NV];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[i][v] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  if (tile0 < tile1) stage(tile0, smem);
  cp_async_commit();
  for (int tile = tile0; tile < tile1; ++tile) {
    float* kv = smem + ((tile - tile0) & 1) * TK * KS;
    if (tile + 1 < tile1) stage(tile + 1, smem + ((tile + 1 - tile0) & 1) * TK * KS);
    cp_async_commit();
    cp_async_wait_one();  // this tile's copies (and the query rows) have landed
    __syncthreads();

    // scores: each 16-byte read of the lane's key serves the warp's RPW
    // heads; two partial sums per head and term keep 2 * RPW chains going
    const int t = tile * TK + lane;
    const float4* k4 = reinterpret_cast<const float4*>(kv + lane * KS);
    const float4* q4[RPW];
    float lat0[RPW], lat1[RPW], rop0[RPW], rop1[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      q4[i] = reinterpret_cast<const float4*>(qs + min(warp + i * NWARPS, nh - 1) * RR);
      lat0[i] = lat1[i] = rop0[i] = rop1[i] = 0.f;
    }
    int d = 0;
    for (; d + 1 < R4; d += 2) {
      const float4 ka = k4[d], kb = k4[d + 1];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        lat0[i] = dot4(q4[i][d], ka, lat0[i]);
        lat1[i] = dot4(q4[i][d + 1], kb, lat1[i]);
      }
    }
    if (d < R4) {
      const float4 ka = k4[d];
#pragma unroll
      for (int i = 0; i < RPW; ++i) lat0[i] = dot4(q4[i][d], ka, lat0[i]);
    }
    for (d = R4; d + 1 < RR4; d += 2) {
      const float4 ka = k4[d], kb = k4[d + 1];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        rop0[i] = dot4(q4[i][d], ka, rop0[i]);
        rop1[i] = dot4(q4[i][d + 1], kb, rop1[i]);
      }
    }
    if (d < RR4) {
      const float4 ka = k4[d];
#pragma unroll
      for (int i = 0; i < RPW; ++i) rop0[i] = dot4(q4[i][d], ka, rop0[i]);
    }
    float sc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float dot = (lat0[i] + lat1[i]) + (rop0[i] + rop1[i]);
      // keys past the cache end do not exist
      sc[i] = t >= T ? -INFINITY : (t <= qpos ? dot * scale : NEG_INF_MASK);
    }
    float p[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float m_new = fmaxf(m_run[i], warp_max(sc[i]));
      p[i] = expf(sc[i] - m_new);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + warp_sum(p[i]);
      m_run[i] = m_new;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        acc[i][v].x *= alpha; acc[i][v].y *= alpha; acc[i][v].z *= alpha; acc[i][v].w *= alpha;
      }
    }
#pragma unroll 4
    for (int j = 0; j < TK; ++j) {
      float pj[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) pj[i] = __shfl_sync(0xffffffffu, p[i], j);
      const float4* v4 = reinterpret_cast<const float4*>(kv + j * KS);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = lane + 32 * v;
        if (c < R4) {
          const float4 x = v4[c];
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            acc[i][v].x = fmaf(pj[i], x.x, acc[i][v].x);
            acc[i][v].y = fmaf(pj[i], x.y, acc[i][v].y);
            acc[i][v].z = fmaf(pj[i], x.z, acc[i][v].z);
            acc[i][v].w = fmaf(pj[i], x.w, acc[i][v].w);
          }
        }
      }
    }
    __syncthreads();  // the next stage overwrites this buffer
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + i * NWARPS;
    if (r >= nh) break;
    const size_t row = q_row + h0 + r;
    if (splits == 1) {
      float4* o = reinterpret_cast<float4*>(out + row * R);
      const float inv = 1.f / l_run[i];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = lane + 32 * v;
        if (c < R4) {
          const float4 a = acc[i][v];
          o[c] = make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
        }
      }
    } else {
      float* w = ws + (row * splits + split) * (size_t)(R + 4);
      if (lane == 0) { w[R] = m_run[i]; w[R + 1] = l_run[i]; }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = lane + 32 * v;
        if (c < R4) reinterpret_cast<float4*>(w)[c] = acc[i][v];
      }
    }
  }
}

// one warp per (b, s, h) row: out = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i
// over the row's splits; a split with no keys has m_i = -inf and adds nothing
__global__ void __launch_bounds__(NT)
mla_merge_kernel(const float* __restrict__ ws, float* __restrict__ out, long long rows, int R,
                 int splits) {
  const long long row = (long long)blockIdx.x * NWARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int WS = R + 4;
  const float* w = ws + row * splits * (size_t)WS;
  float m = -INFINITY;
  for (int i = 0; i < splits; ++i) m = fmaxf(m, w[i * WS + R]);
  float l = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float mi = w[i * WS + R];
    if (mi != -INFINITY) l += expf(mi - m) * w[i * WS + R + 1];
  }
  const float inv = 1.f / l;
  for (int c = lane; c < R; c += 32) {
    float a = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float mi = w[i * WS + R];
      if (mi != -INFINITY) a += expf(mi - m) * w[i * WS + c];
    }
    out[row * R + c] = a * inv;
  }
}

template <int NV>
int launch(const float* q_lat, const float* q_rope, const float* c_kv, const float* k_rope,
           const int* pos, float* out, float* ws, int B, int S, int H, int T, int R, int RD,
           int splits, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * TK * (R + RD + 4) + HG * (R + RD)) * sizeof(float);
  static size_t smem_set = 48 * 1024;  // what a launch may use without opting in
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid(S, (H + HG - 1) / HG, B * splits);
  mla_decode_kernel<NV><<<grid, NT, smem, stream>>>(q_lat, q_rope, c_kv, k_rope, pos, out, ws,
                                                     S, H, T, R, RD, splits, scale);
  if (splits > 1) {
    const long long rows = (long long)B * S * H;
    mla_merge_kernel<<<(unsigned)((rows + NWARPS - 1) / NWARPS), NT, 0, stream>>>(ws, out, rows,
                                                                                 R, splits);
  }
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
