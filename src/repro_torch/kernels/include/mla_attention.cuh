// The absorbed-form MLA attention loop shared by the cache-decode kernel
// (decode_attention/csrc/mla_decode.cu) and the cache-free flash kernel
// (mla_flash/csrc/mla_flash.cu). For one batch row b, one query row s and a
// group of up to HG heads it computes, in f32:
//   scores_t = (q_lat . c_kv_t + q_rope . k_rope_t) * scale  for t <= qpos
//            = -1e30                                          otherwise
//   out      = softmax(scores) . c_kv                         (latent, R wide)
// over the keys t < T. The two kernels differ only in where qpos comes from:
// the slot's position array (decode) or the query index itself (flash).
//
// Every head reads the same latent rows (MLA is MQA-shaped in latent space),
// so one block streams the keys in tiles of TK rows of [c_kv | k_rope]
// through shared memory, double-buffered with cp.async, and every head of
// the group uses each tile. Each warp owns RPW heads: a lane scores one key
// of the tile for all of them (each 16-byte read of the key serves RPW
// heads), then the warp walks the tile's keys for P . c_kv with the online
// softmax (running max and sum, rescaled per tile), lane l owning output
// dims 4l..4l+3 (+128 per step). Tiles past qpos are skipped: their weight
// is exactly 0. With splits > 1 a block covers its share of the key tiles
// and writes (acc, max, sum) to ws for a merge kernel; otherwise it writes
// the normalised output.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"

namespace mla {

constexpr int TK = 32;                // keys per tile: one per lane
constexpr int NWARPS = 8;             // warps per block
constexpr int RPW = 4;                // heads per warp
constexpr int HG = NWARPS * RPW;      // heads per block
constexpr int NT = NWARPS * 32;

// dynamic shared memory of one block: two key tiles kv[TK][R + RD + 4] (the
// +4 keeps rows 16-byte aligned and a quarter-warp's 16-byte reads on
// distinct banks) and the group's query rows qs[HG][R + RD]
inline size_t smem_bytes(int R, int RD) {
  return (size_t)(2 * TK * (R + RD + 4) + HG * (R + RD)) * sizeof(float);
}

// NV: float4 output columns per lane, R <= 128 * NV. Heads h0 .. h0 + HG - 1
// (clipped to H) of query row s of batch row b; keys [0, T) with t <= qpos
// visible (qpos < 0 masks every key: the softmax is then uniform over all T
// keys, as in the plain version, so no tile may be skipped).
template <int NV>
__device__ __forceinline__ void rows(const float* __restrict__ q_lat,
                                     const float* __restrict__ q_rope,
                                     const float* __restrict__ c_kv,
                                     const float* __restrict__ k_rope, float* __restrict__ out,
                                     float* __restrict__ ws, int b, int s, int h0, int split,
                                     int S, int H, int T, int R, int RD, int splits, int qpos,
                                     float scale) {
  using attn::dot4;
  extern __shared__ __align__(16) float smem[];
  const int RR = R + RD, KS = RR + 4, R4 = R / 4, RR4 = RR / 4;
  float* qs = smem + 2 * TK * KS;  // [HG][RR]

  const int nh = min(HG, H - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t q_row = (size_t)(b * S + s) * H;

  for (int r = warp; r < nh; r += NWARPS) {
    for (int d = lane; d < R; d += 32) qs[r * RR + d] = q_lat[(q_row + h0 + r) * R + d];
    for (int d = lane; d < RD; d += 32) qs[r * RR + R + d] = q_rope[(q_row + h0 + r) * RD + d];
  }
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
        attn::cp_async16(dst + r * KS + 4 * c, src, valid);
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
  attn::cp_async_commit();
  for (int tile = tile0; tile < tile1; ++tile) {
    float* kv = smem + ((tile - tile0) & 1) * TK * KS;
    if (tile + 1 < tile1) stage(tile + 1, smem + ((tile + 1 - tile0) & 1) * TK * KS);
    attn::cp_async_commit();
    attn::cp_async_wait_one();  // this tile's copies (and the query rows) have landed
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
      // keys past the end do not exist
      sc[i] = t >= T ? -INFINITY : (t <= qpos ? dot * scale : attn::NEG_INF_MASK);
    }
    float p[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float m_new = fmaxf(m_run[i], attn::warp_max(sc[i]));
      p[i] = expf(sc[i] - m_new);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + attn::warp_sum(p[i]);
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

}  // namespace mla
