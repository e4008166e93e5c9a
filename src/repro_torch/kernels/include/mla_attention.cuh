// The absorbed-form MLA attention loop shared by the cache attention
// (decode_attention/csrc/mla_decode.cu) and the cache-free flash kernel
// (mla_flash/csrc/mla_flash.cu). For one batch row b, one query row s and a
// block of up to ROWS heads it computes, in f32:
//   scores_t = (q_lat . c_kv_t + q_rope . k_rope_t) * scale  for t <= qpos
//            = -1e30                                          otherwise
//   out      = softmax(scores) . c_kv                         (latent, R wide)
// over the keys t < T. The two kernels differ only in where qpos comes from:
// the slot's position array (cache) or the query index itself (flash). A
// query with qpos < 0 sees every key masked, so its softmax is uniform over
// all T keys, as in the plain versions; one with qpos >= T sees every key.
//
// What bounds it on an H100: H * (2R + r) multiply-adds per visible (query,
// key) pair, against R + r floats of latent per key that every head reads
// (MLA is MQA-shaped in latent space). Both products run on the tensor
// cores with gqa_tile.cuh's 3xTF32 split (a = hi + lo, a.b ~ hi.lo + lo.hi +
// hi.hi on mma.sync.m16n8k8.tf32, about f32 accuracy). The MMA rows are the
// heads of one query: they read the same latent rows and share one mask,
// so even a decode step (S = 1) fills the 16-row MMA, a block skips exactly
// the tiles past its query's position, and the mask applies to one tile.
//
// Block: ROWS = 32 heads of one (b, s) in two groups of 16 rows; each group
// has CW = 4 warps, and warp cq of a group owns output columns
// [128 cq, 128 cq + 128) (64 accumulator registers: 16 rows x 512 f32 would
// need 256, past the 255 a thread may use) and contracts Q K^T over a
// quarter of the R + r dims. The four partial score tiles (16 x 32 f32
// each) meet in shared memory and every warp of the group adds them in the
// same order, so the four warps hold the same P; recomputing the scores in
// each warp would cost 53 % more flops. Keys stream in tiles of BK = 32
// rows of [c_kv | k_rope] through shared memory (16-byte cp.async, double
// buffered): one staged tile serves Q K^T over all R + r dims and P . c_kv
// over the first R, for all 32 heads. Shared memory at R = 512, r = 64: two
// tiles (144 KB), Q's lo parts (64 KB) and the score exchange (16 KB), 224
// KB, one block of 8 warps an SM (two warps a sub-partition).
//
// Q's 32 rows are staged once, in the tile layout, in the second tile
// buffer (before the first tile's loop overwrites it), and split once: hi
// stays in registers (72 at R + r = 576); lo stays in registers for the
// first KLO k-steps and goes to shared memory for the rest (all of it would
// not fit beside two tiles and the exchange). The tiles hold raw f32 and
// every warp splits its fragments as it loads them. QK^T contracts
// each 8-dim group in the order (0, 2, 4, 6, 1, 3, 5, 7), so a thread's two
// Q or K values are adjacent (one 8-byte load); P stays in registers, the
// P . c_kv MMA reading key 2c in its column c and key 2c + 1 in c + 4. A
// thread loads two adjacent c_kv columns of one key (8 bytes) for two
// n-tiles: n-tile 2m column g is latent column 16m + 2g, n-tile 2m + 1
// column g is 16m + 2g + 1, so a thread's outputs of row g are the 4
// adjacent columns 16m + 4c .. + 3 (one 16-byte store). One row stride
// cannot keep both the 8-byte K loads (rows g = 0..3 of a half-warp) and
// the V loads (rows 2c, 2c + 1) free of bank conflicts, so rows are not
// padded: the 8-float groups of tile row t are XOR-swizzled by
// ((t & 3) ^ ((t >> 2) & 1)), which spreads both over all 32 banks.
//
// The online softmax runs in base 2 on the score accumulators, as in
// gqa_tile.cuh. The MMA's f32 sum rounds toward zero: a tile's P . c_kv
// goes to a fresh accumulator and joins O in one fma with the rescale
// (O = alpha O + tile), so O takes one rounding a tile rather than one
// toward zero every MMA (at T = 512, 192 of them: errors of ~1.7e-5 against
// the plain version, near the 2e-5 tolerance). With splits > 1 a block covers its share of the key tiles
// and writes its unnormalised output, its max (natural-log units) and its
// sum to ws for attn::merge_splits; otherwise the normalised output.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "gqa_tile.cuh"

namespace mla {

constexpr int BK = 32;               // keys per tile
constexpr int GROUPS = 2;            // 16-row groups per block
constexpr int CW = 4;                // warps per row group
constexpr int WARPS = GROUPS * CW;
constexpr int NT = WARPS * 32;
constexpr int ROWS = GROUPS * 16;    // heads per block
constexpr int NK = BK / 8;           // 8-key groups of a tile
constexpr int NP = 8;                // 16-column output groups per warp: R <= 512
constexpr int KQ = 18;               // 8-dim k-steps per warp at most: R + r <= 576
constexpr int KLO = 2;               // k-steps whose Q lo stays in registers
constexpr int PV = 2;                // output groups of P . c_kv per accumulator group
constexpr float LN2 = 0.6931471805599453f;

// a tile row's floats: R + r rounded up to the 4 warps' 8-dim k-steps (the
// tail is zero)
__host__ __device__ inline int width(int R, int RD) { return (R + RD + 31) / 32 * 32; }

// dynamic shared memory of one block: two key tiles [BK][W], Q's lo parts
// past the first KLO k-steps [WARPS][kq - KLO][32] (uint4) and the score
// exchange [WARPS][NK][32] (float4)
inline size_t smem_bytes(int R, int RD) {
  const int kq = width(R, RD) / 32, lo = kq > KLO ? kq - KLO : 0;
  return (size_t)2 * BK * width(R, RD) * sizeof(float) +
         (size_t)WARPS * (lo + NK) * 32 * sizeof(float4);
}

// the XOR applied to the column of tile row t (bits 3 and 4: 8-float groups)
__device__ __forceinline__ int swz(int t) { return ((t & 3) ^ ((t >> 2) & 1)) << 3; }

// d = a . b on the tensor cores (mma.sync m16n8k8 TF32, f32 sum), from zero
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// the 4 warps of one row group wait for each other
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(CW * 32) : "memory");
}

// Heads h0 .. h0 + ROWS - 1 (clipped to H) of query row s of batch row b;
// keys [0, T) with t <= qpos visible; key tiles of this split's share.
__device__ __forceinline__ void rows(const float* __restrict__ q_lat,
                                     const float* __restrict__ q_rope,
                                     const float* __restrict__ c_kv,
                                     const float* __restrict__ k_rope, float* __restrict__ out,
                                     float* __restrict__ ws, int b, int s, int h0, int split,
                                     int S, int H, int T, int R, int RD, int splits, int qpos,
                                     float scale) {
  using tile::mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int RR = R + RD, W = width(R, RD), kq = W / 32, nlo = kq > KLO ? kq - KLO : 0;
  float* tiles = reinterpret_cast<float*>(smem_raw);              // [2][BK][W], swizzled
  uint4* qlo_s = reinterpret_cast<uint4*>(tiles + 2 * BK * W);    // [WARPS][nlo][32]
  float4* xch = reinterpret_cast<float4*>(qlo_s + WARPS * nlo * 32);  // [WARPS][NK][32]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int rg = warp / CW, cq = warp % CW;
  const int dbase = cq * 8 * kq;   // this warp's first contraction dim
  const int cbase = cq * 16 * NP;  // this warp's first output column
  const size_t q_row = (size_t)(b * S + s) * H;

  const int t_end = qpos >= 0 ? min(T, qpos + 1) : T;
  const int n_tiles = (t_end + BK - 1) / BK;
  // split `split` takes every splits-th key tile from tile `split` on, as
  // the GQA split path does: a query's tiles go to the same splits in the
  // same order whatever rows share the call

  const float* cb = c_kv + (size_t)b * T * R;
  const float* kb = k_rope + (size_t)b * T * RD;
  // one warp per tile row: lanes copy its W / 4 16-byte pieces, zero past
  // R + r and for keys past T
  auto stage = [&](int kt, float* dst) {
    for (int r = warp; r < BK; r += WARPS) {
      const int t = kt * BK + r, f = swz(r);
      const bool key = t < T;
      const size_t tc = key ? t : 0;
      for (int d = 4 * lane; d < W; d += 128) {
        const float* src = d < R ? cb + tc * R + d : d < RR ? kb + tc * RD + (d - R) : cb;
        attn::cp_async16(dst + r * W + (d ^ f), src, key && d < RR);
      }
    }
  };
  // Q's raw rows (the block's ROWS heads, in the tile layout) go to tile
  // buffer 1, which tile 1 overwrites only after every warp has read them:
  // 16-byte copies when q_lat and q_rope are 16-byte aligned, else floats;
  // rows past H and dims past R + r are zero
  float* qs = tiles + BK * W;
  const bool q16 = ((reinterpret_cast<uintptr_t>(q_lat) | reinterpret_cast<uintptr_t>(q_rope)) &
                    15) == 0;
  for (int r = warp; r < ROWS; r += WARPS) {
    const int h = h0 + r, f = swz(r);
    const size_t row = q_row + (h < H ? h : 0);
    for (int d = 4 * lane; d < W; d += 128) {
      const bool ok = h < H && d < RR;
      const float* src = d < R ? q_lat + row * R + d : d < RR ? q_rope + row * RD + (d - R) : q_lat;
      float* dst = qs + r * W + (d ^ f);
      if (q16) {
        attn::cp_async16(dst, src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = ok ? src[e] : 0.f;
      }
    }
  }
  if (split < n_tiles) stage(split, tiles);
  attn::cp_async_commit();
  attn::cp_async_wait_all();
  __syncthreads();

  // Q's fragments (block rows wr + g and wr + g + 8, dims dbase + 8 kk + 2c
  // and + 1), split once: hi in registers, lo in registers for the first KLO
  // k-steps and in shared memory (fragment order) for the rest
  const int wr = rg * 16;
  const int fk = swz(g);  // rows g, g + 8 and every key row 8n + g
  uint32_t qhi[KQ][4], qlo[KLO][4];
  {
    const float* qa = qs + (wr + g) * W + 2 * c;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint4 lo = make_uint4(0u, 0u, 0u, 0u);
      qhi[kk][0] = qhi[kk][1] = qhi[kk][2] = qhi[kk][3] = 0u;
      if (kk < kq) {
        const int col = (dbase + 8 * kk) ^ fk;
        const float2 x0 = *reinterpret_cast<const float2*>(qa + col);
        const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * W + col);
        tile::split<true>(x0.x, qhi[kk][0], lo.x);
        tile::split<true>(x1.x, qhi[kk][1], lo.y);
        tile::split<true>(x0.y, qhi[kk][2], lo.z);
        tile::split<true>(x1.y, qhi[kk][3], lo.w);
        if (kk >= KLO) qlo_s[(warp * nlo + kk - KLO) * 32 + lane] = lo;
      }
      if (kk < KLO) {
        qlo[kk][0] = lo.x, qlo[kk][1] = lo.y, qlo[kk][2] = lo.z, qlo[kk][3] = lo.w;
      }
    }
  }

  // scores in base-2 units (scale * log2 e folded in); the mask value stays
  // -1e30, far below any score in either unit
  const float scale2 = scale * tile::LOG2E;
  float o[2 * NP][4], m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int fv0 = swz(2 * c), fv1 = swz(2 * c + 1);

  for (int kt = split, i = 0; kt < n_tiles; kt += splits, ++i) {
    attn::cp_async_wait_all();  // this tile's copies have landed
    __syncthreads();            // for every thread; every warp is done with tile i - 1 (and Q)
    if (kt + splits < n_tiles) stage(kt + splits, tiles + ((i + 1) & 1) * BK * W);
    attn::cp_async_commit();
    const float* kv = tiles + (i & 1) * BK * W;
    const int k0 = kt * BK;

    // this warp's partial Q K^T: 16 rows x BK keys over its kq k-steps; the
    // 3xTF32 terms in two accumulators (hi.hi, and the cross terms)
    float sc[NK][4], sx[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = sx[n][e] = 0.f;
    const float* krow = kv + g * W + 2 * c;  // key 8n + g: row swizzle swz(g)
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      if (kk < kq) {
        uint32_t alo[4];
        if (kk < KLO) {
#pragma unroll
          for (int e = 0; e < 4; ++e) alo[e] = qlo[kk][e];
        } else {
          const uint4 l4 = qlo_s[(warp * nlo + kk - KLO) * 32 + lane];
          alo[0] = l4.x, alo[1] = l4.y, alo[2] = l4.z, alo[3] = l4.w;
        }
        const int col = (dbase + 8 * kk) ^ fk;
        uint32_t bh[NK][2], bl[NK][2];
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float2 x = *reinterpret_cast<const float2*>(krow + 8 * n * W + col);
          tile::split<true>(x.x, bh[n][0], bl[n][0]);
          tile::split<true>(x.y, bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NK; ++n) mma(sx[n], qhi[kk], bl[n][0], bl[n][1]);
#pragma unroll
        for (int n = 0; n < NK; ++n) mma(sc[n], qhi[kk], bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < NK; ++n) mma(sx[n], alo, bh[n][0], bh[n][1]);
      }
    }

    // the group's four partials, added in warp order by every warp of it
#pragma unroll
    for (int n = 0; n < NK; ++n)
      xch[(warp * NK + n) * 32 + lane] = make_float4(sc[n][0] + sx[n][0], sc[n][1] + sx[n][1],
                                                     sc[n][2] + sx[n][2], sc[n][3] + sx[n][3]);
    group_sync(rg);
    float p[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const float4 a = xch[((rg * CW) * NK + n) * 32 + lane];
      p[n][0] = a.x, p[n][1] = a.y, p[n][2] = a.z, p[n][3] = a.w;
#pragma unroll
      for (int w = 1; w < CW; ++w) {
        const float4 x = xch[((rg * CW + w) * NK + n) * 32 + lane];
        p[n][0] += x.x, p[n][1] += x.y, p[n][2] += x.z, p[n][3] += x.w;
      }
    }

    // mask (one position for every row), online softmax (row i of this
    // thread: p[n][2i], p[n][2i + 1], keys 8n + 2c and + 1)
    const bool whole = k0 + BK - 1 <= qpos && k0 + BK <= T;  // block-uniform
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = p[n][e] * scale2;
        if (!whole) {
          const int key = k0 + 8 * n + 2 * c + (e & 1);
          if (key >= T) {
            x = -INFINITY;  // past the end: the key does not exist
          } else if (key > qpos) {
            x = attn::NEG_INF_MASK;
          }
        }
        p[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // finite from the split's first tile on: its first key exists and
      // scores at least -1e30
      const float m_new = fmaxf(m_run[r], tile::quad_max(mx[r]));
      alpha[r] = tile::exp2_approx(m_run[r] - m_new);
      m_run[r] = m_new;
      l_part[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = tile::exp2_approx(p[n][e] - m_run[e >> 1]);
        p[n][e] = x;
        l_part[e >> 1] += x;
      }
    }
    // O = alpha O + P . c_kv over this warp's columns, PV output groups (2 PV
    // n-tiles) at a time: the tile's products go to a fresh accumulator, its
    // three passes over the group's n-tiles (the small terms first), and
    // join O in one f32 fma. The MMA's f32 sum rounds toward zero, so a term
    // added straight into O would cost O an ulp every MMA
    uint32_t phi[NK][4], plo[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      tile::split<true>(p[j][0], phi[j][0], plo[j][0]);
      tile::split<true>(p[j][2], phi[j][1], plo[j][1]);
      tile::split<true>(p[j][1], phi[j][2], plo[j][2]);
      tile::split<true>(p[j][3], phi[j][3], plo[j][3]);
    }
#pragma unroll
    for (int m0 = 0; m0 < NP; m0 += PV) {
      if (cbase + 16 * m0 >= R) break;  // warp-uniform: groups past R
      float acc[PV][2][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float* v0 = kv + (8 * j + 2 * c) * W;  // key 8j + 2c: swizzle fv0
        const float* v1 = v0 + W;                     // key 8j + 2c + 1: fv1
        uint32_t bh[PV][2][2], bl[PV][2][2];  // [group][n-tile 2m, 2m + 1][key 2c, 2c + 1]
#pragma unroll
        for (int u = 0; u < PV; ++u) {
          const int col = cbase + 16 * (m0 + u) + 2 * g;
          const float2 x0 = *reinterpret_cast<const float2*>(v0 + (col ^ fv0));
          const float2 x1 = *reinterpret_cast<const float2*>(v1 + (col ^ fv1));
          tile::split<true>(x0.x, bh[u][0][0], bl[u][0][0]);
          tile::split<true>(x1.x, bh[u][0][1], bl[u][0][1]);
          tile::split<true>(x0.y, bh[u][1][0], bl[u][1][0]);
          tile::split<true>(x1.y, bh[u][1][1], bl[u][1][1]);
        }
#pragma unroll
        for (int u = 0; u < PV; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (j == 0) {
              mma_zero(acc[u][h], phi[j], bl[u][h][0], bl[u][h][1]);
            } else {
              mma(acc[u][h], phi[j], bl[u][h][0], bl[u][h][1]);
            }
          }
#pragma unroll
        for (int u = 0; u < PV; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h) mma(acc[u][h], plo[j], bh[u][h][0], bh[u][h][1]);
#pragma unroll
        for (int u = 0; u < PV; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h) mma(acc[u][h], phi[j], bh[u][h][0], bh[u][h][1]);
      }
#pragma unroll
      for (int u = 0; u < PV; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* on = o[2 * (m0 + u) + h];
          on[0] = fmaf(on[0], alpha[0], acc[u][h][0]);
          on[1] = fmaf(on[1], alpha[0], acc[u][h][1]);
          on[2] = fmaf(on[2], alpha[1], acc[u][h][2]);
          on[3] = fmaf(on[3], alpha[1], acc[u][h][3]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_sum = tile::quad_sum(l_part[r]);
    const int h = h0 + wr + g + 8 * r;
    if (h >= H) continue;
    const size_t row = q_row + h;
    float* dst;
    float inv = 1.f;
    if (splits == 1) {
      dst = out + row * R;
      inv = 1.f / l_sum;
    } else {
      dst = ws + (row * splits + split) * (size_t)(R + 4);
      if (cq == 0 && c == 0) {
        dst[R] = m_run[r] * LN2;  // natural-log units, as merge_splits reads them
        dst[R + 1] = l_sum;
      }
    }
#pragma unroll
    for (int m = 0; m < NP; ++m) {
      const int col = cbase + 16 * m + 4 * c;
      if (col < R)
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(o[2 * m][2 * r] * inv, o[2 * m + 1][2 * r] * inv,
                        o[2 * m][2 * r + 1] * inv, o[2 * m + 1][2 * r + 1] * inv);
    }
  }
}

}  // namespace mla
