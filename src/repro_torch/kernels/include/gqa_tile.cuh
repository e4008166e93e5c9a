// The tensor-core tile loop of dense (GQA) attention, shared by the cache-free
// flash kernel (flash_attention/csrc/flash_attention.cu) and the GQA cache
// attention at S >= 16 (decode_attention/csrc/decode_attention.cu). For one
// batch row and one head it computes, in f32:
//   scores_j = (q_i . k_j) * scale     j <= lim(i), j < n_keys
//            = -1e30                   j >  lim(i) (masked)
//   out_i    = softmax(scores) . V     rows with no weight emit 0
// where the mask functor gives each row's last visible key lim(i): the query
// index (causal flash), INT_MAX (full flash) or the slot position pos[b, s]
// (cache attention). A row with lim < 0 sees every key masked, so its
// softmax is uniform over all n_keys keys, as in the plain versions.
//
// What bounds it on an H100: 4 * D flops per visible (query, key) pair, far
// above the bytes. The CUDA-core design reached 20 % of its f32-FMA bound
// (67 TFLOP/s); this loop runs both products on the tensor cores with the
// 3xTF32 split: a = hi + lo with hi and lo tf32 (rounded to nearest, ties
// away, as cvt.rna.tf32.f32), and a.b ~ hi.lo + lo.hi + hi.hi in f32
// accumulators (the small terms first), which keeps about f32 accuracy at a
// third of the TF32 rate (494.7 TFLOP/s dense). A bf16 operand is exactly a
// tf32 (its lo is 0): those passes are skipped.
//
// FlashAttention-2 structure on mma.sync.m16n8k8.tf32: a block of 4 warps
// takes 64 query rows of one (batch row, head), each warp 16 of them; K and
// V stream in tiles of BK = 32 keys through shared memory, double-buffered
// with 16-byte cp.async, so the next tile's copy overlaps this tile's
// products; Q is staged once and split once (hi in registers, lo in shared
// memory; at D = 256 each tile splits it again). Shared memory holds raw K
// and V, f32 (or bf16), and every warp splits them at its fragment loads: on the H100,
// splitting each tile once per block into hi/lo tiles doubled the
// shared-memory bytes every fragment load reads and cost more than the
// splits it saved, and the MMA issued one instruction per ~8 clocks on a
// sub-partition only with two warps on it, which needs two blocks an SM
// (101 KB of shared memory each at D = 128, f32). The online softmax runs
// on the score accumulators: a thread holds rows g and g + 8 (g = lane / 4)
// and keys 2c, 2c + 1 of each 8-key group (c = lane % 4); the row max
// reduces over the 4-lane quad, the row sum stays per thread until the end.
// P stays in registers: the P.V MMA reads its A column c as key 2c and
// column c + 4 as key 2c + 1, and the V fragment rows follow that order (the
// contraction over keys does not care). QK^T contracts over D in the same
// permuted order (k = c <-> dim 2c, k = c + 4 <-> dim 2c + 1), so a thread's
// two Q or K values are adjacent: one 8-byte shared load. Row strides are
// padded (K and Q by 8 elements, f32 V by 4) so that every fragment load is
// free of bank conflicts. Each 3xTF32 pass runs over a group of
// accumulators before the next, so that no MMA waits on the one just issued
// (the cross terms of QK^T in an accumulator of their own; a third one for
// the second cross term measured slower: register pressure).
//
// Query blocks run longest first (see Order), so that under a causal mask the
// long rows do not trail the grid. Tiles past a warp's last visible key are skipped
// (the block stages up to its last warp's end), which is exact: each row
// sees key 0 in tile 0, so its running max is finite from then on and a
// fully masked tile would add exp(-1e30 - m) = 0. Tiles wholly visible to a
// warp's rows skip the mask. Keys past n_keys (a ragged edge) score -inf,
// and their zero-filled V rows add nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"

namespace tile {

constexpr float LOG2E = 1.4426950408889634f;

// storage traits: shared-memory row padding (elements), element loads and
// stores
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int KPAD = 8;  // Q and K rows: 8-byte pair loads, rows g
  static constexpr int VPAD = 4;  // V rows: 4-byte loads, rows 2c and 2c + 1
  static constexpr bool HAS_LO = true;
  __device__ static float2 pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
  __device__ static float one(const float* p) { return *p; }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int KPAD = 8;
  static constexpr int VPAD = 8;
  static constexpr bool HAS_LO = false;  // a bf16 value is exactly a tf32
  __device__ static float2 pair(const __nv_bfloat16* p) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  }
  __device__ static float one(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// Block geometry. Shared memory: Q [ROWS][D + KPAD], two stages of
// K [BK][D + KPAD] and V [BK][D + VPAD]. At D = 128, f32: 101 KB (two blocks
// an SM); at D = 256: 197 KB.
template <typename T, int D>
struct Config {
  static constexpr int WARPS = 4;
  static constexpr int NT = WARPS * 32;
  static constexpr int ROWS = WARPS * 16;  // query rows per block
  static constexpr int BK = 32;            // keys per tile
  static constexpr int QS = D + Elem<T>::KPAD;  // Q and K row stride, elements
  static constexpr int VS = D + Elem<T>::VPAD;  // V row stride
  static constexpr size_t SMEM =
      ((size_t)(ROWS + 2 * BK) * QS + (size_t)2 * BK * VS) * sizeof(T);
  static_assert(SMEM <= 232448, "gqa_tile: shared memory past 227 KB");
};

// a tile-loop kernel's launch attributes, set once: its dynamic shared
// memory (above 48 KB a launch must opt in) and the largest shared-memory
// carveout, so that two blocks fit an SM
template <typename Kernel>
inline int opt_in(Kernel kernel, size_t smem) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

// query blocks of 64 rows
inline int row_blocks(int n_rows) { return (n_rows + 63) / 64; }

// Block order. The grid is flat over (query block, batch row x head) and
// takes the items longest first (under a causal or positional mask the last
// query block sees the most keys). When the whole grid is resident at once,
// the blocks past one an SM take the items shortest first instead, so that
// each SM's second block is the complement of its first; with at most one
// block an SM, a head's query blocks run on neighbouring SMs (head-major).
// Each was the fastest of the three where it is taken, measured on the H100
// (PERF.md: the flash kernel at B2 S512, two blocks an SM, and B1 S2048, two
// waves; the GQA prefill at B1 S512, one block an SM). `first` blocks take
// the items longest first; first < 0 means head-major.
struct Order {
  int n_bh, nqb, first;
  __device__ void item(int block, int& bh, int& rank) const {
    if (first < 0) {
      bh = block / nqb;
      rank = block % nqb;  // 0: the longest query block
      return;
    }
    const int j = block < first ? block : nqb * n_bh - 1 - (block - first);
    bh = j % n_bh;
    rank = j / n_bh;
  }
};

// the card's SMs and how many blocks of `kernel` (nt threads, smem bytes of
// dynamic shared memory, already opted in) it holds at once
template <typename Kernel>
inline int residency(Kernel kernel, int nt, size_t smem, int& sms, int& resident) {
  int dev = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt, smem);
  resident = per_sm * sms;
  return (int)e;
}

// the Order of a grid of n_bh x row_blocks(n_rows) blocks
inline Order order(int sms, int resident, int n_bh, int n_rows) {
  const int nqb = row_blocks(n_rows), n = nqb * n_bh;
  return Order{n_bh, nqb, n <= sms ? -1 : n <= resident ? sms : n};
}

// V fragments a P.V pass takes at a time: the largest divisor of the
// head dim's 8-dim groups up to 8 (14 groups at D = 112: 7), so that the
// passes cover the groups exactly
__host__ __device__ constexpr int pv_group(int nd) {
  for (int g = 8; g > 1; --g)
    if (nd % g == 0) return g;
  return 1;
}

// masks: the last visible key of a query row
struct Causal {
  __device__ int limit(int row) const { return row; }
};
struct Full {
  __device__ int limit(int) const { return INT_MAX; }
};
struct Positions {
  const int* pos;  // this batch row's (S,) positions
  __device__ int limit(int row) const { return pos[row]; }
};

// a = hi + lo, both tf32 rounded to nearest, ties away from zero (what
// cvt.rna.tf32.f32 gives on finite values, in 4 integer and float
// operations where nvcc's cvt takes 3 and an infinity check): adding half a
// tf32 ulp (0x1000) to the f32 bits and letting the MMA drop the low 13 bits
// rounds the magnitude half away from zero; hi's exact value (the low bits
// cleared) gives lo = a - hi exactly. With HAS_LO false the value is already
// a tf32 (bf16).
template <bool HAS_LO>
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  if (HAS_LO) {
    hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(a - __uint_as_float(hi)) + 0x1000u;
  } else {
    hi = __float_as_uint(a);
    lo = 0u;
  }
}

// 2^x on the SFU (rel. error about 2^-22), -inf -> 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One block: query rows [q0, q0 + ROWS) of one (batch row, head), with
// q0 = (n_blocks - 1 - block) * ROWS (block 0 the longest). Row i of the head is at
// qg + i * q_stride (and og + i * q_stride), key j at kg / vg + j * kv_stride.
// n_rows query rows and n_keys keys exist.
template <typename T, int D, typename Mask>
__device__ __forceinline__ void attend(const T* __restrict__ qg, const T* __restrict__ kg,
                                       const T* __restrict__ vg, T* __restrict__ og,
                                       size_t q_stride, size_t kv_stride, int block,
                                       int n_blocks, int n_rows, int n_keys, const Mask& mask,
                                       float scale) {
  using C = Config<T, D>;
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(C::ROWS == 64, "row_blocks takes 64 rows a block");
  constexpr int WARPS = C::WARPS, NT = C::NT, BK = C::BK, ROWS = C::ROWS;
  constexpr int QS = C::QS, VS = C::VS;
  constexpr int CH = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr bool LO = Elem<T>::HAS_LO;
  constexpr int NK = BK / 8;          // 8-key groups per tile
  constexpr int ND = D / 8;           // 8-dim groups
  constexpr int NG = pv_group(ND);    // V fragments split per P.V pass
  static_assert(ND % NG == 0 && NG <= 8, "the P.V passes must cover the 8-dim groups exactly");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [ROWS][QS]
  T* ks = qs + ROWS * QS;                   // [2][BK][QS]
  T* vs = ks + 2 * BK * QS;                 // [2][BK][VS]
  __shared__ int warp_end[WARPS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int q0 = (n_blocks - 1 - block) * ROWS;

  // rows [row0, row0 + n) of a (rows, D) view into dst (row stride `str`),
  // zero-filled at or past `limit`
  auto stage = [&](T* dst, const T* src, int row0, int n, int limit, size_t stride, int str) {
    for (int i = tid; i < n * (D / CH); i += NT) {
      const int r = i / (D / CH), col = (i % (D / CH)) * CH;
      const int gr = row0 + r;
      const bool ok = gr < limit;
      attn::cp_async16(dst + r * str + col, src + (size_t)(ok ? gr : 0) * stride + col, ok);
    }
  };
  stage(qs, qg, q0, ROWS, n_rows, q_stride, QS);
  stage(ks, kg, 0, BK, n_keys, kv_stride, QS);
  stage(vs, vg, 0, BK, n_keys, kv_stride, VS);
  attn::cp_async_commit();

  // this thread's rows (warp-local g and g + 8) and their last visible keys;
  // rows past n_rows are not written and take no part in the tile ranges
  const int wr = warp * 16;
  int lim[2];
  bool valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    valid[i] = row < n_rows;
    lim[i] = valid[i] ? mask.limit(row) : INT_MAX;
  }
  // the warp's key range: every key if a row sees none (uniform softmax),
  // else up to its rows' last visible key; and the keys all its rows see
  int hi_lim = INT_MIN, lo_lim = INT_MAX, any_valid = 0, any_neg = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (valid[i]) {
      hi_lim = max(hi_lim, lim[i]);
      lo_lim = min(lo_lim, lim[i]);
      any_valid = 1;
      any_neg |= lim[i] < 0;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hi_lim = max(hi_lim, __shfl_xor_sync(0xffffffffu, hi_lim, o));
    lo_lim = min(lo_lim, __shfl_xor_sync(0xffffffffu, lo_lim, o));
    any_valid |= __shfl_xor_sync(0xffffffffu, any_valid, o);
    any_neg |= __shfl_xor_sync(0xffffffffu, any_neg, o);
  }
  const int k_end = !any_valid ? 0 : (any_neg || hi_lim >= n_keys) ? n_keys : hi_lim + 1;
  if (lane == 0) warp_end[warp] = k_end;
  __syncthreads();
  int block_end = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) block_end = max(block_end, warp_end[w]);
  const int n_tiles = (block_end + BK - 1) / BK;

  // scores in base-2 units (scale * log2 e folded in); the mask value stays
  // -1e30, far below any score in either unit
  const float scale2 = scale * LOG2E;
  float o[ND][4], m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  // Q's fragments (rows g, g + 8 at dims 8k + 2c, + 1). Up to D = 128 they
  // are split once: hi stays in registers (ND x 4) and lo goes to shared
  // memory in fragment order, over the raw rows once every warp has read
  // them; at D = 256 hi and O would not fit the registers, and each tile
  // splits the raw rows again
  constexpr bool QREG = LO && D <= 128;
  static_assert(!QREG || (size_t)ROWS * QS * sizeof(T) >= (size_t)WARPS * ND * 32 * sizeof(uint4),
                "Q's lo fragments are stashed over the raw Q rows");
  const T* qa = qs + (wr + g) * QS + 2 * c;
  uint4* qlo = reinterpret_cast<uint4*>(smem_raw) + warp * ND * 32 + lane;
  uint32_t qhi[QREG ? ND : 1][4];
  if constexpr (QREG) {
    attn::cp_async_wait_all();
    __syncthreads();
    uint4 lo[ND];
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const float2 x0 = Elem<T>::pair(qa + 8 * kk), x1 = Elem<T>::pair(qa + 8 * QS + 8 * kk);
      split<LO>(x0.x, qhi[kk][0], lo[kk].x);
      split<LO>(x1.x, qhi[kk][1], lo[kk].y);
      split<LO>(x0.y, qhi[kk][2], lo[kk].z);
      split<LO>(x1.y, qhi[kk][3], lo[kk].w);
    }
    __syncthreads();
    if (LO) {  // bf16 has no lo (and its raw Q rows are too small to hold one)
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) qlo[kk * 32] = lo[kk];
    }
  }
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1;
      stage(ks + nb * BK * QS, kg, (t + 1) * BK, BK, n_keys, kv_stride, QS);
      stage(vs + nb * BK * VS, vg, (t + 1) * BK, BK, n_keys, kv_stride, VS);
    }
    attn::cp_async_commit();
    attn::cp_async_wait_one();  // this tile's copies (and Q) have landed
    __syncthreads();

    const int k0 = t * BK;
    if (k0 < k_end) {  // warp-uniform
      const T* kt = ks + (t & 1) * BK * QS + g * QS + 2 * c;
      const T* vt = vs + (t & 1) * BK * VS + 2 * c * VS + g;

      // S = Q K^T: 16 rows x BK keys per warp; the 3xTF32 terms in two
      // accumulators (hi.hi, and the cross terms, summed in at the end)
      float s[NK][4], sx[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = sx[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        uint32_t ahi[4], alo[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ahi[e] = qhi[kk][e];
          if (LO) {
            const uint4 l4 = qlo[kk * 32];
            alo[0] = l4.x, alo[1] = l4.y, alo[2] = l4.z, alo[3] = l4.w;
          }
        } else {
          const float2 x0 = Elem<T>::pair(qa + 8 * kk);
          const float2 x1 = Elem<T>::pair(qa + 8 * QS + 8 * kk);
          split<LO>(x0.x, ahi[0], alo[0]);
          split<LO>(x1.x, ahi[1], alo[1]);
          split<LO>(x0.y, ahi[2], alo[2]);
          split<LO>(x1.y, ahi[3], alo[3]);
        }
        uint32_t bh[NK][2], bl[NK][2];
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float2 kv = Elem<T>::pair(kt + 8 * n * QS + 8 * kk);
          split<LO>(kv.x, bh[n][0], bl[n][0]);
          split<LO>(kv.y, bh[n][1], bl[n][1]);
        }
        if (LO) {
#pragma unroll
          for (int n = 0; n < NK; ++n) mma(sx[n], ahi, bl[n][0], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NK; ++n) mma(s[n], ahi, bh[n][0], bh[n][1]);
        if (LO) {
#pragma unroll
          for (int n = 0; n < NK; ++n) mma(sx[n], alo, bh[n][0], bh[n][1]);
        }
      }
      if (LO) {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += sx[n][e];
      }

      // mask, online softmax (row i of this thread: s[n][2i], s[n][2i + 1])
      const bool whole = k0 + BK - 1 <= lo_lim && k0 + BK <= n_keys;  // warp-uniform
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale2;
          if (!whole) {
            const int key = k0 + 8 * n + 2 * c + (e & 1);
            if (key >= n_keys) {
              x = -INFINITY;  // past the end: the key does not exist
            } else if (key > lim[e >> 1]) {
              x = attn::NEG_INF_MASK;
            }
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // finite from the warp's first tile on: key 0 exists and scores at
        // least -1e30
        const float m_new = fmaxf(m_run[i], quad_max(mx[i]));
        alpha[i] = exp2_approx(m_run[i] - m_new);
        m_run[i] = m_new;
        l_part[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(s[n][e] - m_run[e >> 1]);
          s[n][e] = p;
          l_part[e >> 1] += p;
        }
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V: P's A column c is key 2c, column c + 4 key 2c + 1. V is
      // split NG output groups at a time, and each of the three passes runs
      // over the NG accumulators (the small terms first)
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t phi[4], plo[4];
        split<true>(s[j][0], phi[0], plo[0]);
        split<true>(s[j][2], phi[1], plo[1]);
        split<true>(s[j][1], phi[2], plo[2]);
        split<true>(s[j][3], phi[3], plo[3]);
        const T* vj = vt + 8 * j * VS;
#pragma unroll
        for (int n0 = 0; n0 < ND; n0 += NG) {
          uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
          for (int u = 0; u < NG; ++u) {
            split<LO>(Elem<T>::one(vj + 8 * (n0 + u)), bh[u][0], bl[u][0]);
            split<LO>(Elem<T>::one(vj + VS + 8 * (n0 + u)), bh[u][1], bl[u][1]);
          }
          if (LO) {
#pragma unroll
            for (int u = 0; u < NG; ++u) mma(o[n0 + u], phi, bl[u][0], bl[u][1]);
          }
#pragma unroll
          for (int u = 0; u < NG; ++u) mma(o[n0 + u], plo, bh[u][0], bh[u][1]);
#pragma unroll
          for (int u = 0; u < NG; ++u) mma(o[n0 + u], phi, bh[u][0], bh[u][1]);
        }
      }
    }
    __syncthreads();  // the next stage overwrites this K/V buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_sum = quad_sum(l_part[i]);
    if (!valid[i]) continue;
    const float inv = 1.f / (l_sum == 0.f ? 1.f : l_sum);
    T* out = og + (size_t)(q0 + wr + g + 8 * i) * q_stride + 2 * c;
#pragma unroll
    for (int n = 0; n < ND; ++n) Elem<T>::store2(out + 8 * n, o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

}  // namespace tile
