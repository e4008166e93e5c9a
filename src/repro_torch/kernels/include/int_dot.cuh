// The integer main loops of the fused dot+AF kernel
// (cordic_fused/csrc/cordic_fused.cu) and the MAC-array matmul
// (cordic_mac/csrc/cordic_mac.cu) that do not run on the int8 wgmma path
// (include/int8_wgmma.cuh): the narrow loop for M <= 16 rows of int8
// operands (decode and the 16-row serving bucket), and the CUDA-core loop
// for int16 operands (FxP16) at any M. Both read the weight bank K-major:
// column n of the (K, N) bank is a row of K values at w + n * ldw.
//
// Sums accumulate in 32 bits with two's-complement wrap, like XLA's int32
// dot_general. Integer sums are order independent: tiling K and splitting it
// across blocks changes no bit. When the grid splits K (gridDim.y > 1) each
// block of an output tile stores its partial sums to its own slice of a
// uint32 workspace (splits x M x N); the last block to arrive (a per-tile
// counter says which, and that block sets it back to zero for the next
// launch) adds up the slices, wrapping and order free, and alone runs the
// caller's epilogue (`epi.finish(gm, gn, epi.prepare(gm, gn, acc))`).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// narrow loop: int8, M <= 16
//
// Bound by the weight bytes. Each warp owns 16 bank columns and streams
// them along K with 16-byte loads (every weight byte read once, L1 bypassed),
// eight warps side by side over one K range per block. The products run on
// the tensor cores through mma.sync.m16n8k32.s8 with the weights as the A
// operand (16 columns x 32 of K) and x as B (32 of K x 8 rows), so M is the
// narrow side. A thread's 16 bytes of one column cover two MMAs: the K order
// inside an MMA is permuted identically for A and B, which an integer sum
// does not see. x is staged once per block in shared memory as int8 (the
// fused kernel quantizes it on the way in).
// ---------------------------------------------------------------------------

constexpr int NW_BN = 128, NW_THREADS = 256, NW_KSTEP = 64, NW_UNROLL = 4;
constexpr int NW_MAX_KPS = 2048;  // K per block; the host's plan keeps to it

// shared bytes of the x tile: MT*8 rows of k_per_split (+ 64 to spread banks),
// within the default 48 KB of dynamic shared memory for MT <= 2
__host__ __device__ constexpr int narrow_smem(int mt, int k_per_split) {
  return mt * 8 * (k_per_split + 64);
}
static_assert(narrow_smem(2, NW_MAX_KPS) <= 48 * 1024, "the x tile needs no opt-in");

__device__ __forceinline__ int4 ldg_stream16(const int8_t* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// c (16 x 8, s32) += a (16 x 32, s8, row) . b (32 x 8, s8, col); wraps
__device__ __forceinline__ void mma_s8_16832(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                             int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One block: bank columns [blockIdx.x * 128, +128) x all M (<= MT * 8) rows
// over K [blockIdx.y * k_per_split, +k_per_split). `xload(gm, gk)` returns
// the int8 x operand of an in-range element, `xload.quad(gm, gk)` those of
// gk..gk+3 packed into a word (byte e = element gk + e).
template <int MT, typename XLoad, typename Epi>
__device__ __forceinline__ void int8_narrow_tile(const XLoad& xload,
                                                 const int8_t* __restrict__ w, int ldw,
                                                 const Epi& epi, unsigned* __restrict__ ws,
                                                 int* __restrict__ tile_count, int M, int N,
                                                 int K, int k_per_split) {
  extern __shared__ __align__(16) int8_t nw_xs[];
  __shared__ int last_block;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * NW_BN;
  const int k0 = blockIdx.y * k_per_split, k1 = min(K, k0 + k_per_split);
  const int xld = k_per_split + 64;

  const int g = lane / 4, q = lane % 4;
  const int na = n0 + warp * 16 + g, nb = na + 8;
  const bool oka = na < N, okb = nb < N;
  const int8_t* wa = w + (size_t)(oka ? na : 0) * ldw;
  const int8_t* wb = w + (size_t)(okb ? nb : 0) * ldw;
  // one step of the stream: NW_UNROLL chunks of 16 bytes along K from each
  // of the thread's two columns. A chunk that starts below K lies inside the
  // row's padded stride; its bytes past K meet zeros in the x tile.
  auto load = [&](int kb, int4 (&lo)[NW_UNROLL], int4 (&hi)[NW_UNROLL]) {
#pragma unroll
    for (int u = 0; u < NW_UNROLL; ++u) {
      const int k = kb + u * NW_KSTEP + q * 16;
      lo[u] = (oka && k < k1) ? ldg_stream16(wa + k) : make_int4(0, 0, 0, 0);
      hi[u] = (okb && k < k1) ? ldg_stream16(wb + k) : make_int4(0, 0, 0, 0);
    }
  };
  int4 alo[NW_UNROLL], ahi[NW_UNROLL];
  load(k0, alo, ahi);  // the first weights stream in while x is staged

  // x tile, four bytes a step: rows < M from x, the rest (and columns past
  // K) zero
  const int quads = k_per_split / 4, filled = M * quads;
  for (int i = tid; i < MT * 8 * quads; i += NW_THREADS) {
    const int r = i / quads, c = (i - r * quads) * 4, gk = k0 + c;
    unsigned v = 0u;
    if (i < filled) {
      if (gk + 3 < k1) {
        v = xload.quad(r, gk);
      } else {
        for (int e = 0; e < 4 && gk + e < k1; ++e)
          v |= ((unsigned)xload(r, gk + e) & 0xFFu) << (8 * e);
      }
    }
    *reinterpret_cast<unsigned*>(nw_xs + r * xld + c) = v;
  }
  __syncthreads();

  int acc[MT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0;

  for (int kb = k0; kb < k1; kb += NW_KSTEP * NW_UNROLL) {
    if (kb > k0) load(kb, alo, ahi);
#pragma unroll
    for (int u = 0; u < NW_UNROLL; ++u) {
      if (kb + u * NW_KSTEP >= k1) break;
      const int kx = kb - k0 + u * NW_KSTEP + q * 16;
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const int4 b = *reinterpret_cast<const int4*>(nw_xs + (t * 8 + g) * xld + kx);
        mma_s8_16832(acc[t], alo[u].x, ahi[u].x, alo[u].y, ahi[u].y, b.x, b.y);
        mma_s8_16832(acc[t], alo[u].z, ahi[u].z, alo[u].w, ahi[u].w, b.z, b.w);
      }
    }
  }

  // acc[t][e]: column (e < 2 ? na : nb), row t*8 + 2q + (e & 1)
  if (gridDim.y > 1) {
    unsigned* mine = ws + (size_t)blockIdx.y * M * N;
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = t * 8 + 2 * q + (e & 1), gn = e < 2 ? na : nb;
        if (gm < M && gn < N) __stcg(mine + (size_t)gm * N + gn, (unsigned)acc[t][e]);
      }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last_block = (atomicAdd(tile_count + blockIdx.x, 1) == (int)gridDim.y - 1);
      if (last_block) tile_count[blockIdx.x] = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    for (int i = tid; i < M * NW_BN; i += NW_THREADS) {
      const int gm = i / NW_BN, gn = n0 + i % NW_BN;
      if (gn >= N) continue;
      unsigned sum = 0u;
      for (int sp = 0; sp < (int)gridDim.y; ++sp)
        sum += __ldcg(ws + ((size_t)sp * M + gm) * N + gn);
      epi.finish(gm, gn, epi.prepare(gm, gn, (int)sum));
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gm = t * 8 + 2 * q + (e & 1), gn = e < 2 ? na : nb;
      if (gm < M && gn < N) epi.finish(gm, gn, epi.prepare(gm, gn, acc[t][e]));
    }
}

// m-tiles of 8 rows for M <= 16 (the host's plan.config). Returns a
// cudaError_t code: M must fit the tiles, K a block the shared x tile.
template <template <int> class Kernel, typename... Args>
int dispatch_narrow(int mt, int M, int N, int splits, int k_per_split, cudaStream_t stream,
                    Args... args) {
  if (mt < 1 || mt > 2 || M > mt * 8 || k_per_split > NW_MAX_KPS || k_per_split % 128)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + NW_BN - 1) / NW_BN, splits, 1);
  if (mt == 1)
    Kernel<1>::launch(grid, narrow_smem(1, k_per_split), stream, args...);
  else
    Kernel<2>::launch(grid, narrow_smem(2, k_per_split), stream, args...);
  return 0;
}

// ---------------------------------------------------------------------------
// CUDA-core loop: int16 operands (FxP16), any M
//
// Thread (tx, ty) of the tile owns rows ty + i*TY and columns tx + j*TX,
// with TX = BN / TN and TY = BM / TM; operands are staged as int32 in shared
// memory and multiplied on the CUDA cores (IMAD). The bank tile is read
// along K with 16-byte loads.
// ---------------------------------------------------------------------------

template <typename T> struct Vec16;  // elements of T in one 16-byte load
template <> struct Vec16<int8_t> { static constexpr int N = 16; };
template <> struct Vec16<int16_t> { static constexpr int N = 8; };

template <typename WT, int BM, int BN, int BK, int TM, int TN, typename XLoad>
__device__ __forceinline__ bool int_dot_tile(unsigned (&acc)[TM][TN], const XLoad& xload,
                                             const WT* __restrict__ w, int ldw,
                                             unsigned* __restrict__ ws,
                                             int* __restrict__ tile_count, int M, int N,
                                             int K, int k_per_split) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  constexpr int VEC = Vec16<WT>::N, KV = BK / VEC;
  static_assert(BK % VEC == 0, "a K tile holds whole 16-byte vectors");
  __shared__ int xs[BK][BM + 1];
  __shared__ int wsm[BK][BN + 1];
  __shared__ int last_block;

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * BM;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // x tile (BM x BK), stored transposed
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < k_end) ? xload(gm, gk) : 0;
    }
    // bank tile (BK x BN): one 16-byte load of a column along K per step; a
    // vector that starts below K lies inside the padded stride
    for (int i = tid; i < BN * KV; i += NT) {
      const int c = i / KV, r = (i % KV) * VEC;
      const int gk = k0 + r, gn = n0 + c;
      int4 raw = make_int4(0, 0, 0, 0);
      if (gn < N && gk < k_end) raw = *reinterpret_cast<const int4*>(w + (size_t)gn * ldw + gk);
      const unsigned words[4] = {(unsigned)raw.x, (unsigned)raw.y, (unsigned)raw.z,
                                 (unsigned)raw.w};
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        int v;
        if constexpr (sizeof(WT) == 1) {
          v = (int)(signed char)(words[e / 4] >> (8 * (e % 4)));
        } else {
          v = (int)(short)(words[e / 2] >> (16 * (e % 2)));
        }
        wsm[r + e][c] = (gk + e < k_end) ? v : 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      unsigned a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = (unsigned)xs[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = (unsigned)wsm[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  if (gridDim.y == 1) return true;
  // split K: store this block's partial sums to its slice; the last block of
  // the output tile adds up the slices
  unsigned* mine = ws + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + ty + i * TY, gn = n0 + tx + j * TX;
      if (gm < M && gn < N) __stcg(mine + (size_t)gm * N + gn, acc[i][j]);
    }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int tile = blockIdx.z * gridDim.x + blockIdx.x;
    last_block = (atomicAdd(tile_count + tile, 1) == (int)gridDim.y - 1);
    if (last_block) tile_count[tile] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last_block) return false;
  __threadfence();
  for (int sp = 0; sp < (int)gridDim.y; ++sp) {
    if (sp == (int)blockIdx.y) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gm = m0 + ty + i * TY, gn = n0 + tx + j * TX;
        if (gm < M && gn < N) acc[i][j] += __ldcg(ws + ((size_t)sp * M + gm) * N + gn);
      }
  }
  return true;
}

// The CUDA-core loop's epilogue over a thread's TM x TN outputs.
template <int BM, int BN, int TM, int TN, typename Epi>
__device__ __forceinline__ void int_dot_store(const unsigned (&acc)[TM][TN], const Epi& epi,
                                              int M, int N) {
  constexpr int TX = BN / TN, TY = BM / TM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * BM;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + ty + i * TY, gn = n0 + tx + j * TX;
      if (gm < M && gn < N) epi.finish(gm, gn, epi.prepare(gm, gn, (int)acc[i][j]));
    }
}

// The CUDA-core loop's three tile configurations (BM, BN, BK, TM, TN),
// picked by the host's plan (kernels/int_dot.py) from M, and the launch that
// instantiates them. `Kernel` is a functor template:
// Kernel<BM, BN, BK, TM, TN>::launch(grid, block, stream, args...) launches
// the caller's __global__ instantiation.
template <template <int, int, int, int, int> class Kernel, typename... Args>
void dispatch_tiles(int config, int M, int N, int splits, cudaStream_t stream, Args... args) {
  switch (config) {
    case 0:  // decode: M <= 8
      Kernel<8, 128, 32, 1, 4>::launch(dim3((N + 127) / 128, splits, (M + 7) / 8), dim3(256),
                                       stream, args...);
      break;
    case 1:  // small blocks: M <= 32
      Kernel<32, 128, 32, 4, 4>::launch(dim3((N + 127) / 128, splits, (M + 31) / 32),
                                        dim3(256), stream, args...);
      break;
    default:  // prefill buckets
      Kernel<128, 128, 16, 8, 8>::launch(dim3((N + 127) / 128, splits, (M + 127) / 128),
                                         dim3(256), stream, args...);
      break;
  }
}

}  // namespace
