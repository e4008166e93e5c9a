// Fused prepared CORDIC dot + activation epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cordic_fused/kernel.py:fused_kernel
// (pallas_call built in repro/kernels/cordic_fused/ops.py:_grid_call, entry
// fused_dot_af). Per output element it computes, bit for bit:
//   1. quantize x onto the FxP grid: round half to even, clip to [qmin, qmax]
//      from the params vector (NaN -> 0, as JAX's saturating cast);
//   2. read the prepared signed-digit weight integers (int8 at FxP8, int16 at
//      FxP16; the TPU kernel recovered them from an f32 grid);
//   3. exact int32 dot, wrapping modulo 2^32 like XLA's int32 dot_general
//      (integer sums are order independent, so tiling K, splitting it across
//      blocks and the tensor cores' order change no bit);
//   4. descale (acc * 2^-x_frac) * 2^-w_frac with exact powers of two;
//   5. optional bf16 round;
//   6. the CORDIC activation picked at run time by `mode` (an index into
//      FUSED_AFS), on the guard-bit internal format, as core/activations.py
//      computes it.
//
// The execution point (depth, x_frac, qmin, qmax, w_frac) is read at run time
// from the device vector `point`, so a new point reuses the same launch and
// rebuilds nothing. The AF mode is a plain launch argument, not params[5] of
// a device vector as on the TPU: there af_mode is a static argument of the
// jitted wrapper and rides the params vector only so that one compiled Pallas
// kernel serves every mode, which a CUDA launch argument gives for free. The
// mode belongs to the call site (gate -> swish, the rest identity), never to
// the execution point, so a captured CUDA graph may freeze it; the point must
// stay a device vector that a graph reads on replay.
//
// The bank is K-major: column n of the (K, N) weight is a row of K integers
// at w + n * ldw, ldw * sizeof(WT) a multiple of 16 bytes. Three paths,
// chosen by the host's plan (kernels/int_dot.py):
//
// * int8 bank, M > 16 (prefill): bound by the int8 multiply-adds (1,979
//   T op/s on the tensor cores). A small pass quantizes x once per call to
//   int8 (M, ldq) (fused_quantize_x_kernel), then fused_dot_af_wgmma_kernel
//   runs the TMA + wgmma loop of include/int8_wgmma.cuh (128 x 128 or
//   128 x 256 tiles) and the epilogue straight from its accumulator
//   fragments. Quantizing inside the loop would repeat it for each column
//   block.
// * int8 bank, M <= 16 (decode, the 16-row bucket): bound by the weight bytes
//   (a 2048 x 8192 bank is 16.8 MB, >= 5 us at 3.35 TB/s).
//   fused_dot_af_narrow_kernel streams every bank byte once with 16-byte
//   loads and multiplies on the tensor cores through mma.sync (the narrow
//   loop of include/int_dot.cuh); each block quantizes its K range of x into
//   shared memory, and K is split across blocks where columns are few.
// * int16 bank (FxP16), any M: fused_dot_af_imad_kernel, the int32 CUDA-core
//   loop of include/int_dot.cuh on the K-major bank. (Tensor cores through
//   int8 limbs are later work.)
//
// An int8 path needs the point's x grid inside int8; make_point pairs every
// int8 bank with such a grid, and a point that is not traps rather than wrap
// silently.
//
// Tensor-parallel serving splits K of a row-parallel product (wo, down)
// across ranks. The epilogue must then run on the sum of the ranks' int32
// dots, not on each rank's: a float sum of descaled partials is not bitwise
// (the int32 -> f32 conversion rounds above 2^24), while int32 sums wrap the
// same modulo 2^32 in any order. So each path also has a partial-sum
// instantiation (PARTIAL = true, entry cordic_fused_partial_launch) that
// stores the int32 accumulator and skips the epilogue, and
// fused_epilogue_kernel (entry cordic_fused_epilogue_launch) applies the
// point's descale, the bf16 round and the AF to the reduced int32 sums: an
// elementwise pass bound by its 8 bytes an element (and, past identity, the
// AF's int32 work). It replaces no TPU kernel of its own: on the TPU, GSPMD
// ran the reference's XLA chain under a mesh. Both epilogues come from
// include/fused_epilogue.cuh, which the fused kernels use too.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cordic_af.cuh"
#include "fused_epilogue.cuh"
#include "int8_wgmma.cuh"
#include "int_dot.cuh"

namespace {

using fused::P_XFRAC;
using fused::P_XQMAX;
using fused::P_XQMIN;
enum Path { NARROW = 0, WGMMA = 1, IMAD = 2 };

// The block's epilogue: the fused one (descale + AF into f32 `out`), or with
// PARTIAL the int32 accumulator into int32 `out`.
template <bool PARTIAL>
struct EpiOf {
  using type = fused::Epilogue;
  static __device__ __forceinline__ type make(int* tab, const int* af_tab, const int* point,
                                              void* out, int N, int mode, int compute_round) {
    return fused::make_epilogue(tab, af_tab, point, static_cast<float*>(out), N, mode,
                                compute_round);
  }
};
template <>
struct EpiOf<true> {
  using type = fused::PartialEpilogue;
  static __device__ __forceinline__ type make(int*, const int*, const int*, void* out, int N,
                                              int, int) {
    return fused::PartialEpilogue{static_cast<int*>(out), N};
  }
};

// quantize x onto the FxP grid on its way into a tile
struct QuantizeX {
  const float* __restrict__ x;
  int K, qmin, qmax;
  float scale;
  __device__ __forceinline__ int q(float v) const {
    return clampi(__float2int_rn(v * scale), qmin, qmax);
  }
  __device__ __forceinline__ int operator()(int gm, int gk) const {
    return q(x[(size_t)gm * K + gk]);
  }
  // elements gk..gk+3 (all below K) as int8 bytes of a word
  __device__ __forceinline__ unsigned quad(int gm, int gk) const {
    const float* p = x + (size_t)gm * K + gk;
    const float4 f = (K & 3) == 0 ? *reinterpret_cast<const float4*>(p)
                                  : make_float4(p[0], p[1], p[2], p[3]);
    return ((unsigned)q(f.x) & 0xFFu) | ((unsigned)q(f.y) & 0xFFu) << 8 |
           ((unsigned)q(f.z) & 0xFFu) << 16 | ((unsigned)q(f.w) & 0xFFu) << 24;
  }
};

__device__ __forceinline__ QuantizeX quantize_x(const float* x, const int* __restrict__ point,
                                                int K, bool to_int8) {
  const int qmin = point[P_XQMIN], qmax = point[P_XQMAX];
  if (to_int8 && (qmin < -128 || qmax > 127)) __trap();
  return QuantizeX{x, K, qmin, qmax, pow2f(point[P_XFRAC])};
}

// ----- int8, M > 16: quantize pass + wgmma ---------------------------------

// x (M, K) f32 -> int8 (M, ldq), ldq a multiple of 16; columns K..ldq zero
__global__ void __launch_bounds__(256)
fused_quantize_x_kernel(const float* __restrict__ x, const int* __restrict__ point,
                        int8_t* __restrict__ xq, int M, int K, int ldq) {
  const QuantizeX qx = quantize_x(x, point, K, true);
  const int per_row = ldq / 4;
  const long long total = (long long)M * per_row;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int m = (int)(i / per_row), k = (int)(i % per_row) * 4;
    unsigned v = 0u;
    if (k + 3 < K) {
      v = qx.quad(m, k);
    } else {
      for (int e = 0; e < 4 && k + e < K; ++e) v |= ((unsigned)qx(m, k + e) & 0xFFu) << (8 * e);
    }
    *reinterpret_cast<unsigned*>(xq + (size_t)m * ldq + k) = v;
  }
}

template <int BN, bool PARTIAL>
__global__ void __launch_bounds__(WG_THREADS, 1)
fused_dot_af_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb, const int* __restrict__ point,
                          const int* __restrict__ af_tab, void* __restrict__ out, int M, int N,
                          int K, int mode, int compute_round) {
  __shared__ int tab[AF_TAB_LEN];
  const auto epi = EpiOf<PARTIAL>::make(tab, af_tab, point, out, N, mode, compute_round);
  int8_wgmma_tile<BN>(&ta, &tb, epi, M, N, K);
}

// ----- int8, M <= 16: narrow loop ------------------------------------------

template <int MT, bool PARTIAL>
__global__ void __launch_bounds__(NW_THREADS)
fused_dot_af_narrow_kernel(const float* __restrict__ x, const int8_t* __restrict__ w, int ldw,
                           const int* __restrict__ point, const int* __restrict__ af_tab,
                           void* __restrict__ out, unsigned* __restrict__ ws,
                           int* __restrict__ tile_count, int M, int N, int K, int k_per_split,
                           int mode, int compute_round) {
  __shared__ int tab[AF_TAB_LEN];
  const auto epi = EpiOf<PARTIAL>::make(tab, af_tab, point, out, N, mode, compute_round);
  int8_narrow_tile<MT>(quantize_x(x, point, K, true), w, ldw, epi, ws, tile_count, M, N, K,
                       k_per_split);
}

template <bool PARTIAL>
struct Narrow {
  template <int MT>
  struct Launch {
    static void launch(dim3 grid, int smem, cudaStream_t stream, const float* x, const void* w,
                       int ldw, const int* point, const int* af_tab, void* out, unsigned* ws,
                       int* tile_count, int M, int N, int K, int k_per_split, int mode,
                       int compute_round) {
      fused_dot_af_narrow_kernel<MT, PARTIAL><<<grid, NW_THREADS, smem, stream>>>(
          x, static_cast<const int8_t*>(w), ldw, point, af_tab, out, ws, tile_count, M, N, K,
          k_per_split, mode, compute_round);
    }
  };
};

// ----- int16: CUDA-core loop -----------------------------------------------

template <typename WT, int BM, int BN, int BK, int TM, int TN, bool PARTIAL>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
fused_dot_af_imad_kernel(const float* __restrict__ x, const WT* __restrict__ w, int ldw,
                         const int* __restrict__ point, const int* __restrict__ af_tab,
                         void* __restrict__ out, unsigned* __restrict__ ws,
                         int* __restrict__ tile_count, int M, int N, int K, int k_per_split,
                         int mode, int compute_round) {
  __shared__ int tab[AF_TAB_LEN];
  const auto epi = EpiOf<PARTIAL>::make(tab, af_tab, point, out, N, mode, compute_round);
  __syncthreads();
  unsigned acc[TM][TN];
  if (!int_dot_tile<WT, BM, BN, BK, TM, TN>(acc, quantize_x(x, point, K, false), w, ldw, ws,
                                             tile_count, M, N, K, k_per_split))
    return;
  int_dot_store<BM, BN, TM, TN>(acc, epi, M, N);
}

template <typename WT, bool PARTIAL>
struct ImadLaunch {
  template <int BM, int BN, int BK, int TM, int TN>
  struct Tile {
    static void launch(dim3 grid, dim3 block, cudaStream_t stream, const float* x, const void* w,
                       int ldw, const int* point, const int* af_tab, void* out, unsigned* ws,
                       int* tile_count, int M, int N, int K, int k_per_split, int mode,
                       int compute_round) {
      fused_dot_af_imad_kernel<WT, BM, BN, BK, TM, TN, PARTIAL><<<grid, block, 0, stream>>>(
          x, static_cast<const WT*>(w), ldw, point, af_tab, out, ws, tile_count, M, N, K,
          k_per_split, mode, compute_round);
    }
  };
};

// ----- the epilogue alone, on reduced int32 sums ----------------------------

__global__ void __launch_bounds__(256)
fused_epilogue_kernel(const int* __restrict__ acc, const int* __restrict__ point,
                      const int* __restrict__ af_tab, float* __restrict__ out, int M, int N,
                      int mode, int compute_round) {
  __shared__ int tab[AF_TAB_LEN];
  const fused::Epilogue epi =
      fused::make_epilogue(tab, af_tab, point, out, N, mode, compute_round);
  __syncthreads();
  const long long total = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int gm = (int)(i / N), gn = (int)(i % N);
    epi.finish(gm, gn, epi.prepare(gm, gn, acc[i]));
  }
}

template <bool PARTIAL>
int launch_dot(int path, int config, int splits, int k_per_split, const float* x, int8_t* xq,
               int ldq, const void* w, int w_bytes, int ldw, const int* point,
               const int* af_tab, void* out, unsigned* ws, int* tile_count, int M, int N, int K,
               int mode, int compute_round, cudaStream_t s) {
  if (path == WGMMA) {
    if (w_bytes != 1) return (int)cudaErrorInvalidValue;
    const long long quad_blocks = ((long long)M * (ldq / 4) + 255) / 256;
    const int qblocks = (int)(quad_blocks < 132 * 8 ? quad_blocks : 132 * 8);
    fused_quantize_x_kernel<<<qblocks, 256, 0, s>>>(x, point, xq, M, K, ldq);
    const int err = launch_int8_wgmma(
        config, xq, ldq, w, ldw, M, N, K,
        [&](auto bn, dim3 grid, int smem, const CUtensorMap& ta, const CUtensorMap& tb) {
          constexpr int BN = decltype(bn)::value;
          static unsigned sized = 0;
          allow_dynamic_smem(fused_dot_af_wgmma_kernel<BN, PARTIAL>, smem, sized);
          fused_dot_af_wgmma_kernel<BN, PARTIAL><<<grid, WG_THREADS, smem, s>>>(
              ta, tb, point, af_tab, out, M, N, K, mode, compute_round);
        });
    if (err) return err;
  } else if (path == NARROW) {
    if (w_bytes != 1) return (int)cudaErrorInvalidValue;
    const int err = dispatch_narrow<Narrow<PARTIAL>::template Launch>(
        config, M, N, splits, k_per_split, s, x, w, ldw, point, af_tab, out, ws, tile_count, M,
        N, K, k_per_split, mode, compute_round);
    if (err) return err;
  } else if (path == IMAD && w_bytes == 2) {
    dispatch_tiles<ImadLaunch<int16_t, PARTIAL>::template Tile>(
        config, M, N, splits, s, x, w, ldw, point, af_tab, out, ws, tile_count, M, N, K,
        k_per_split, mode, compute_round);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K) f32 contiguous; w: the K-major bank, column n at w + n * ldw
// elements (int8 / int16: w_bytes 1 / 2); xq: int8 (M, ldq) scratch of the
// wgmma path (else null); ws and tile_count: the zeroed split-K scratch (null
// when splits == 1). `config` is the path's tile choice (narrow: m-tiles of
// 8 rows; imad: tile configuration); wgmma takes k_per_split in 128-wide K
// tiles, the others in elements.
extern "C" int cordic_fused_launch(int path, int config, int splits, int k_per_split,
                                   const float* x, int8_t* xq, int ldq, const void* w,
                                   int w_bytes, int ldw, const int* point, const int* af_tab,
                                   float* out, unsigned* ws, int* tile_count, int M, int N, int K,
                                   int mode, int compute_round, void* stream) {
  return launch_dot<false>(path, config, splits, k_per_split, x, xq, ldq, w, w_bytes, ldw, point,
                           af_tab, out, ws, tile_count, M, N, K, mode, compute_round,
                           static_cast<cudaStream_t>(stream));
}

// The partial-sum instantiations: the same paths and arguments without the
// AF; out is the int32 (M, N) dot, wrapped modulo 2^32.
extern "C" int cordic_fused_partial_launch(int path, int config, int splits, int k_per_split,
                                           const float* x, int8_t* xq, int ldq, const void* w,
                                           int w_bytes, int ldw, const int* point, int* out,
                                           unsigned* ws, int* tile_count, int M, int N, int K,
                                           void* stream) {
  return launch_dot<true>(path, config, splits, k_per_split, x, xq, ldq, w, w_bytes, ldw, point,
                          nullptr, out, ws, tile_count, M, N, K, 0, 0,
                          static_cast<cudaStream_t>(stream));
}

// acc: the int32 (M, N) dot (summed over K shards); out f32 (M, N).
extern "C" int cordic_fused_epilogue_launch(const int* acc, const int* point, const int* af_tab,
                                            float* out, int M, int N, int mode,
                                            int compute_round, void* stream) {
  const long long blocks = ((long long)M * N + 255) / 256;
  const int grid = (int)(blocks < 132 * 8 ? blocks : 132 * 8);
  if (grid > 0)
    fused_epilogue_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        acc, point, af_tab, out, M, N, mode, compute_round);
  return (int)cudaGetLastError();
}
