// CARMEN's MAC array as a blocked integer matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cordic_mac/kernel.py:_mac_kernel
// (pallas_call in mac_matmul, reached through ops.cordic_mac by the per-call
// kernel-backend dot). Per output element it computes, bit for bit as
// kernels/cordic_mac/ref.py:mac_matmul_ref:
//   1. acc = sum_k x_q[m, k] * w_q[k, n], int8 or int16 operands, the int32
//      accumulator wrapping modulo 2^32 like XLA's int32 dot_general (FxP16
//      can overflow at K = 8192);
//   2. out = (float(acc) * x_scale[m]) * w_scale[n], two f32 multiplies in
//      that order;
//   3. out = max(out, 0) when fuse_relu is set (the multi-AF block's ReLU
//      bypass), NaN kept as jnp.maximum keeps it.
//
// Both operands are K-major: x_q (M, K) rows ldx elements apart, the bank
// w_q (K, N) stored as N rows of K, ldw elements apart; both strides are
// multiples of 16 bytes. The paths are the fused dot+AF kernel's, chosen by
// the host's plan (kernels/int_dot.py), with x already quantized:
//
// * int8 x int8, M > 16 (the calibration forward, prefill buckets): bound by
//   the int8 multiply-adds; mac_matmul_wgmma_kernel, the TMA + wgmma loop of
//   include/int8_wgmma.cuh (128 x 128 or 128 x 256 tiles), reading x_q and
//   the bank straight through TMA.
// * int8 x int8, M <= 16 (decode): bound by the weight bytes (a 2048 x 8192
//   bank is 16.8 MB, >= 5 us at 3.35 TB/s); mac_matmul_narrow_kernel, the
//   streaming mma.sync loop of include/int_dot.cuh.
// * any int16 operand (FxP16), any M: mac_matmul_imad_kernel, the int32
//   CUDA-core loop of include/int_dot.cuh.
//
// The epilogue is the scale multiply (+ReLU). The kernels mask the ragged
// edges themselves, so nothing is padded to the TPU's 256-tiles.
//
// Tensor-parallel serving splits K of a row-parallel product (wo, down,
// out_proj) across ranks. In the int8 mode and per call the epilogue must run
// on the sum of the ranks' int32 dots: a float sum of scaled partials is not
// bitwise (float(acc) rounds above 2^24), while int32 sums wrap the same
// modulo 2^32 in any order. So each path also has a partial-sum instantiation
// (entry cordic_mac_partial_launch, the epilogue fused::PartialEpilogue of
// include/fused_epilogue.cuh: the accumulator's bits stored as int32, through
// the wgmma path's float staging tile as a bit-cast, never a conversion), and
// mac_epilogue_kernel (entry cordic_mac_epilogue_launch) applies the scale
// multiply (+ReLU) to the reduced int32 sums, with the same MacEpilogue as the
// whole kernel: an elementwise pass bound by its 8 bytes an element. It
// replaces no TPU kernel of its own: on the TPU, GSPMD ran the reference's
// XLA chain under a mesh.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_epilogue.cuh"
#include "int8_wgmma.cuh"
#include "int_dot.cuh"

namespace {

enum Path { NARROW = 0, WGMMA = 1, IMAD = 2 };

struct MacEpilogue {
  float* __restrict__ out;
  const float* __restrict__ x_scale;
  const float* __restrict__ w_scale;
  int N, fuse_relu;
  __device__ __forceinline__ float prepare(int gm, int gn, int acc) const {
    const float v = (__int2float_rn(acc) * x_scale[gm]) * w_scale[gn];
    return fuse_relu && v < 0.f ? 0.f : v;
  }
  __device__ __forceinline__ void finish(int gm, int gn, float v) const {
    out[(size_t)gm * N + gn] = v;
  }
};

// the quantized activation operand, read straight into a tile
template <typename XT>
struct LoadX {
  const XT* __restrict__ x;
  int ldx;
  __device__ __forceinline__ int operator()(int gm, int gk) const {
    return (int)x[(size_t)gm * ldx + gk];
  }
  // int8 elements gk..gk+3 as one word (rows are 16-byte aligned, gk % 4 == 0)
  __device__ __forceinline__ unsigned quad(int gm, int gk) const {
    return *reinterpret_cast<const unsigned*>(x + (size_t)gm * ldx + gk);
  }
};

template <int BN, typename Epi>
__global__ void __launch_bounds__(WG_THREADS, 1)
mac_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb, Epi epi, int M, int N, int K) {
  int8_wgmma_tile<BN>(&ta, &tb, epi, M, N, K);
}

template <int MT, typename Epi>
__global__ void __launch_bounds__(NW_THREADS)
mac_matmul_narrow_kernel(const int8_t* __restrict__ x, int ldx, const int8_t* __restrict__ w,
                         int ldw, Epi epi, unsigned* __restrict__ ws,
                         int* __restrict__ tile_count, int M, int N, int K, int k_per_split) {
  int8_narrow_tile<MT>(LoadX<int8_t>{x, ldx}, w, ldw, epi, ws, tile_count, M, N, K,
                       k_per_split);
}

template <typename Epi>
struct Narrow {
  template <int MT>
  struct Launch {
    static void launch(dim3 grid, int smem, cudaStream_t stream, const void* x, int ldx,
                       const void* w, int ldw, Epi epi, unsigned* ws, int* tile_count, int M,
                       int N, int K, int k_per_split) {
      mac_matmul_narrow_kernel<MT, Epi><<<grid, NW_THREADS, smem, stream>>>(
          static_cast<const int8_t*>(x), ldx, static_cast<const int8_t*>(w), ldw, epi, ws,
          tile_count, M, N, K, k_per_split);
    }
  };
};

template <typename XT, typename WT, int BM, int BN, int BK, int TM, int TN, typename Epi>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
mac_matmul_imad_kernel(const XT* __restrict__ x, int ldx, const WT* __restrict__ w, int ldw,
                       Epi epi, unsigned* __restrict__ ws, int* __restrict__ tile_count,
                       int M, int N, int K, int k_per_split) {
  unsigned acc[TM][TN];
  if (!int_dot_tile<WT, BM, BN, BK, TM, TN>(acc, LoadX<XT>{x, ldx}, w, ldw, ws, tile_count, M, N,
                                             K, k_per_split))
    return;
  int_dot_store<BM, BN, TM, TN>(acc, epi, M, N);
}

template <typename XT, typename WT, typename Epi>
struct ImadLaunch {
  template <int BM, int BN, int BK, int TM, int TN>
  struct Tile {
    static void launch(dim3 grid, dim3 block, cudaStream_t stream, const void* x, int ldx,
                       const void* w, int ldw, Epi epi, unsigned* ws, int* tile_count,
                       int M, int N, int K, int k_per_split) {
      mac_matmul_imad_kernel<XT, WT, BM, BN, BK, TM, TN, Epi><<<grid, block, 0, stream>>>(
          static_cast<const XT*>(x), ldx, static_cast<const WT*>(w), ldw, epi, ws, tile_count,
          M, N, K, k_per_split);
    }
  };
};

// the CUDA-core loop for every operand pair with an int16 side (int8 x int8
// never comes here)
template <typename XT, typename Epi>
int dispatch_imad(int w_bytes, int config, int splits, cudaStream_t s, const void* x, int ldx,
                  const void* w, int ldw, Epi epi, unsigned* ws, int* tile_count, int M,
                  int N, int K, int k_per_split) {
  if (w_bytes == 1 && sizeof(XT) == 2) {
    dispatch_tiles<ImadLaunch<int16_t, int8_t, Epi>::template Tile>(
        config, M, N, splits, s, x, ldx, w, ldw, epi, ws, tile_count, M, N, K, k_per_split);
  } else if (w_bytes == 2) {
    dispatch_tiles<ImadLaunch<XT, int16_t, Epi>::template Tile>(
        config, M, N, splits, s, x, ldx, w, ldw, epi, ws, tile_count, M, N, K, k_per_split);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// the int32 dot of every path into the block epilogue `epi`
template <typename Epi>
int launch_mac(int path, int config, int splits, int k_per_split, const void* x, int x_bytes,
               int ldx, const void* w, int w_bytes, int ldw, Epi epi, unsigned* ws,
               int* tile_count, int M, int N, int K, cudaStream_t s) {
  int err = 0;
  if (path == WGMMA) {
    if (x_bytes != 1 || w_bytes != 1) return (int)cudaErrorInvalidValue;
    err = launch_int8_wgmma(
        config, x, ldx, w, ldw, M, N, K,
        [&](auto bn, dim3 grid, int smem, const CUtensorMap& ta, const CUtensorMap& tb) {
          constexpr int BN = decltype(bn)::value;
          static unsigned sized = 0;
          allow_dynamic_smem(mac_matmul_wgmma_kernel<BN, Epi>, smem, sized);
          mac_matmul_wgmma_kernel<BN, Epi><<<grid, WG_THREADS, smem, s>>>(ta, tb, epi, M, N, K);
        });
  } else if (path == NARROW) {
    if (x_bytes != 1 || w_bytes != 1) return (int)cudaErrorInvalidValue;
    err = dispatch_narrow<Narrow<Epi>::template Launch>(config, M, N, splits, k_per_split, s, x,
                                                        ldx, w, ldw, epi, ws, tile_count, M, N,
                                                        K, k_per_split);
  } else if (path == IMAD && x_bytes == 1) {
    err = dispatch_imad<int8_t>(w_bytes, config, splits, s, x, ldx, w, ldw, epi, ws, tile_count,
                                M, N, K, k_per_split);
  } else if (path == IMAD && x_bytes == 2) {
    err = dispatch_imad<int16_t>(w_bytes, config, splits, s, x, ldx, w, ldw, epi, ws, tile_count,
                                 M, N, K, k_per_split);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}

// ----- the epilogue alone, on reduced int32 sums ----------------------------

__global__ void __launch_bounds__(256)
mac_epilogue_kernel(const int* __restrict__ acc, MacEpilogue epi, int M, int N) {
  const long long total = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int gm = (int)(i / N), gn = (int)(i % N);
    epi.finish(gm, gn, epi.prepare(gm, gn, acc[i]));
  }
}

}  // namespace

// x: (M, K) int8/int16 (x_bytes 1/2), rows ldx elements apart; w: the
// K-major (K, N) bank, int8/int16 (w_bytes 1/2), column n at w + n * ldw
// elements; x_scale: (M,) f32, w_scale: (N,) f32, out: (M, N) f32. ws and
// tile_count are the split-K partial slices and arrival counters (null when
// splits == 1; the counters start at zero and the kernel leaves them so).
// `config` is the path's tile choice (narrow: m-tiles of 8 rows; wgmma: the
// tile width, 128 or 256; imad: tile configuration); the wgmma path runs the
// whole of K in each block.
extern "C" int cordic_mac_launch(int path, int config, int splits, int k_per_split,
                                 const void* x, int x_bytes, int ldx, const void* w, int w_bytes,
                                 int ldw, const float* x_scale, const float* w_scale, float* out,
                                 unsigned* ws, int* tile_count, int M, int N, int K,
                                 int fuse_relu, void* stream) {
  return launch_mac(path, config, splits, k_per_split, x, x_bytes, ldx, w, w_bytes, ldw,
                    MacEpilogue{out, x_scale, w_scale, N, fuse_relu}, ws, tile_count, M, N, K,
                    static_cast<cudaStream_t>(stream));
}

// The partial-sum instantiations: the same paths and operands without the
// scales; out is the int32 (M, N) dot, wrapped modulo 2^32.
extern "C" int cordic_mac_partial_launch(int path, int config, int splits, int k_per_split,
                                         const void* x, int x_bytes, int ldx, const void* w,
                                         int w_bytes, int ldw, int* out, unsigned* ws,
                                         int* tile_count, int M, int N, int K, void* stream) {
  return launch_mac(path, config, splits, k_per_split, x, x_bytes, ldx, w, w_bytes, ldw,
                    fused::PartialEpilogue{out, N}, ws, tile_count, M, N, K,
                    static_cast<cudaStream_t>(stream));
}

// acc: the int32 (M, N) dot (summed over K shards); x_scale (M,), w_scale
// (N,) f32; out f32 (M, N) = (float(acc) * x_scale) * w_scale (+ReLU).
extern "C" int cordic_mac_epilogue_launch(const int* acc, const float* x_scale,
                                          const float* w_scale, float* out, int M, int N,
                                          int fuse_relu, void* stream) {
  const long long blocks = ((long long)M * N + 255) / 256;
  const int grid = (int)(blocks < 132 * 8 ? blocks : 132 * 8);
  if (grid > 0)
    mac_epilogue_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        acc, MacEpilogue{out, x_scale, w_scale, N, fuse_relu}, M, N);
  return (int)cudaGetLastError();
}
