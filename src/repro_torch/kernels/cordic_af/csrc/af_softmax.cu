// CARMEN's multi-AF block, seventh function: the row softmax, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cordic_af/kernel.py:
// _af_softmax_kernel (pallas_call in af_softmax, reached through
// ops.multi_af_pallas(x, "softmax")). Per row it computes, bit for bit as
// core/activations.cordic_softmax inside multi_af_float:
//   1. quantize each x to the I/O format and requantize it to the guard-bit
//      internal format;
//   2. m = the int32 row max;
//   3. e = CORDIC exp(x - m), every argument <= 0, values in (0, 1];
//   4. e >>= shift, the accumulator pre-shift the host computes from the row
//      width (core/activations.softmax_shift);
//   5. s = the int32 row sum of e (wrapping adds);
//   6. CORDIC divide e / max(s, 1);
//   7. requantize back to the I/O format and dequantize.
// The datapath is kernels/include/cordic_af.cuh, the same code as the other
// AF kernels; depth, formats and hyperbolic tables come from the int32 AF
// table.
//
// What bounds it on an H100: the integer operations of the CORDIC exp and
// divide loops (a row of 50304 at FxP16 full depth is ~10 M int32
// operations), not its 8 bytes per element. Design: one block per row, so
// both reductions stay in the block (warp shuffles, then shared memory);
// integer max and sum are order free, so the result is deterministic. The
// exponentials wait for the divide pass in the output row itself, as int32
// bits, so no row is too wide for shared memory and no exp is computed
// twice. With few rows (4 at decode) few SMs work: splitting a row over
// blocks is later work.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cordic_af.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

// the input on the guard-bit internal format (af_chain's first two steps)
__device__ __forceinline__ int to_internal(float v, const int* tab) {
  const int xq = quantize(v, tab[T_IO_FRAC], tab[T_IO_QMIN], tab[T_IO_QMAX]);
  return requantize(xq, tab[T_IO_FRAC], tab[T_IN_FRAC], tab[T_IN_QMIN], tab[T_IN_QMAX]);
}

// block-wide int32 max (MAX) or wrapping sum; every thread gets the result
template <bool MAX>
__device__ int block_reduce(int v, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? max(v, o) : wadd(v, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? red[lane] : (MAX ? INT_MIN : 0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int o = __shfl_xor_sync(0xffffffffu, v, off);
      v = MAX ? max(v, o) : wadd(v, o);
    }
    if (lane == 0) red[WARPS] = v;
  }
  __syncthreads();
  return red[WARPS];
}

__global__ void __launch_bounds__(THREADS)
af_softmax_kernel(const float* __restrict__ x, float* out, const int* __restrict__ af_tab,
                  int n, int shift) {
  __shared__ int tab[AF_TAB_LEN];
  __shared__ int red[WARPS + 1];
  for (int i = threadIdx.x; i < AF_TAB_LEN; i += THREADS) tab[i] = af_tab[i];
  __syncthreads();
  const float* xr = x + (size_t)blockIdx.x * n;
  float* orow = out + (size_t)blockIdx.x * n;
  int* er = reinterpret_cast<int*>(orow);  // the exponentials, until the divide pass

  int m = INT_MIN;
  for (int i = threadIdx.x; i < n; i += THREADS) m = max(m, to_internal(xr[i], tab));
  m = block_reduce<true>(m, red);

  int s = 0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int e = exp_neg(wsub(to_internal(xr[i], tab), m), tab) >> shift;
    er[i] = e;
    s = wadd(s, e);
  }
  s = max(block_reduce<false>(s, red), 1);

  const int depth = tab[T_DEPTH], io_frac = tab[T_IO_FRAC], in_frac = tab[T_IN_FRAC];
  for (int i = threadIdx.x; i < n; i += THREADS) {  // each thread reads back its own e
    const int q = cordic_div(er[i], s, depth, 1 << in_frac);
    const int o = requantize(q, in_frac, io_frac, tab[T_IO_QMIN], tab[T_IO_QMAX]);
    orow[i] = __int2float_rn(o) * pow2f(-io_frac);
  }
}

}  // namespace

// x, out: (rows, n) f32, contiguous; shift: the accumulator pre-shift
extern "C" int af_softmax_launch(const float* x, float* out, const int* af_tab, int rows, int n,
                                 int shift, void* stream) {
  if (rows <= 0 || n <= 0 || shift < 0 || shift > 31) return (int)cudaErrorInvalidValue;
  af_softmax_kernel<<<rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, out, af_tab, n,
                                                                             shift);
  return (int)cudaGetLastError();
}
