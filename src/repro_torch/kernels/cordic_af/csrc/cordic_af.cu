// CARMEN's standalone multi-AF block for Hopper (sm_90a): one elementwise
// pass of a CORDIC activation over a flat f32 tensor.
//
// Replaces the TPU kernel repro/kernels/cordic_af/kernel.py:
// _af_elementwise_kernel (pallas_call in af_elementwise, reached through
// ops.multi_af_pallas). Per element it computes, bit for bit: quantize to
// the I/O format, requantize to the guard-bit internal format, the CORDIC
// AF at depth max(depth + guard, 2), requantize back, dequantize. The
// integer datapath is kernels/include/cordic_af.cuh, the same code the fused
// dot+AF kernel's epilogue runs; depth, formats and tables come from the
// int32 AF table, so one build serves every execution point. The AF is a
// launch argument, as the TPU kernel's runtime mode scalar; each mode is its
// own instantiation so that the compiler folds the AF switch away.
//
// What bounds it on an H100: the integer operations. Each element reads 4
// bytes and writes 4, but runs two to four CORDIC loops of `depth`
// shift-add iterations (swish at FxP8 full depth: 13 iterations each of
// exp, divide and multiply, some 250 int32 operations), against 64 int32
// lanes per SM. Design: a grid-stride loop over the flat tensor, one element
// per thread per step, the AF table in shared memory. No padding: the TPU
// kernel's (256, 256) blocks come from its VMEM tiling, not from the math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cordic_af.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // eight blocks per SM of an H100

// MODE indexes FUSED_AFS (1 = relu ... 6 = selu), multi_af's numbering
template <int MODE>
__global__ void __launch_bounds__(THREADS)
af_elementwise_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const int* __restrict__ af_tab, long long n) {
  __shared__ int tab[AF_TAB_LEN];
  for (int i = threadIdx.x; i < AF_TAB_LEN; i += THREADS) tab[i] = af_tab[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    out[i] = af_chain(x[i], MODE, tab);
  }
}

template <int MODE>
void launch(const float* x, float* out, const int* af_tab, long long n, cudaStream_t stream) {
  const long long want = (n + THREADS - 1) / THREADS;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  af_elementwise_kernel<MODE><<<blocks, THREADS, 0, stream>>>(x, out, af_tab, n);
}

}  // namespace

// mode: index into ELEMENTWISE_AFS (0 = relu ... 5 = selu)
extern "C" int cordic_af_launch(const float* x, float* out, const int* af_tab, long long n,
                                int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case 0: launch<1>(x, out, af_tab, n, s); break;
    case 1: launch<2>(x, out, af_tab, n, s); break;
    case 2: launch<3>(x, out, af_tab, n, s); break;
    case 3: launch<4>(x, out, af_tab, n, s); break;
    case 4: launch<5>(x, out, af_tab, n, s); break;
    case 5: launch<6>(x, out, af_tab, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
