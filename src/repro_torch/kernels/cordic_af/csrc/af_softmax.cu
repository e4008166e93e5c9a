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
// divide loops (~190 int32 operations an element at FxP8, ~240 at FxP16),
// not its 8 bytes per element. So the design spreads the elements over as
// many SMs as it can. A row is split over a thread-block cluster of c CTAs
// (1 to 16, ops.softmax_plan: enough CTAs to reach every SM when rows are
// few, no slice shorter than ops.MIN_SLICE elements, since a cluster launch
// costs ~2 us more than a plain one); CTA r of a cluster takes the r-th
// contiguous slice of its row. The row max and the row sum are reduced in
// each CTA (warp shuffles, then shared memory), published in the CTA's
// shared memory, and read by every CTA of the cluster through distributed
// shared memory after a cluster barrier, lane k of each warp reading rank
// k: no global scratch, no atomics, no second launch. Integer max and
// wrapping sum are order free, so every split gives the same bits. With
// c = 1 the same kernel is a plain launch (CLUSTER false) that reduces in
// the CTA alone. Each input is read and quantized once: the slice waits in
// shared memory as internal-format int32 values, which the exponentials
// then overwrite in place; the output is written once. Where a slice would
// not fit in shared memory even at c = 16 (the plan's "staged" path,
// STAGED), the same code keeps it in the output row instead, as int32 bits,
// each thread reading back only what it wrote.
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cordic_af.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
// the largest slice the shared path holds (ops.SLICE_BYTES_CAP)
constexpr int MAX_SLICE_BYTES = 224 * 1024;

// the input on the guard-bit internal format (af_chain's first two steps)
__device__ __forceinline__ int to_internal(float v, const int* tab) {
  const int xq = quantize(v, tab[T_IO_FRAC], tab[T_IO_QMIN], tab[T_IO_QMAX]);
  return requantize(xq, tab[T_IO_FRAC], tab[T_IN_FRAC], tab[T_IN_QMIN], tab[T_IN_QMAX]);
}

template <bool MAX>
__device__ __forceinline__ int combine(int a, int b) {
  return MAX ? max(a, b) : wadd(a, b);
}

template <bool MAX>
__device__ __forceinline__ int warp_reduce(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = combine<MAX>(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the split cluster barrier: arrive (release, or relaxed: nothing to
// publish) now, wait (acquire) later
template <bool RELEASE>
__device__ __forceinline__ void cluster_arrive() {
  if constexpr (RELEASE) asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  else asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Row-wide int32 max (MAX) or wrapping sum, returned to every thread. The
// CTA's own partial goes to `part` in its shared memory; in a cluster
// (CLUSTER) a cluster barrier publishes it, lane k of every warp reads rank
// k's partial through distributed shared memory (one remote load's
// latency, whatever the cluster size), and a shuffle tree combines them.
template <bool CLUSTER, bool MAX>
__device__ int row_reduce(int v, int* red, int* part) {
  constexpr int identity = MAX ? INT_MIN : 0;
  v = warp_reduce<MAX>(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_reduce<MAX>(lane < (int)(blockDim.x >> 5) ? red[lane] : identity);
    if (lane == 0) *part = v;
  }
  if constexpr (!CLUSTER) {
    __syncthreads();
    return *part;
  } else {
    const cg::cluster_group cluster = cg::this_cluster();
    cluster_arrive<true>();  // release this CTA's partial
    cluster_wait();    // acquire the others'
    return warp_reduce<MAX>(lane < (int)cluster.num_blocks() ? *cluster.map_shared_rank(part, lane)
                                                              : identity);
  }
}

// grid: rows x c CTAs, clusters of c along x (CLUSTER), or one CTA a row;
// `slice` elements a CTA, held in shared memory or (STAGED) the output row
template <bool CLUSTER, bool STAGED>
__global__ void __launch_bounds__(MAX_THREADS)
af_softmax_cluster_kernel(const float* __restrict__ x, float* out,
                          const int* __restrict__ af_tab, int n, int slice, int shift) {
  extern __shared__ int slice_smem[];
  __shared__ __align__(16) int tab[AF_TAB_LEN];
  __shared__ int red[MAX_WARPS];
  __shared__ int part[2];  // this CTA's partial max and partial sum
  const int c = CLUSTER ? (int)cg::this_cluster().num_blocks() : 1;
  const int rank = CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const size_t row = blockIdx.x / c;
  const int lo = (int)min((long long)rank * slice, (long long)n);
  const int len = min(slice, n - lo);
  static_assert(AF_TAB_LEN % 4 == 0 && AF_TAB_LEN / 4 <= 32, "one 16-byte load a thread");
  if (threadIdx.x < AF_TAB_LEN / 4)  // the table in one load of the first warp
    reinterpret_cast<int4*>(tab)[threadIdx.x] = reinterpret_cast<const int4*>(af_tab)[threadIdx.x];
  __syncthreads();
  const float* xs = x + row * n + lo;
  float* os = out + row * n + lo;
  // the slice as int32: internal-format inputs, then the exponentials
  int* buf = STAGED ? reinterpret_cast<int*>(os) : slice_smem;

  int m = INT_MIN;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int v = to_internal(xs[i], tab);
    buf[i] = v;
    m = max(m, v);
  }
  m = row_reduce<CLUSTER, true>(m, red, &part[0]);

  int s = 0;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {  // each thread reads back its own
    const int e = exp_neg(wsub(buf[i], m), tab) >> shift;
    buf[i] = e;
    s = wadd(s, e);
  }
  s = max(row_reduce<CLUSTER, false>(s, red, &part[1]), 1);
  // done with the other CTAs' shared memory; they may leave once all arrive
  if constexpr (CLUSTER) cluster_arrive<false>();

  const int depth = tab[T_DEPTH], io_frac = tab[T_IO_FRAC], in_frac = tab[T_IN_FRAC];
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int q = cordic_div(buf[i], s, depth, 1 << in_frac);
    const int o = requantize(q, in_frac, io_frac, tab[T_IO_QMIN], tab[T_IO_QMAX]);
    os[i] = __int2float_rn(o) * pow2f(-io_frac);
  }
  if constexpr (CLUSTER) cluster_wait();  // no CTA leaves while another may read its partials
}

cudaLaunchConfig_t launch_config(int rows, int cluster, int threads, int smem_bytes,
                                 cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * (unsigned)cluster);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  if (cluster > 1) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = (unsigned)cluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

using Kernel = void (*)(const float*, float*, const int*, int, int, int);

Kernel kernel_for(bool cluster, bool staged) {
  return cluster ? (staged ? af_softmax_cluster_kernel<true, true>
                           : af_softmax_cluster_kernel<true, false>)
                 : (staged ? af_softmax_cluster_kernel<false, true>
                           : af_softmax_cluster_kernel<false, false>);
}

// clusters of 16 and slices above 48 KB need the kernels' opt-in, once a device
cudaError_t allow_large(void) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  for (int k = 0; k < 4 && err == cudaSuccess; ++k) {
    const Kernel kernel = kernel_for(k & 1, k & 2);
    if (k & 1)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 MAX_SLICE_BYTES);
  }
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

bool valid(int cluster, int threads, int smem_bytes) {
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16) &&
         threads >= 32 && threads <= MAX_THREADS && threads % 32 == 0 && smem_bytes >= 0 &&
         smem_bytes <= MAX_SLICE_BYTES;
}

}  // namespace

// How many clusters of `cluster` CTAs of `threads` threads and `smem_bytes`
// of dynamic shared memory the current device can hold at once (0: none).
extern "C" int af_softmax_max_clusters(int cluster, int threads, int smem_bytes, int* count) {
  if (!valid(cluster, threads, smem_bytes)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_large();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(1, cluster, threads, smem_bytes, nullptr, &attr);
  if (cluster == 1)  // one CTA a row: a plain launch, no cluster to schedule
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        count, kernel_for(false, smem_bytes == 0), threads, (size_t)smem_bytes);
  return (int)cudaOccupancyMaxActiveClusters(count, kernel_for(true, smem_bytes == 0), &cfg);
}

// x, out: (rows, n) f32, contiguous; each row split over `cluster` CTAs of
// `slice` elements (the last may hold fewer), held in `smem_bytes` of
// shared memory, or in the output row when `staged`; shift: the
// accumulator pre-shift
extern "C" int af_softmax_launch(const float* x, float* out, const int* af_tab, int rows, int n,
                                 int cluster, int slice, int threads, int smem_bytes, int staged,
                                 int shift, void* stream) {
  if (rows <= 0 || n <= 0 || shift < 0 || shift > 31 || !valid(cluster, threads, smem_bytes) ||
      slice <= 0 || (long long)slice * cluster < n ||
      (!staged && smem_bytes < slice * (int)sizeof(int)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_large();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(rows, cluster, threads, smem_bytes,
                                         static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, kernel_for(cluster > 1, staged), x, out, af_tab, n, slice,
                           shift);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
