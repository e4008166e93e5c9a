// The int8 tensor-core main loop shared by the fused dot+AF kernel
// (cordic_fused/csrc/cordic_fused.cu) and the MAC-array matmul
// (cordic_mac/csrc/cordic_mac.cu) at prefill shapes (M > 16): one block's
// 128 x BN tile (BN = 128 or 256) of the exact int32 product
// x_int8 . w_int8, on Hopper's int8 tensor cores (wgmma), fed by TMA.
//
// Both operands are K-major, the only layout Hopper's integer MMAs accept:
// x is (M, K) with rows of stride ldx bytes, the weight bank (K, N) is
// stored as N rows of K (stride ldw bytes). Every stride is a multiple of 16
// bytes (TMA's rule) and the tensor maps span exactly K, M and N, so TMA's
// zero fill covers the ragged edges and any padding after K: zeros add
// nothing to an integer sum.
//
// Block: two consumer warpgroups and one producer warp (288 threads, so a
// consumer can hold 128 accumulators without spilling). One producer thread
// issues the TMA loads of the A (x, 128 rows) and B (bank, BN rows) tiles,
// 128 bytes of K each with the 128-byte swizzle, into a ring of stages
// guarded by full/empty mbarriers. Each consumer warpgroup runs
// wgmma.m64nBNk32.s32.s8.s8 on its 64 rows, four per stage, s32
// accumulators in registers, one stage's group kept in flight while the
// next is issued. No .satfinite: the s32 sums wrap like XLA's int32
// dot_general (FxP8 sums cannot overflow below K = 131,072 anyway). Integer
// sums are order free, so the tiling changes no bit.
//
// The whole of K runs in one block: on an H100 splitting K across blocks
// cost more than the idle SMs it filled at every shape measured (PERF.md).
// The 128 x 256 tile reads a quarter fewer bytes from L2 per product than
// 128 x 128; the host's plan takes it where it measured faster (where
// 128 x 128 tiles take one to four waves of blocks).
//
// The caller's epilogue is split in two: `epi.prepare(gm, gn, acc)` runs on
// the accumulator fragments into a tile in shared memory, and
// `epi.finish(gm, gn, v)` (the costly CORDIC AF, the store) runs from it,
// shared by every consumer thread in row order, masked to M x N (measured
// on the H100, staging was as fast or faster than storing from the
// fragments at most shapes, and 1.5-2.5x faster for the AF at M <= 64).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WG_BM = 128, WG_BK = 128;
constexpr int WG_CONSUMERS = 256;                 // warpgroups 0 and 1
constexpr int WG_THREADS = WG_CONSUMERS + 32;     // and the producer warp
constexpr int WG_TILE_A = WG_BM * WG_BK;          // bytes of one stage's A tile
// stages of the ring: 192 KB at either width, one block an SM (a 96 KB
// ring with two blocks an SM was no faster on the H100: too few loads in
// flight for a long K)
template <int BN> struct WgStages { static constexpr int N = BN == 256 ? 4 : 6; };
// the ring, plus slack to align it to the 1024-byte period of the swizzle
template <int BN>
constexpr int wg_smem() { return WgStages<BN>::N * (WG_TILE_A + BN * WG_BK) + 1024; }
static_assert(WG_BM * (128 + 1) * 4 <= wg_smem<128>() - 1024 &&
                  WG_BM * (256 + 1) * 4 <= wg_smem<256>() - 1024,
              "a staged f32 tile fits in the ring");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// 2-D TMA load of one box at coordinates (c0 = K offset, c1 = row offset)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the layout TMA's SWIZZLE_128B writes)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;            // leading byte offset: unused for swizzled K-major
  d |= (uint64_t)(1024 >> 4) << 32;  // stride byte offset
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand)
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128, s32) += A (64 x 32 bytes, s8) . B (128 x 32 bytes, s8)^T
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256, s32) += A (64 x 32 bytes, s8) . B (256 x 32 bytes, s8)^T
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]),
        "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]),
        "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]),
        "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]),
        "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]),
        "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]),
        "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]),
        "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]),
        "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN> struct Wgmma;
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db) {
    wgmma_m64n128k32_s8(d, da, db);
  }
};
template <> struct Wgmma<256> {
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t da, uint64_t db) {
    wgmma_m64n256k32_s8(d, da, db);
  }
};

// One block: the 128 x BN output tile (blockIdx.y, blockIdx.x) over all of
// K. `ta` maps x (dims {K, M}, 128-row boxes), `tb` the bank (dims {K, N},
// BN-row boxes); both are __grid_constant__ kernel parameters. `epi` must be
// ready (its shared state loaded) before the call; the call's first
// __syncthreads covers that.
template <int BN, typename Epi>
__device__ __forceinline__ void int8_wgmma_tile(const CUtensorMap* ta, const CUtensorMap* tb,
                                                const Epi& epi, int M, int N, int K) {
  constexpr int STAGES = WgStages<BN>::N, TILE_B = BN * WG_BK, ACC = BN / 2;
  extern __shared__ uint8_t wg_smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  uint8_t* smem = wg_smem_raw + ((1024 - (smem_addr(wg_smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;
  uint8_t* sb = smem + STAGES * WG_TILE_A;
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * WG_BM;
  const int k_tiles = (K + WG_BK - 1) / WG_BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp
    if (tid == WG_CONSUMERS) {
      for (int i = 0; i < k_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], WG_TILE_A + TILE_B);
        tma_load_2d(sa + s * WG_TILE_A, ta, &full[s], i * WG_BK, m0);
        tma_load_2d(sb + s * TILE_B, tb, &full[s], i * WG_BK, n0);
      }
    }
    return;
  }

  int acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0;
  const uint32_t a_base = smem_addr(sa) + wg * 64 * WG_BK;  // this warpgroup's 64 rows
  const uint32_t b_base = smem_addr(sb);
  for (int i = 0; i < k_tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 32; ++kk)
      Wgmma<BN>::mma(acc, wgmma_desc(a_base + s * WG_TILE_A + kk * 32),
                     wgmma_desc(b_base + s * TILE_B + kk * 32));
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (i > 0) mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // fragment layout: register j*4 + h*2 + e holds row r0 + 8h, column c0 + 8j + e
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const int c0 = n0 + (lane % 4) * 2;
  // the epilogue runs from a tile of prepared values in the ring, which no
  // load or product reads once both warpgroups are here: every consumer
  // thread takes a share of the costly CORDIC AF, and the stores run along
  // rows
  constexpr int LD = BN + 1;
  float* tile = reinterpret_cast<float*>(smem);
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS) : "memory");
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gm = r0 + 8 * h, gn = c0 + 8 * j + e;
        if (gm < M && gn < N)
          tile[(gm - m0) * LD + gn - n0] = epi.prepare(gm, gn, acc[j * 4 + h * 2 + e]);
      }
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS) : "memory");
  const int rows = min(WG_BM, M - m0), cols = min(BN, N - n0);
  for (int i = tid; i < rows * cols; i += WG_CONSUMERS) {
    const int r = i / cols, c = i - r * cols;
    epi.finish(m0 + r, n0 + c, tile[r * LD + c]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*,
                                         const cuuint32_t*, const cuuint32_t*,
                                         CUtensorMapInterleave, CUtensorMapSwizzle,
                                         CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  return fn;
}

// The map of a K-major int8 operand: `rows` rows of `k` bytes, `ld` bytes
// apart, in `box_rows` x 128-byte boxes with the 128-byte swizzle; reads
// past k or rows are zero. Returns a cudaError_t code.
inline int int8_k_major_map(CUtensorMap* map, const void* ptr, int k, int rows, long long ld,
                            int box_rows) {
  TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(ptr) & 15) || (ld & 15) || k <= 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)WG_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Raise a kernel's dynamic shared-memory limit to `bytes`, once per device
// (`done` holds one bit per device ordinal).
template <typename F>
void allow_dynamic_smem(F* kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && (done >> dev & 1u)) return;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (dev < 32) done |= 1u << dev;
}

// Encodes both maps and calls `launch(std::integral_constant<int, BN>(),
// grid, smem_bytes, ta, tb)` for the plan's tile width `bn` (128 or 256),
// which launches the caller's kernel instantiation. Returns a cudaError_t
// code.
template <typename F>
int launch_int8_wgmma(int bn, const void* x, long long ldx, const void* w, long long ldw, int M,
                      int N, int K, F&& launch) {
  CUtensorMap ta, tb;
  int err = int8_k_major_map(&ta, x, K, M, ldx, WG_BM);
  if (!err) err = int8_k_major_map(&tb, w, K, N, ldw, bn);
  if (err) return err;
  const int m_tiles = (M + WG_BM - 1) / WG_BM;
  if (bn == 256) {
    launch(std::integral_constant<int, 256>(), dim3((N + 255) / 256, m_tiles), wg_smem<256>(),
           ta, tb);
  } else if (bn == 128) {
    launch(std::integral_constant<int, 128>(), dim3((N + 127) / 128, m_tiles), wg_smem<128>(),
           ta, tb);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace
