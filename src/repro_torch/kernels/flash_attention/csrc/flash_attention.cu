// Cache-free flash attention (GQA) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// _flash_kernel (pallas_call in flash_attention_bhsd). For every batch row
// b, head h and query row i it computes, in f32:
//   scores_j = (q_i . k_j) / sqrt(D)        j <= i (causal), else -1e30
//   out_i    = softmax(scores) . V          rows with no weight emit 0
// with an online softmax over key tiles, and writes the output in q's dtype
// (f32 or bf16). The kv head is h / (H / KV), resolved by index: K and V are
// never repeated over the groups, where the Pallas wrapper repeats them.
//
// What bounds it on an H100: the f32 multiply-adds, 2 * D per visible
// (query, key) pair (QK^T and PV), run as FMA on the CUDA cores (67 TFLOP/s)
// because the reference is f32 and TF32 tensor cores keep about three
// digits. The bytes (q, k, v, out once) are ~100x smaller at S = 512. The
// Pallas kernel's (512 x 512) tiles live in 16 MiB of VMEM; here a block
// has at most 227 KB of shared memory, so one block takes one (b, h) and 64
// query rows (staged once), and streams the keys in 32-row K and V tiles,
// double-buffered with cp.async so the next tile's copy overlaps this
// tile's arithmetic. The 256 threads form a 16 x 16 grid: thread (r, c)
// owns query rows r, r + 16, r + 32, r + 48; for the scores it takes keys c
// and c + 16 of the tile (8 scores, each 16-byte read of shared memory
// serving 2 or 4 of them), and for P . V output columns c, c + 16, ...
// (D / 16 of them per row). A row's statistics live in the 16 lanes of one
// half warp, reduced with shuffles; P goes through shared memory from the
// score layout to the P . V layout.
//
// Tiles above the diagonal are skipped, and that is exact: tile 0 holds key
// 0 <= i, so the running max is finite after it, and a fully masked later
// tile would add exp(-1e30 - m) = 0 with alpha = 1. The 64-row query blocks
// run longest first, so the long causal rows do not trail the grid. Keys
// past Sk (a ragged edge: any S serves, where the Pallas kernel asserts S
// divides its block) score -inf and their zero-filled V rows add nothing.
// Shared memory at D = 128, f32: 108 KB (two blocks per SM); at D = 256:
// 204 KB. Tensor cores and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per tile
constexpr int NT = 256;       // threads: 16 row lanes x 16 key/column lanes
constexpr int RPT = BQ / 16;  // query rows per thread
constexpr int KPT = BK / 16;  // keys per thread in the score tile
constexpr int PS = BK + 4;    // row stride of the P tile (floats; 16-byte rows)

// element access by storage type: a 16-byte pad per shared-memory row keeps
// rows 16-byte aligned for cp.async
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int PAD = 4;
  __device__ static float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static float load(const float* p) { return *p; }
  __device__ static float store(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int PAD = 8;
  __device__ static float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + 4 * BK) * (D + Elem<T>::PAD) * sizeof(T) + (size_t)BQ * PS * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk, int H,
                       int KV, int causal, float scale) {
  constexpr int STR = D + Elem<T>::PAD;  // shared row stride, elements
  constexpr int CH = 16 / sizeof(T);     // elements per 16-byte copy
  constexpr int NC = D / 16;             // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][STR]
  T* kvs = qs + BQ * STR;                  // two stages of K [BK][STR], V [BK][STR]
  float* ps = reinterpret_cast<float*>(kvs + 4 * BK * STR);  // [BQ][PS]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KV * D;
  const T* qg = q + ((size_t)b * Sq * H + h) * D;
  const T* kg = k + ((size_t)b * Sk * KV + kvh) * D;
  const T* vg = v + ((size_t)b * Sk * KV + kvh) * D;

  // rows [row0, row0 + n) of a (rows, D) view with row stride `stride` into
  // dst; rows at or past `limit` are zero-filled
  auto stage = [&](T* dst, const T* src, int row0, int n, int limit, size_t stride) {
    for (int i = tid; i < n * (D / CH); i += NT) {
      const int r = i / (D / CH), c = (i % (D / CH)) * CH;
      const int g = row0 + r;
      const bool ok = g < limit;
      attn::cp_async16(dst + r * STR + c, src + (size_t)(ok ? g : 0) * stride + c, ok);
    }
  };

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  stage(qs, qg, q0, BQ, Sq, q_stride);
  stage(kvs, kg, 0, BK, Sk, kv_stride);
  stage(kvs + BK * STR, vg, 0, BK, Sk, kv_stride);
  attn::cp_async_commit();

  float m_run[RPT], l_run[RPT], acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const T* ks = kvs + (t & 1) * 2 * BK * STR;
    const T* vs = ks + BK * STR;
    if (t + 1 < n_tiles) {
      T* nxt = kvs + ((t + 1) & 1) * 2 * BK * STR;
      stage(nxt, kg, (t + 1) * BK, BK, Sk, kv_stride);
      stage(nxt + BK * STR, vg, (t + 1) * BK, BK, Sk, kv_stride);
    }
    attn::cp_async_commit();
    attn::cp_async_wait_one();  // this tile's copies (and the query rows) have landed
    __syncthreads();

    // scores (RPT rows x KPT keys), f32 FMA over D
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kf[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kf[j] = Elem<T>::load4(ks + (tc + 16 * j) * STR + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 qf = Elem<T>::load4(qs + (tr + 16 * i) * STR + d);
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = attn::dot4(qf, kf[j], s[i][j]);
      }
    }

    // mask, online softmax; P to shared memory
    const int k0 = t * BK;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qi = q0 + tr + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kj = k0 + tc + 16 * j;
        float sc = s[i][j] * scale;
        if (kj >= Sk) {
          sc = -INFINITY;  // past the end: the key does not exist
        } else if (causal && kj > qi) {
          sc = attn::NEG_INF_MASK;
        }
        s[i][j] = sc;
        mx = fmaxf(mx, sc);
      }
      // finite from tile 0 on: key k0 exists and scores at least -1e30
      const float m_new = fmaxf(m_run[i], attn::half_warp_max(mx));
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(tr + 16 * i) * PS + tc + 16 * j] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * alpha + attn::half_warp_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // P . V: RPT rows x NC columns
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pf[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pf[i] = *reinterpret_cast<const float4*>(ps + (tr + 16 * i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = Elem<T>::load(vs + (kk + u) * STR + tc + 16 * c);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float pw = u == 0 ? pf[i].x : u == 1 ? pf[i].y : u == 2 ? pf[i].z : pf[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pw, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();  // the next stage overwrites this K/V buffer and P
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= Sq) continue;
    const float l = l_run[i] == 0.f ? 1.f : l_run[i];
    T* o = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tc + 16 * c] = Elem<T>::store(acc[i][c] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk, int H,
           int KV, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  static_assert(smem <= 232448, "flash_attention: shared memory past 227 KB");
  static bool opted_in = false;  // above 48 KB a launch must opt in, once
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* out, int B, int Sq,
             int Sk, int H, int KV, int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, Sq, Sk, H, KV, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, KV, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, causal, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, B, Sq, Sk, H, KV, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KV, D), out (B, Sq, H, D), contiguous,
// 16-byte aligned, all of one type: dtype 0 is f32, 1 is bf16. H % KV == 0.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Sq, int Sk, int H, int KV, int D, int dtype,
                                      int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(D, q, k, v, out, B, Sq, Sk, H, KV, causal, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, out, B, Sq, Sk, H, KV, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
