// Cache-free flash attention (GQA) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// _flash_kernel (pallas_call in flash_attention_bhsd). For every batch row
// b, head h and query row i it computes, in f32:
//   scores_j = (q_i . k_j) / sqrt(D)        j <= i (causal), else -1e30
//   out_i    = softmax(scores) . V          rows with no weight emit 0
// with an online softmax over key tiles, and writes the output in q's dtype
// (f32 or bf16). The kv head is (h0 + h) / groups, resolved by index: K and
// V are never repeated over the groups, where the Pallas wrapper repeats
// them. h0 and groups are 0 and H / KV for a whole call; a tensor-parallel
// rank whose q heads are split over the model axis while the kv heads are
// not passes its first q head's global index and the global group count,
// and reads its kv heads in place in the whole K and V.
//
// What bounds it on an H100: the multiply-adds, 2 * D per visible (query,
// key) pair (QK^T and PV); the bytes (q, k, v, out once) are ~100x smaller
// at S = 512. The Pallas kernel's (512 x 512) tiles live in 16 MiB of VMEM;
// here a block has at most 227 KB of shared memory, so one block takes one
// (b, h) and 64 query rows and streams the keys in 32-key tiles. Both
// products run on the tensor cores (mma.sync m16n8k8 TF32) with the 3xTF32
// split, which keeps about f32 accuracy: the loop is include/gqa_tile.cuh,
// shared with the GQA cache attention. A bf16 operand needs no split (its
// low part is 0), so bf16 runs one MMA per QK^T step and two per P.V step,
// f32 three each. Query blocks run longest first (tile::Order) and tiles
// above the diagonal are skipped. Any S serves (the Pallas kernel asserts S divides
// its block): keys past Sk score -inf, rows past Sq are not written.
// Shared memory at D = 128, f32: 101 KB, two blocks an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gqa_tile.cuh"

namespace {

template <typename T, int D, typename Mask>
__global__ void __launch_bounds__(tile::Config<T, D>::NT)
flash_attention_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk, int H,
                          int KV, int h0, int groups, float scale, tile::Order order) {
  int bh, rank;
  order.item(blockIdx.x, bh, rank);
  const int b = bh / H, h = bh % H;
  const int kvh = (h0 + h) / groups;
  const size_t q_off = ((size_t)b * Sq * H + h) * D, kv_off = ((size_t)b * Sk * KV + kvh) * D;
  tile::attend<T, D>(q + q_off, k + kv_off, v + kv_off, out + q_off, (size_t)H * D,
                         (size_t)KV * D, rank, order.nqb, Sq, Sk, Mask{}, scale);
}

// the geometry of one call: B, Sq, Sk, H, KV, the first q head h0 and groups
struct Dims {
  int B, Sq, Sk, H, KV, h0, groups;
};

template <typename T, int D, typename Mask>
int launch(const void* q, const void* k, const void* v, void* out, Dims g, float scale,
           cudaStream_t stream) {
  using C = tile::Config<T, D>;
  constexpr size_t smem = C::SMEM;
  static int sms = 0, resident = 0;  // set once, with the shared-memory opt-in
  if (!resident) {
    if (const int e = tile::opt_in(flash_attention_tc_kernel<T, D, Mask>, smem)) return e;
    if (const int e = tile::residency(flash_attention_tc_kernel<T, D, Mask>, C::NT, smem, sms,
                                      resident))
      return e;
  }
  const tile::Order order = tile::order(sms, resident, g.B * g.H, g.Sq);
  flash_attention_tc_kernel<T, D, Mask><<<order.nqb * order.n_bh, C::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), g.Sq, g.Sk, g.H, g.KV, g.h0, g.groups, scale, order);
  return (int)cudaGetLastError();
}

template <typename T, typename Mask>
int dispatch(int D, const void* q, const void* k, const void* v, void* out, Dims g, float scale,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16, Mask>(q, k, v, out, g, scale, s);
    case 32: return launch<T, 32, Mask>(q, k, v, out, g, scale, s);
    case 64: return launch<T, 64, Mask>(q, k, v, out, g, scale, s);
    case 112: return launch<T, 112, Mask>(q, k, v, out, g, scale, s);
    case 128: return launch<T, 128, Mask>(q, k, v, out, g, scale, s);
    case 256: return launch<T, 256, Mask>(q, k, v, out, g, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_mask(int causal, int D, const void* q, const void* k, const void* v, void* out,
                  Dims g, float scale, cudaStream_t s) {
  return causal ? dispatch<T, tile::Causal>(D, q, k, v, out, g, scale, s)
                : dispatch<T, tile::Full>(D, q, k, v, out, g, scale, s);
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KV, D), out (B, Sq, H, D), contiguous,
// 16-byte aligned, all of one type: dtype 0 is f32, 1 is bf16. q head h
// reads kv head (h0 + h) / groups: h0 = 0 and groups = H / KV for a whole
// call, a rank's first global q head and the global group count for a
// rank's share of the q heads against the whole kv heads.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Sq, int Sk, int H, int KV, int h0, int groups,
                                      int D, int dtype, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || h0 < 0 || groups < 1 ||
      (h0 + H - 1) / groups >= KV)
    return (int)cudaErrorInvalidValue;
  const Dims g{B, Sq, Sk, H, KV, h0, groups};
  if (dtype == 0) return dispatch_mask<float>(causal, D, q, k, v, out, g, scale, s);
  if (dtype == 1) return dispatch_mask<__nv_bfloat16>(causal, D, q, k, v, out, g, scale, s);
  return (int)cudaErrorInvalidValue;
}
