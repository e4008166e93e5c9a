// The epilogue of the fused CORDIC dot + AF kernel
// (cordic_fused/csrc/cordic_fused.cu), shared by its three int_dot paths,
// its partial-sum instantiations and its standalone epilogue kernel, so that
// the fused and the split (partial sum, reduce, epilogue) forms cannot
// drift. Per int32 dot output `acc` it computes, bit for bit as
// cordic_fused/ref.py:fused_epilogue_ref:
//   1. descale (acc * 2^-x_frac) * 2^-w_frac with exact powers of two;
//   2. past identity, an optional bf16 round, then the CORDIC activation
//      picked at run time by `mode` (an index into FUSED_AFS).
// The int_dot loops call `epi.finish(gm, gn, epi.prepare(gm, gn, acc))`;
// prepare runs on the accumulator, finish stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cordic_af.cuh"

namespace fused {

// params-vector indices (make_point)
constexpr int P_XFRAC = 1, P_XQMIN = 2, P_XQMAX = 3, P_WFRAC = 4;

// the activation chain of cordic_fused.ref.af_epilogue past identity. Not
// inlined: the output-tile loops call it once per accumulator.
__device__ __noinline__ float af_tail(float h, int mode, int compute_round, const int* tab) {
  if (compute_round) h = __bfloat162float(__float2bfloat16_rn(h));
  return af_chain(h, mode, tab);
}

// descale (prepare) and AF + store (finish) of one int32 dot output, out
// (M, N) f32
struct Epilogue {
  float* __restrict__ out;
  const int* tab;  // the AF table, in shared memory
  int N, mode, compute_round;
  float x_descale, w_descale;
  __device__ __forceinline__ float prepare(int, int, int acc) const {
    return (__int2float_rn(acc) * x_descale) * w_descale;
  }
  __device__ __forceinline__ void finish(int gm, int gn, float h) const {
    out[(size_t)gm * N + gn] = mode == 0 ? h : af_tail(h, mode, compute_round, tab);
  }
};

// Loads the AF table into shared memory and builds the block's epilogue; the
// caller synchronizes the block before the first finish.
__device__ __forceinline__ Epilogue make_epilogue(int* tab, const int* __restrict__ af_tab,
                                                  const int* __restrict__ point, float* out,
                                                  int N, int mode, int compute_round) {
  for (int i = threadIdx.x; i < AF_TAB_LEN; i += blockDim.x) tab[i] = af_tab[i];
  return Epilogue{out, tab, N, mode, compute_round, pow2f(-point[P_XFRAC]),
                  pow2f(-point[P_WFRAC])};
}

// The partial-sum form: the int32 dot itself, stored as it is (wrapped
// modulo 2^32), for a sum over K shards before the epilogue. prepare carries
// the accumulator's bits through the float staging tile of the wgmma path
// unchanged (a move, never arithmetic); finish stores them back as int32.
struct PartialEpilogue {
  int* __restrict__ out;
  int N;
  __device__ __forceinline__ float prepare(int, int, int acc) const {
    return __int_as_float(acc);
  }
  __device__ __forceinline__ void finish(int gm, int gn, float bits) const {
    out[(size_t)gm * N + gn] = __float_as_int(bits);
  }
};

}  // namespace fused
