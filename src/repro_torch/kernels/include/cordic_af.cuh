// The integer CORDIC datapath of CARMEN's multi-AF block, shared by the
// fused dot+AF kernel (cordic_fused/csrc/cordic_fused.cu) and the standalone
// elementwise AF kernel (cordic_af/csrc/cordic_af.cu). One copy, so the two
// kernels cannot drift apart: both are bitwise equal to core/activations.py.
//
// Every function works on raw int32 values with two's-complement wrap (the
// reference's int32 arithmetic), reading depth, formats, constants and the
// hyperbolic tables from the int32 AF table that kernels/af_table.py builds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// layout of the int32 AF table (built by kernels/af_table.py from core/cordic.py)
constexpr int T_DEPTH = 0;
constexpr int T_IO_FRAC = 1, T_IO_QMIN = 2, T_IO_QMAX = 3;
constexpr int T_IN_FRAC = 4, T_IN_QMIN = 5, T_IN_QMAX = 6;
constexpr int T_INV_GAIN = 7, T_ZMAX = 8, T_LN2 = 9;
constexpr int T_C_CUBIC = 10, T_C_GELU = 11, T_C_HALF = 12, T_C_LAMBDA = 13, T_C_ALPHA = 14;
constexpr int T_SHIFT = 16, T_ATANH = 48;
constexpr int AF_TAB_LEN = 80;

__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int wmul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
__device__ __forceinline__ int wneg(int a) { return (int)(0u - (unsigned)a); }
__device__ __forceinline__ int shl(int a, int s) { return (int)((unsigned)a << s); }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// floor division for b > 0 (C++ '/' truncates toward zero)
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

// exact 2^e as a float for e in [-126, 127]
__device__ __forceinline__ float pow2f(int e) { return __int_as_float((127 + e) << 23); }

// fxp.quantize: f32 * 2^frac, round half to even, saturating cast (NaN -> 0), clip
__device__ __forceinline__ int quantize(float v, int frac, int qmin, int qmax) {
  return clampi(__float2int_rn(v * pow2f(frac)), qmin, qmax);
}

// fxp.requantize
__device__ __forceinline__ int requantize(int raw, int src, int dst, int qmin, int qmax) {
  int out;
  if (dst >= src) {
    out = shl(raw, dst - src);
  } else {
    int sh = src - dst;
    out = wadd(raw, 1 << (sh - 1)) >> sh;
  }
  return clampi(out, qmin, qmax);
}

// linear rotation: y = x * value(z), z in Q1 with `one` = 2^frac
__device__ int cordic_mul(int x, int z, int depth, int one) {
  int y = 0;
  for (int k = 0; k < depth; ++k) {
    const int xs = x >> k, zs = one >> k;
    if (z >= 0) { y = wadd(y, xs); z = wsub(z, zs); }
    else        { y = wsub(y, xs); z = wadd(z, zs); }
  }
  return y;
}

// linear vectoring: z = num / den
__device__ int cordic_div(int num, int den, int depth, int one) {
  int y = num, z = 0;
  for (int k = 0; k < depth; ++k) {
    const int xs = den >> k, zs = one >> k;
    if ((y >= 0) == (den >= 0)) { y = wsub(y, xs); z = wadd(z, zs); }
    else                        { y = wadd(y, xs); z = wsub(z, zs); }
  }
  return z;
}

// hyperbolic rotation from 1/A_h: returns cosh(z) + sinh(z)
__device__ int hyperbolic_exp_core(int z, const int* tab) {
  const int depth = tab[T_DEPTH], zmax = tab[T_ZMAX];
  z = clampi(z, -zmax, zmax);
  int x = tab[T_INV_GAIN], y = 0;
  for (int i = 0; i < depth; ++i) {
    const int k = tab[T_SHIFT + i], a = tab[T_ATANH + i];
    const int xs = y >> k, ys = x >> k;
    if (z >= 0) { x = wadd(x, xs); y = wadd(y, ys); z = wsub(z, a); }
    else        { x = wsub(x, xs); y = wsub(y, ys); z = wadd(z, a); }
  }
  return wadd(x, y);
}

// cordic.cordic_exp on the internal format
__device__ int cordic_exp(int x, const int* tab) {
  const int ln2 = tab[T_LN2];
  int q = floordiv(wadd(shl(x, 1), ln2), 2 * ln2);
  const int r = wsub(x, wmul(q, ln2));
  int e = hyperbolic_exp_core(r, tab);
  q = clampi(q, -31, 29 - tab[T_IN_FRAC]);
  return q >= 0 ? shl(e, q) : (e >> (-q));
}

__device__ __forceinline__ int exp_neg(int x, const int* tab) { return cordic_exp(min(x, 0), tab); }
__device__ __forceinline__ int iabs(int x) { return x < 0 ? wneg(x) : x; }

__device__ int tanh_raw(int x, const int* tab) {
  const int depth = tab[T_DEPTH], one = 1 << tab[T_IN_FRAC];
  const int t = exp_neg(wneg(shl(iabs(x), 1)), tab);
  const int mag = cordic_div(wsub(one, t), wadd(one, t), depth, one);
  return x >= 0 ? mag : wneg(mag);
}

__device__ int sigmoid_raw(int x, const int* tab) {
  const int depth = tab[T_DEPTH], one = 1 << tab[T_IN_FRAC];
  const int t = exp_neg(wneg(iabs(x)), tab);
  return cordic_div(x >= 0 ? one : t, wadd(one, t), depth, one);
}

__device__ __forceinline__ int mul_raw(int a, int b, const int* tab) {
  const int frac = tab[T_IN_FRAC];
  const int lim = (1 << (frac + 1)) - 1;
  return cordic_mul(a, clampi(b, -lim, lim), tab[T_DEPTH], 1 << frac);
}

__device__ __forceinline__ int sat(int v, const int* tab) {
  return clampi(v, tab[T_IN_QMIN], tab[T_IN_QMAX]);
}

// core/activations.multi_af; mode indexes FUSED_AFS = (identity, relu, gelu,
// tanh, sigmoid, swish, selu)
__device__ int multi_af(int x, int mode, const int* tab) {
  const int one = 1 << tab[T_IN_FRAC];
  switch (mode) {
    case 1:  // relu
      return max(x, 0);
    case 2: {  // gelu, tanh form
      const int x2 = mul_raw(x, x, tab);
      const int x2c = mul_raw(x2, tab[T_C_CUBIC], tab);
      const int x3c = mul_raw(x, x2c, tab);
      const int arg = mul_raw(wadd(x, x3c), tab[T_C_GELU], tab);
      const int t = tanh_raw(arg, tab);
      const int out = mul_raw(x, wadd(one, t), tab);
      return sat(mul_raw(out, tab[T_C_HALF], tab), tab);
    }
    case 3:  // tanh
      return sat(tanh_raw(x, tab), tab);
    case 4:  // sigmoid
      return sat(sigmoid_raw(x, tab), tab);
    case 5:  // swish
      return sat(mul_raw(x, sigmoid_raw(x, tab), tab), tab);
    case 6: {  // selu
      const int e = exp_neg(x, tab);
      const int neg = mul_raw(wsub(e, one), tab[T_C_ALPHA], tab);
      return sat(mul_raw(x > 0 ? x : neg, tab[T_C_LAMBDA], tab), tab);
    }
    default:
      return x;
  }
}

// The multi-AF block on one f32 value, as core/activations.multi_af_float
// computes it: quantize to the I/O format, requantize to the guard-bit
// internal format, the CORDIC AF, requantize back, dequantize.
__device__ __forceinline__ float af_chain(float h, int mode, const int* tab) {
  const int io_frac = tab[T_IO_FRAC], in_frac = tab[T_IN_FRAC];
  const int xq = quantize(h, io_frac, tab[T_IO_QMIN], tab[T_IO_QMAX]);
  const int xi = requantize(xq, io_frac, in_frac, tab[T_IN_QMIN], tab[T_IN_QMAX]);
  const int raw = multi_af(xi, mode, tab);
  const int o = requantize(raw, in_frac, io_frac, tab[T_IO_QMIN], tab[T_IO_QMAX]);
  return __int2float_rn(o) * pow2f(-io_frac);
}

}  // namespace
