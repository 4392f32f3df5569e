// The Humlicek (1982) Voigt function H(a, v) = Re w(v + i a) as PyTorch's
// CUDA build evaluates physics/voigt.py humlicek_w, for E2 (vrt_voigt_rows,
// csrc/extinction.cu) and R1 (vrt_rates_chunk, csrc/rates.cu): the same
// region tests and coefficients, but each point evaluates only its own
// region instead of all four.  Complex products and quotients as
// c10::complex's, with the multiply-adds that PyTorch's CUDA build
// contracts written out as fma, the real part of a complex exp as exp(x)
// cos y; complex128 for float64 and complex64 for float32.  Built with
// -fmad=false (kernels/build.py), so nothing else is contracted and a
// point rounds as the plain version's on the card.  E1 shares the complex
// helpers and the regions' rational functions (csrc/extinction.cu e1_H).
#pragma once

#include "formal.cuh"

namespace {

template <typename T>
struct cplx {
  T re, im;
};

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// c10::complex operator* as PyTorch's CUDA build contracts it:
// (a + bi)(c + di) = fma(a, c, -bd) + fma(a, d, bc) i
template <typename T>
__device__ __forceinline__ cplx<T> cmul(cplx<T> x, cplx<T> y) {
  return {fma_t(x.re, y.re, -(x.im * y.im)), fma_t(x.re, y.im, x.im * y.re)};
}

// z * s for a real constant s: PyTorch multiplies by (s, 0), whose zero
// terms change nothing but the sign of a zero
template <typename T>
__device__ __forceinline__ cplx<T> cscale(cplx<T> z, T s) {
  return {z.re * s, z.im * s};
}

// s + z and s - z for a real constant s
template <typename T>
__device__ __forceinline__ cplx<T> cadd(T s, cplx<T> z) {
  return {z.re + s, z.im};
}
template <typename T>
__device__ __forceinline__ cplx<T> crsub(T s, cplx<T> z) {
  return {s - z.re, -z.im};
}

// c10::complex operator/ (numpy's algorithm,
// torch/headeronly/util/complex.h) as PyTorch's CUDA build contracts it
template <typename T>
__device__ __forceinline__ cplx<T> cdiv(cplx<T> x, cplx<T> y) {
  const T a = x.re, b = x.im, c = y.re, d = y.im;
  const T abs_c = c < 0 ? -c : c;
  const T abs_d = d < 0 ? -d : d;
  if (abs_c >= abs_d) {
    if (abs_c == T(0) && abs_d == T(0)) return {a / abs_c, b / abs_d};
    const T rat = d / c;
    const T scl = T(1) / fma_t(d, rat, c);
    return {fma_t(b, rat, a) * scl, fma_t(-a, rat, b) * scl};
  }
  const T rat = c / d;
  const T scl = T(1) / fma_t(c, rat, d);
  return {fma_t(a, rat, b) * scl, fma_t(b, rat, -a) * scl};
}

__device__ __forceinline__ float cos_t(float x) { return cosf(x); }
__device__ __forceinline__ double cos_t(double x) { return cos(x); }

// The Humlicek regions' rational functions of t = a - i v (u = t^2),
// physics/voigt.py humlicek_w, as numerator and denominator
template <typename T>
__device__ __forceinline__ T region1(cplx<T> t) {
  // t 0.5641896 / (0.5 + t^2)
  return cdiv(cscale(t, T(0.5641896)), cadd(T(0.5), cmul(t, t))).re;
}

template <typename T>
__device__ __forceinline__ T region2(cplx<T> t) {
  // t (1.410474 + u 0.5641896) / (0.75 + u (3 + u))
  const cplx<T> u = cmul(t, t);
  return cdiv(cmul(t, cadd(T(1.410474), cscale(u, T(0.5641896)))),
              cadd(T(0.75), cmul(u, cadd(T(3.0), u)))).re;
}

template <typename T>
__device__ __forceinline__ cplx<T> region3_num(cplx<T> t) {
  cplx<T> n = cadd(T(3.778987), cscale(t, T(0.5642236)));
  n = cadd(T(11.96482), cmul(t, n));
  n = cadd(T(20.20933), cmul(t, n));
  return cadd(T(16.4955), cmul(t, n));
}

template <typename T>
__device__ __forceinline__ cplx<T> region3_den(cplx<T> t) {
  cplx<T> d = cadd(T(6.699398), t);
  d = cadd(T(21.69274), cmul(t, d));
  d = cadd(T(39.27121), cmul(t, d));
  d = cadd(T(38.82363), cmul(t, d));
  return cadd(T(16.4955), cmul(t, d));
}

// region IV: exp(u) - t P(u) / Q(u); |Re u| < 30.25 there, so the plain
// versions' clip of Re u to [-690, 690] never acts
template <typename T>
__device__ __forceinline__ cplx<T> region4_num(cplx<T> t, cplx<T> u) {
  cplx<T> p = crsub(T(1.320522), cscale(u, T(0.56419)));
  p = crsub(T(35.76683), cmul(u, p));
  p = crsub(T(219.0313), cmul(u, p));
  p = crsub(T(1540.787), cmul(u, p));
  p = crsub(T(3321.9905), cmul(u, p));
  p = crsub(T(36183.31), cmul(u, p));
  return cmul(t, p);
}

template <typename T>
__device__ __forceinline__ cplx<T> region4_den(cplx<T> u) {
  cplx<T> q = crsub(T(1.841439), u);
  q = crsub(T(61.57037), cmul(u, q));
  q = crsub(T(364.2191), cmul(u, q));
  q = crsub(T(2186.181), cmul(u, q));
  q = crsub(T(9022.228), cmul(u, q));
  q = crsub(T(24322.84), cmul(u, q));
  return crsub(T(32066.6), cmul(u, q));
}

// Re exp(u) as PyTorch's complex exp computes it: exp(x) cos(y)
template <typename T>
__device__ __forceinline__ T re_exp(cplx<T> u) {
  return exp_t(u.re) * cos_t(u.im);
}

// H(a, v) = Re w(v + i a), Humlicek (1982), physics/voigt.py humlicek_w;
// only the real part of w.  E2's evaluator: every quotient as c10's.
template <typename T>
__device__ T humlicek_H(T a, T v) {
  const T av = v < 0 ? -v : v;
  const T s = av + a;
  const cplx<T> t = {a, -v};
  if (s >= T(15.0)) return region1(t);
  if (s >= T(5.5)) return region2(t);
  if (a >= T(0.195) * av - T(0.176)) {
    return cdiv(region3_num(t), region3_den(t)).re;
  }
  const cplx<T> u = cmul(t, t);
  return re_exp(u) - cdiv(region4_num(t, u), region4_den(u)).re;
}

}  // namespace
