// The line-plus-continuum extinction of one lambda chunk for one
// direction, in one pass, and the bound-bound Voigt profile of the rates.
//
// Replaces the JAX package's compiled extinction program (no Pallas
// kernel: XLA fuses it), voronoirt_tpu/engine/lambda_iter.py
// _alpha_tot_g_impl (:130) in its sweep layouts _alpha_tot_g_t (:164,
// z-major (nz, B, nx, ny)) and _alpha_tot_g_T (:153, site-major (n, B)),
// and _alpha_tot (:122) when the damping rows are given; and the profile
// of voronoirt_tpu/physics/rates.py sigma_ij_bb (:37).
//
// vrt_alpha_tot, per cell c and wavelength b (physics/extinction.py):
//
//   a     = g[c] lam_b^2 / (4 pi c_0 dlamD[c])     (or damp[b, c] given)
//   v     = (lam_b - lam0 + lam0 v_los[c] / c_0) / dlamD[c]
//   phi   = H(a, v) / (sqrt(pi) dlamD[c])
//   alpha = hc/(4 pi lam0) phi (n_i[c] Bij - n_j[c] Bji) + a_cont[c]
//
// vrt_voigt_rows: phi alone, with v = (lam_b - lam0) / dlamD[c].
//
// H is the Humlicek w4 approximation of physics/voigt.py with the same
// region tests and coefficients, but each point evaluates only its own
// region instead of all four.  The arithmetic is the plain version's on
// the card, op by op (built with -fmad=false, kernels/build.py): complex
// products and quotients as c10::complex's, with the multiply-adds that
// PyTorch's CUDA build contracts written out as fma, the real part of a
// complex exp as exp(x) cos y, a division by a constant as PyTorch's CUDA
// kernel does it (a multiply by the reciprocal, inv_c, which the wrapper
// passes), complex128 for float64 and complex64 for float32.
//
// Bound on the card: at the production angle (215 x 256 x 256 cells,
// B = 13) the bytes, 6 per-cell fields read and B output values written
// a cell (2.14 GB in float64, 0.64 ms), are close to the operations,
// some 100 a point in the working type, region IV's rational pair and
// exp the most.  Design: one thread per cell keeps its per-cell loads in
// registers across the B wavelengths, so HBM sees each field once and
// each output once; the eager version read and wrote some hundred
// (B, cells) temporaries.  Consecutive threads take consecutive cells,
// so the z-major layout's stores coalesce; the site-major layout's B
// stores of a thread land in one or two cache lines, which L2 merges.
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

// H(a, v) = Re w(v + i a), Humlicek (1982), physics/voigt.py humlicek_w;
// only the real part of w is kept
template <typename T>
__device__ T humlicek_H(T a, T v) {
  const T av = v < 0 ? -v : v;
  const T s = av + a;
  const cplx<T> t = {a, -v};
  if (s >= T(15.0)) {
    // region I: t 0.5641896 / (0.5 + t^2)
    return cdiv(cscale(t, T(0.5641896)), cadd(T(0.5), cmul(t, t))).re;
  }
  if (s >= T(5.5)) {
    // region II: t (1.410474 + u 0.5641896) / (0.75 + u (3 + u))
    const cplx<T> u = cmul(t, t);
    return cdiv(cmul(t, cadd(T(1.410474), cscale(u, T(0.5641896)))),
                cadd(T(0.75), cmul(u, cadd(T(3.0), u)))).re;
  }
  if (a >= T(0.195) * av - T(0.176)) {
    // region III
    cplx<T> n = cadd(T(3.778987), cscale(t, T(0.5642236)));
    n = cadd(T(11.96482), cmul(t, n));
    n = cadd(T(20.20933), cmul(t, n));
    n = cadd(T(16.4955), cmul(t, n));
    cplx<T> d = cadd(T(6.699398), t);
    d = cadd(T(21.69274), cmul(t, d));
    d = cadd(T(39.27121), cmul(t, d));
    d = cadd(T(38.82363), cmul(t, d));
    d = cadd(T(16.4955), cmul(t, d));
    return cdiv(n, d).re;
  }
  // region IV: exp(u) - t P(u) / Q(u); |Re u| < 30.25 here, so the plain
  // version's clip of Re u to [-690, 690] never acts
  const cplx<T> u = cmul(t, t);
  cplx<T> p = crsub(T(1.320522), cscale(u, T(0.56419)));
  p = crsub(T(35.76683), cmul(u, p));
  p = crsub(T(219.0313), cmul(u, p));
  p = crsub(T(1540.787), cmul(u, p));
  p = crsub(T(3321.9905), cmul(u, p));
  p = crsub(T(36183.31), cmul(u, p));
  const cplx<T> numer = cmul(t, p);
  cplx<T> q = crsub(T(1.841439), u);
  q = crsub(T(61.57037), cmul(u, q));
  q = crsub(T(364.2191), cmul(u, q));
  q = crsub(T(2186.181), cmul(u, q));
  q = crsub(T(9022.228), cmul(u, q));
  q = crsub(T(24322.84), cmul(u, q));
  q = crsub(T(32066.6), cmul(u, q));
  // Re exp(u) as PyTorch's complex exp computes it: exp(x) cos(y)
  return exp_t(u.re) * cos_t(u.im) - cdiv(numer, q).re;
}

template <typename T>
__global__ void alpha_tot_kernel(
    const T* __restrict__ lam, int B, const T* __restrict__ g,
    const T* __restrict__ damp, const T* __restrict__ v_los,
    const T* __restrict__ pops, int pop_stride,
    const T* __restrict__ a_cont, const T* __restrict__ dlamD,
    T* __restrict__ out, long long n, long long inner, T lam0, T inv_c,
    T damp_k, T sqrt_pi, T line_k, T Bij, T Bji) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const T dD = dlamD[c];
  const T dK = dD * damp_k;             // 4 pi c_0 dlamD
  const T dS = dD * sqrt_pi;            // sqrt(pi) dlamD
  const T shift = v_los[c] * lam0 * inv_c;
  const T pop = pops[c * pop_stride] * Bij - pops[c * pop_stride + 1] * Bji;
  const T gc = g ? g[c] : T(0);
  const T ac = a_cont ? a_cont[c] : T(0);
  // the sweep layout, the wavelength axis second: cell c = o * inner + i
  // of the fields at (o, b, i), (nz, B, nx, ny) or (n, B)
  const long long o = c / inner;
  const long long base = o * B * inner + (c - o * inner);
  for (int b = 0; b < B; ++b) {
    const T lb = lam[b];
    const T a = damp ? damp[(long long)b * n + c] : gc * (lb * lb) / dK;
    const T v = (lb - lam0 + shift) / dD;
    const T phi = humlicek_H(a, v) / dS;
    const T al = phi * line_k * pop;
    out[base + b * inner] = a_cont ? al + ac : al;
  }
}

template <typename T>
__global__ void voigt_rows_kernel(const T* __restrict__ lam, int nb,
                                  const T* __restrict__ damp,
                                  const T* __restrict__ dlamD,
                                  T* __restrict__ out, long long n, T lam0,
                                  T sqrt_pi) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const T dD = dlamD[c];
  const T dS = dD * sqrt_pi;
  for (int b = 0; b < nb; ++b) {
    const long long i = (long long)b * n + c;
    out[i] = humlicek_H(damp[i], (lam[b] - lam0) / dD) / dS;
  }
}

}  // namespace

template <typename T>
static int launch_alpha_tot(const T* lam, const T* g, const T* damp,
                            const T* v_los, const T* pops, const T* a_cont,
                            const T* dlamD, T* out, int B, int n,
                            int pop_stride, int inner, double lam0,
                            double inv_c, double damp_k, double sqrt_pi,
                            double line_k, double Bij, double Bji,
                            void* stream) {
  if (n == 0 || B == 0) return 0;
  const int threads = 256;
  alpha_tot_kernel<T><<<(n + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(
      lam, B, g, damp, v_los, pops, pop_stride, a_cont, dlamD, out, n, inner,
      T(lam0), T(inv_c), T(damp_k), T(sqrt_pi), T(line_k), T(Bij),
      T(Bji));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_voigt_rows(const T* lam, const T* damp, const T* dlamD,
                             T* out, int nb, int n, double lam0,
                             double sqrt_pi, void* stream) {
  if (n == 0 || nb == 0) return 0;
  const int threads = 256;
  voigt_rows_kernel<T><<<(n + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(lam, nb, damp, dlamD, out,
                                                 n, T(lam0), T(sqrt_pi));
  return (int)cudaGetLastError();
}

#define VRT_ALPHA_TOT(SUFFIX, T)                                           \
  extern "C" int vrt_alpha_tot_##SUFFIX(                                   \
      const T* lam, const T* g, const T* damp, const T* v_los,             \
      const T* pops, const T* a_cont, const T* dlamD, T* out, int B,       \
      int n, int pop_stride, int inner, double lam0, double inv_c,        \
      double damp_k, double sqrt_pi, double line_k, double Bij,            \
      double Bji, void* stream) {                                          \
    return launch_alpha_tot<T>(lam, g, damp, v_los, pops, a_cont, dlamD,   \
                               out, B, n, pop_stride, inner, lam0, inv_c, \
                               damp_k, sqrt_pi, line_k, Bij, Bji, stream); \
  }                                                                        \
  extern "C" int vrt_voigt_rows_##SUFFIX(const T* lam, const T* damp,      \
                                         const T* dlamD, T* out, int nb,   \
                                         int n, double lam0,               \
                                         double sqrt_pi, void* stream) {   \
    return launch_voigt_rows<T>(lam, damp, dlamD, out, nb, n, lam0,        \
                                sqrt_pi, stream);                          \
  }

VRT_ALPHA_TOT(f64, double)
VRT_ALPHA_TOT(f32, float)
