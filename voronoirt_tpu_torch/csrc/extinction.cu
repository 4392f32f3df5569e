// The line-plus-continuum extinction of one lambda chunk (E1), for one
// direction or for a mirror group of directions at once, and the
// bound-bound Voigt profile of the rates (E2).
//
// Replaces the JAX package's compiled extinction program (no Pallas
// kernel: XLA fuses it), voronoirt_tpu/engine/lambda_iter.py
// _alpha_tot_g_impl (:130) in its sweep layouts _alpha_tot_g_t (:164,
// z-major (nz, B, nx, ny)) and _alpha_tot_g_T (:153, site-major (n, B)),
// and _alpha_tot (:122) when the damping rows are given, together with
// the flipped concatenation of a mirror group's extinctions in
// voronoirt_tpu/solvers/sweep_regular.py sweep_group_J (:853-880); and
// the profile of voronoirt_tpu/physics/rates.py sigma_ij_bb (:37).
//
// vrt_alpha_tot, per cell c, angle e and wavelength b
// (physics/extinction.py alpha_tot and alpha_tot_group):
//
//   v_los = v[c] . k_e                           (or the v_los field given)
//   a     = g[c] lam_b^2 / (4 pi c_0 dlamD[c])   (or damp[b, c] given)
//   v     = (lam_b - lam0 + lam0 v_los / c_0) / dlamD[c]
//   f     = hc/(4 pi lam0) (n_i[c] Bij - n_j[c] Bji) / (sqrt(pi) dlamD[c])
//   alpha = H(a, v) f + a_cont[c]
//
// stored at angle e's flipped address of the group's stack (nz, P B, nx,
// ny): z, x and y each mirrored where the angle's flips say.
//
// vrt_voigt_rows: phi = H(a, v) / (sqrt(pi) dlamD) alone, with v = (lam_b -
// lam0) / dlamD[c].
//
// H is the Humlicek w4 approximation of physics/voigt.py with the same
// region tests and coefficients, but each point evaluates only its own
// region instead of all four.  The arithmetic is the plain versions' on
// the card, op by op (built with -fmad=false, kernels/build.py): complex
// products and quotients as c10::complex's, with the multiply-adds that
// PyTorch's CUDA build contracts written out as fma, the real part of a
// complex exp as exp(x) cos y, a division by a constant as PyTorch's CUDA
// kernel does it (a multiply by the reciprocal, inv_c, which the wrapper
// passes), complex128 for float64 and complex64 for float32.  E2's
// evaluator humlicek_H and the complex helpers live in csrc/voigt.cuh,
// which the rates' kernel R1 (csrc/rates.cu) includes too; E1 has its
// own, e1_H, whose regions III and IV take the real part of their
// quotient with one division, and folds the profile's denominator and
// the line factor into one per-cell f.
// Both keep a and v as they were, so no point changes region.
//
// Bound on the card: E1 is a pointwise complex rational function, some
// 80-180 double-precision instructions a point (a region IV point the
// most: its exp and cos), so in float64 it is bound by FP64 instruction
// issue rather than by its bytes (tools/e1_sass.py counts them from the
// compiled code).  Design: one thread a cell loads each per-cell field
// once for all the group's angles and wavelengths (the velocity
// instead of a v_los field per angle, v . k taken in registers), keeps
// the per-cell terms in registers, and computes the two divisions of a
// and v as before but no other; consecutive threads take consecutive
// cells, and a mirrored row is still one contiguous run, so the flipped
// stores coalesce; the site-major layout's B stores of a thread land in
// one or two cache lines, which L2 merges.  Tensor cores and TMA buy
// nothing here.
#include "voigt.cuh"

// the most angles of one alpha_tot_group launch: a mirror group holds
// at most the 4 xy quadrants of an up and a down direction
#define E1_MAX_ANGLES 8
// E1's block: 256 threads with the registers left to ptxas; other
// block sizes and register caps were no faster (PERF.md section 6)
#define E1_THREADS 256

namespace {

// Re(n / d) with one division, (n.re d.re + n.im d.im) / |d|^2, for E1's
// regions III and IV.  There |t| < 5.5 and |u| = |t|^2 < 30.25, so |d|
// stays below 2e4 (III) and 3e10 (IV) and |n| below 3e9: no term
// overflows even in float32; and d has no zero for Re t = a >= 0.
template <typename T>
__device__ __forceinline__ T re_quot(cplx<T> n, cplx<T> d) {
  return (n.re * d.re + n.im * d.im) / (d.re * d.re + d.im * d.im);
}

// E1's evaluator: humlicek_H's region tests and regions I and II, the
// real part of region III's and IV's quotient with one division
// (physics/extinction.py _e1_H is its plain version)
template <typename T>
__device__ __forceinline__ T e1_H(T a, T v) {
  const T av = v < 0 ? -v : v;
  const T s = av + a;
  const cplx<T> t = {a, -v};
  if (s >= T(15.0)) return region1(t);
  if (s >= T(5.5)) return region2(t);
  if (a >= T(0.195) * av - T(0.176)) {
    return re_quot(region3_num(t), region3_den(t));
  }
  const cplx<T> u = cmul(t, t);
  return re_exp(u) - re_quot(region4_num(t, u), region4_den(u));
}

// one E1 launch: the cells (nz, nx, ny) (a site-major (n,) grid as (n,
// 1, 1)), P angles of B wavelengths, out (nz, P B, nx, ny)
template <typename T>
struct E1Args {
  const T* lam;
  const T* g;       // per-cell gamma, or NULL with damp
  const T* damp;    // damping rows (B, cells), or NULL with g
  const T* vel;     // velocity (cells, 3), or the v_los field (cells)
  const T* pops;    // (cells, pop_stride): n_i, n_j first
  const T* a_cont;  // or NULL: the line's extinction alone
  const T* dlamD;
  T* out;
  int B, P, pop_stride;
  long long nz, nx, ny;
  T lam0, inv_c, damp_k, sqrt_pi, line_k, Bij, Bji;
  T k[E1_MAX_ANGLES][3];        // -k_e, as line_of_sight_velocity takes it
  int flip[E1_MAX_ANGLES];      // bit 0: x, bit 1: y, bit 2: z
};

// kVel: the velocity is given and each angle's v_los is taken in
// registers; else the v_los field is read (P = 1)
template <typename T, bool kVel>
__global__ void __launch_bounds__(E1_THREADS)
alpha_tot_kernel(const __grid_constant__ E1Args<T> p) {
  const long long inner = p.nx * p.ny;
  const long long n = p.nz * inner;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const T dD = p.dlamD[c];
  const T dK = dD * p.damp_k;             // 4 pi c_0 dlamD
  const T pop = p.pops[c * p.pop_stride] * p.Bij -
                p.pops[c * p.pop_stride + 1] * p.Bji;
  // the line factor over the profile's denominator, once a cell
  const T f = (pop * p.line_k) / (dD * p.sqrt_pi);
  const T gc = p.g ? p.g[c] : T(0);
  const T ac = p.a_cont ? p.a_cont[c] : T(0);
  T vz, vx = T(0), vy = T(0);
  if (kVel) {
    vz = p.vel[3 * c];
    vx = p.vel[3 * c + 1];
    vy = p.vel[3 * c + 2];
  } else {
    vz = p.vel[c];
  }
  const long long z = c / inner;
  const long long x = (c - z * inner) / p.ny;
  const long long y = c - z * inner - x * p.ny;
  const long long PB = (long long)p.P * p.B;
#pragma unroll 1
  for (int e = 0; e < p.P; ++e) {
    // v . (-k) rounded as line_of_sight_velocity: products, then the
    // sums left to right
    const T v_los =
        kVel ? vz * p.k[e][0] + vx * p.k[e][1] + vy * p.k[e][2] : vz;
    const T shift = v_los * p.lam0 * p.inv_c;
    const int fl = p.flip[e];
    const long long zo = (fl & 4) ? p.nz - 1 - z : z;
    const long long xo = (fl & 1) ? p.nx - 1 - x : x;
    const long long yo = (fl & 2) ? p.ny - 1 - y : y;
    T* o = p.out + (zo * PB + (long long)e * p.B) * inner + xo * p.ny + yo;
#pragma unroll 1
    for (int b = 0; b < p.B; ++b) {
      const T lb = p.lam[b];
      const T a = p.damp ? p.damp[(long long)b * n + c] : gc * (lb * lb) / dK;
      const T v = (lb - p.lam0 + shift) / dD;
      const T al = e1_H(a, v) * f;
      o[(long long)b * inner] = p.a_cont ? al + ac : al;
    }
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
                            const T* vel, const T* pops, const T* a_cont,
                            const T* dlamD, T* out, int B, int P, int nz,
                            int nx, int ny, int pop_stride,
                            int with_velocity, const double* ks,
                            const int* flips, double lam0, double inv_c,
                            double damp_k, double sqrt_pi, double line_k,
                            double Bij, double Bji, void* stream) {
  if (P < 1 || P > E1_MAX_ANGLES || (!with_velocity && P != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)nz * nx * ny;
  if (n == 0 || B == 0) return 0;
  E1Args<T> p = {};
  p.lam = lam;
  p.g = g;
  p.damp = damp;
  p.vel = vel;
  p.pops = pops;
  p.a_cont = a_cont;
  p.dlamD = dlamD;
  p.out = out;
  p.B = B;
  p.P = P;
  p.pop_stride = pop_stride;
  p.nz = nz;
  p.nx = nx;
  p.ny = ny;
  p.lam0 = T(lam0);
  p.inv_c = T(inv_c);
  p.damp_k = T(damp_k);
  p.sqrt_pi = T(sqrt_pi);
  p.line_k = T(line_k);
  p.Bij = T(Bij);
  p.Bji = T(Bji);
  for (int e = 0; e < P; ++e) {
    for (int j = 0; j < 3; ++j) {
      p.k[e][j] = with_velocity ? T(ks[3 * e + j]) : T(0);
    }
    p.flip[e] = flips ? flips[e] : 0;
  }
  const unsigned blocks = (unsigned)((n + E1_THREADS - 1) / E1_THREADS);
  if (with_velocity) {
    alpha_tot_kernel<T, true>
        <<<blocks, E1_THREADS, 0, (cudaStream_t)stream>>>(p);
  } else {
    alpha_tot_kernel<T, false>
        <<<blocks, E1_THREADS, 0, (cudaStream_t)stream>>>(p);
  }
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

#define VRT_ALPHA_TOT(SUFFIX, T)                                            \
  extern "C" int vrt_alpha_tot_##SUFFIX(                                    \
      const T* lam, const T* g, const T* damp, const T* vel,                \
      const T* pops, const T* a_cont, const T* dlamD, T* out, int B,        \
      int P, int nz, int nx, int ny, int pop_stride, int with_velocity,     \
      const double* ks, const int* flips, double lam0, double inv_c,        \
      double damp_k, double sqrt_pi, double line_k, double Bij,             \
      double Bji, void* stream) {                                           \
    return launch_alpha_tot<T>(lam, g, damp, vel, pops, a_cont, dlamD, out, \
                               B, P, nz, nx, ny, pop_stride, with_velocity, \
                               ks, flips, lam0, inv_c, damp_k, sqrt_pi,     \
                               line_k, Bij, Bji, stream);                   \
  }                                                                         \
  extern "C" int vrt_voigt_rows_##SUFFIX(const T* lam, const T* damp,       \
                                         const T* dlamD, T* out, int nb,    \
                                         int n, double lam0,                \
                                         double sqrt_pi, void* stream) {    \
    return launch_voigt_rows<T>(lam, damp, dlamD, out, nb, n, lam0,         \
                                sqrt_pi, stream);                           \
  }

VRT_ALPHA_TOT(f64, double)
VRT_ALPHA_TOT(f32, float)
