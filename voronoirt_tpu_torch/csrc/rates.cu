// The streamed iteration's per-chunk rate accumulation (R1) and S update
// (S1), one launch each a lambda chunk.
//
// Replaces the JAX package's two jitted programs a lambda chunk (no
// Pallas kernel: XLA fuses them): voronoirt_tpu/engine/lambda_iter.py
// _rates_accum (:254, which traces physics/rates.py calculate_R_chunk,
// :167) and _s_update_stream (:236).
//
// vrt_rates_chunk (physics/rates.py calculate_R_chunk), per cell c, for
// each rate window the block holds -- bf0 (levels 0 -> 2), bf1 (1 -> 2),
// bb (0 -> 1) -- and each of its block rows r (global row r0 + r):
//
//   sigma = sigma_bf[r]                                     (bf: a row)
//         = sigma_bb H(a, v) / (dlamD sqrt(pi))             (bb: a point)
//           a = g lam^2 / (4 pi c_0 dlamD), v = (lam - lam0) / dlamD
//   G     = (n_i / n_j) exp((1 / (lam T)) (-hc / k_B))
//   f_ij  = (lam sigma) (J IUNIT)
//   f_ji  = (((sigma lam) IUNIT) G) (P[r] + J)   P[r] = exp(c - 5 log lam)
//
// then over the window's pairs, in pair order from the first, the sums
// s = sum (f_l + f_{l+1}) dlam_l, and
//
//   R_ij = s_ij [0.5 'fixed'] (2 pi / hc) [/ 1000 'reference']
//   R_ji = s_ji [0.5 'fixed'] (2 pi / hc)
//
// added into the running rate in place (or written, where the window is
// new to the accumulator).  The block's rows are the J rows and, where
// given, the previous chunk's last row ahead of them (`lead`: no cat).
// The per-row quantities (lam, dlam, the bf sigma rows, P) come from the
// wrapper, which forms them with the plain version's own torch ops.
//
// vrt_s_update (engine/s_update.py), per point of the chunk's rows b:
//
//   x     = max((1 / (lam_b T)) (hc / k_B), 1e-9)     (NaN stays NaN)
//   S_new = (1 - eps) J + eps pre_b / expm1(x),   pre_b = exp(c - 5 log lam_b)
//   d     = |S_new - S_old| / |S_new, or 1 where S_new is 0|
//
// S_new written over S_old in place; the largest d folded a block and
// into one value with one atomicMax on its bit pattern (a non-negative
// float orders as its bits do; a NaN is made the positive quiet NaN,
// whose bits lie above +inf's, so a NaN anywhere gives NaN, as torch.max).
//
// Rounding: the plain versions' on the card, op by op (built with
// -fmad=false, kernels/build.py): a scalar's division as PyTorch's
// (s / x is x.reciprocal() * s, x / s is x * (1 / s)), lam^2 as lam lam,
// libdevice's exp and expm1 as PyTorch's CUDA kernels call them, and the
// Voigt profile as E2's (csrc/voigt.cuh humlicek_H, shared).
//
// Bound on the card, by the roofline: bytes.  R1 reads each J row once
// (13-14 a chunk, 91 in the standard loop's launch), the per-cell
// fields once and the accumulators once, and in float64 its bound-bound
// rows add a Humlicek evaluation a point (60-110 FP64 operations, the
// same order as the bytes' time); S1 reads J and S_old and writes
// S_new, 24 bytes a point in float64.
//
// R1's design: one thread a cell loops over the block's rows, so each
// per-cell field is read once and the rows' loads coalesce across the
// warp; each point's f is formed once and carried to the next pair in
// registers, in the row order of the plain version; 64-bit offsets (a
// 14M-cell row times 14 rows passes 2^31).  A launch without a
// bound-bound window runs an instance that compiles no Humlicek
// evaluation, so a thread needs fewer registers and an SM holds more
// warps.  Measured on the card (PERF.md section 6), R1 is bound by
// instruction issue, not by bytes -- a bound-bound point issues 370-580
// instructions (120-220 FP64), a bound-free one ~145 (39 FP64) -- so
// what moves it is the warps an SM holds, not the bytes in flight (the
// section compares this design with a ring of J rows in shared memory
// filled by bulk copies, TMA).
#include "voigt.cuh"

#define R1_THREADS 256
#define S1_THREADS 256

namespace {

__device__ __forceinline__ float expm1_t(float x) { return expm1f(x); }
__device__ __forceinline__ double expm1_t(double x) { return expm1(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

// a rate window of one R1 launch: block rows lo..hi (hi > lo), its kind
// (0 bf0, 1 bf1, 2 bb), whether the rates add into out or are written
template <typename T>
struct RWindow {
  int lo, hi, kind, add;
  T* out_ij;
  T* out_ji;
};

template <typename T>
struct R1Args {
  const T* J;          // the block's rows after the lead, row_stride apart
  const T* lead;       // block row 0, or NULL
  const T* lam;        // (n_rows,)
  const T* dlam;       // (n_rows - 1,): lam[r + 1] - lam[r]
  const T* sig;        // (n_rows,): the bf sigma rows (0 on bb rows)
  const T* planck;     // (n_rows,)
  const T* g;          // per-cell gamma
  const T* dlamD;
  const T* temp;
  const T* lte;        // (cells, lte_stride): the LTE populations
  long long n, row_stride;
  int lte_stride, n_win, fixed, reference;
  RWindow<T> win[3];
  T lam0, sqrt_pi, damp_k, sigma_bb, iunit, neg_hc_k, k2pi_hc, inv_1000;
};

// BB: the launch holds a bound-bound window (the Humlicek evaluation is
// compiled in); without one a thread needs fewer registers.
template <typename T, bool BB>
__global__ void __launch_bounds__(R1_THREADS)
rates_chunk_kernel(const __grid_constant__ R1Args<T> p) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p.n) return;
  const T tc = p.temp[c];
  const T* pop = p.lte + c * p.lte_stride;
  const int lead = p.lead != nullptr;
#pragma unroll 1
  for (int w = 0; w < p.n_win; ++w) {
    const RWindow<T> wn = p.win[w];
    const bool bb = BB && wn.kind == 2;
    // (n_i / n_j): bb 0 / 1, bf0 0 / 2, bf1 1 / 2
    const T nr = bb ? pop[0] / pop[1] : pop[wn.kind] / pop[2];
    T dD = T(0), dK = T(0), dS = T(0), gc = T(0);
    if (bb) {
      dD = p.dlamD[c];
      dK = dD * p.damp_k;
      dS = dD * p.sqrt_pi;
      gc = p.g[c];
    }
    T f_ij = T(0), f_ji = T(0), s_ij = T(0), s_ji = T(0);
#pragma unroll 1
    for (int r = wn.lo; r <= wn.hi; ++r) {
      const T* row = (lead && r == 0)
                         ? p.lead
                         : p.J + (long long)(r - lead) * p.row_stride;
      const T j = row[c];
      const T lb = p.lam[r];
      T sig;
      if (bb) {
        const T a = gc * (lb * lb) / dK;
        const T v = (lb - p.lam0) / dD;
        sig = (humlicek_H(a, v) / dS) * p.sigma_bb;
      } else {
        sig = p.sig[r];
      }
      const T G = nr * exp_t((T(1) / (lb * tc)) * p.neg_hc_k);
      const T e_ij = (lb * sig) * (j * p.iunit);
      const T e_ji = (((sig * lb) * p.iunit) * G) * (p.planck[r] + j);
      if (r > wn.lo) {
        const T dl = p.dlam[r - 1];
        const T c_ij = (f_ij + e_ij) * dl;
        const T c_ji = (f_ji + e_ji) * dl;
        if (r == wn.lo + 1) {
          s_ij = c_ij;
          s_ji = c_ji;
        } else {
          s_ij = s_ij + c_ij;
          s_ji = s_ji + c_ji;
        }
      }
      f_ij = e_ij;
      f_ji = e_ji;
    }
    if (p.fixed) {
      s_ij = s_ij * T(0.5);
      s_ji = s_ji * T(0.5);
    }
    T r_ij = s_ij * p.k2pi_hc;
    if (p.reference) r_ij = r_ij * p.inv_1000;
    const T r_ji = s_ji * p.k2pi_hc;
    wn.out_ij[c] = wn.add ? wn.out_ij[c] + r_ij : r_ij;
    wn.out_ji[c] = wn.add ? wn.out_ji[c] + r_ji : r_ji;
  }
}

// the bit pattern a value's maximum is taken on: the value's own for a
// non-negative one, the positive quiet NaN's for a NaN
__device__ __forceinline__ unsigned long long max_bits(double x) {
  return x != x ? 0x7ff8000000000000ull
                : (unsigned long long)__double_as_longlong(x);
}
__device__ __forceinline__ unsigned int max_bits(float x) {
  return x != x ? 0x7fc00000u : __float_as_uint(x);
}

template <typename T>
struct Bits;
template <>
struct Bits<double> {
  using U = unsigned long long;
};
template <>
struct Bits<float> {
  using U = unsigned int;
};

template <typename T>
__global__ void __launch_bounds__(S1_THREADS)
s_update_kernel(const T* __restrict__ J, T* __restrict__ S,
                const T* __restrict__ eps, const T* __restrict__ temp,
                const T* __restrict__ lam, const T* __restrict__ pre,
                long long n, int nb, T hc_k, T x_min,
                typename Bits<T>::U* __restrict__ out_bits) {
  using U = typename Bits<T>::U;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  U m = 0;
  if (c < n) {
    const T e = eps[c];
    const T one_e = T(1) - e;
    const T tc = temp[c];
#pragma unroll 1
    for (int b = 0; b < nb; ++b) {
      const long long i = (long long)b * n + c;
      T x = (T(1) / (lam[b] * tc)) * hc_k;
      if (!(x != x) && x < x_min) x = x_min;
      const T B = pre[b] / expm1_t(x);
      const T s_new = one_e * J[i] + e * B;
      const T s_old = S[i];
      const T den = s_new != T(0) ? s_new : T(1);
      const T d = abs_t(s_new - s_old) / abs_t(den);
      S[i] = s_new;
      const U u = max_bits(d);
      m = u > m ? u : m;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const U v = __shfl_down_sync(0xffffffffu, m, o);
    m = v > m ? v : m;
  }
  __shared__ U warp_max[S1_THREADS / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_max[wid] = m;
  __syncthreads();
  if (wid == 0) {
    m = lane < S1_THREADS / 32 ? warp_max[lane] : U(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const U v = __shfl_down_sync(0xffffffffu, m, o);
      m = v > m ? v : m;
    }
    if (lane == 0) atomicMax(out_bits, m);
  }
}

}  // namespace

template <typename T>
static int launch_rates_chunk(const T* J, const T* lead, const T* lam,
                              const T* dlam, const T* sig, const T* planck,
                              const T* g, const T* dlamD, const T* temp,
                              const T* lte, void* const* outs,
                              const int* win, int n_win, long long n,
                              long long row_stride, int lte_stride,
                              int fixed, int reference, double lam0,
                              double sqrt_pi, double damp_k,
                              double sigma_bb, double iunit,
                              double neg_hc_k, double k2pi_hc,
                              double inv_1000, void* stream) {
  if (n_win < 0 || n_win > 3) return (int)cudaErrorInvalidValue;
  if (n == 0 || n_win == 0) return 0;
  R1Args<T> p = {};
  p.J = J;
  p.lead = lead;
  p.lam = lam;
  p.dlam = dlam;
  p.sig = sig;
  p.planck = planck;
  p.g = g;
  p.dlamD = dlamD;
  p.temp = temp;
  p.lte = lte;
  p.n = n;
  p.row_stride = row_stride;
  p.lte_stride = lte_stride;
  p.n_win = n_win;
  p.fixed = fixed;
  p.reference = reference;
  bool bb = false;
  for (int w = 0; w < n_win; ++w) {
    const int* q = win + 4 * w;
    if (q[1] <= q[0] || q[0] < 0 || q[2] < 0 || q[2] > 2) {
      return (int)cudaErrorInvalidValue;
    }
    p.win[w] = {q[0], q[1], q[2], q[3], (T*)outs[2 * w],
                (T*)outs[2 * w + 1]};
    bb |= q[2] == 2;
  }
  p.lam0 = T(lam0);
  p.sqrt_pi = T(sqrt_pi);
  p.damp_k = T(damp_k);
  p.sigma_bb = T(sigma_bb);
  p.iunit = T(iunit);
  p.neg_hc_k = T(neg_hc_k);
  p.k2pi_hc = T(k2pi_hc);
  p.inv_1000 = T(inv_1000);
  const long long blocks = (n + R1_THREADS - 1) / R1_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel =
      bb ? rates_chunk_kernel<T, true> : rates_chunk_kernel<T, false>;
  kernel<<<(unsigned)blocks, R1_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_s_update(const T* J, T* S, const T* eps, const T* temp,
                           const T* lam, const T* pre, long long n, int nb,
                           double hc_k, double x_min, void* out_bits,
                           void* stream) {
  if (n == 0 || nb == 0) return 0;
  const unsigned blocks = (unsigned)((n + S1_THREADS - 1) / S1_THREADS);
  s_update_kernel<T><<<blocks, S1_THREADS, 0, (cudaStream_t)stream>>>(
      J, S, eps, temp, lam, pre, n, nb, T(hc_k), T(x_min),
      (typename Bits<T>::U*)out_bits);
  return (int)cudaGetLastError();
}

#define VRT_RATES(SUFFIX, T)                                                \
  extern "C" int vrt_rates_chunk_##SUFFIX(                                  \
      const T* J, const T* lead, const T* lam, const T* dlam, const T* sig, \
      const T* planck, const T* g, const T* dlamD, const T* temp,           \
      const T* lte, void* const* outs, const int* win, int n_win,           \
      long long n, long long row_stride, int lte_stride, int fixed,         \
      int reference, double lam0, double sqrt_pi, double damp_k,            \
      double sigma_bb, double iunit, double neg_hc_k, double k2pi_hc,       \
      double inv_1000, void* stream) {                                      \
    return launch_rates_chunk<T>(J, lead, lam, dlam, sig, planck, g, dlamD, \
                                 temp, lte, outs, win, n_win, n,            \
                                 row_stride, lte_stride, fixed, reference,  \
                                 lam0, sqrt_pi, damp_k, sigma_bb, iunit,    \
                                 neg_hc_k, k2pi_hc, inv_1000, stream);      \
  }                                                                         \
  extern "C" int vrt_s_update_##SUFFIX(                                     \
      const T* J, T* S, const T* eps, const T* temp, const T* lam,          \
      const T* pre, long long n, int nb, double hc_k, double x_min,         \
      void* out_bits, void* stream) {                                       \
    return launch_s_update<T>(J, S, eps, temp, lam, pre, n, nb, hc_k,       \
                              x_min, out_bits, stream);                     \
  }

VRT_RATES(f64, double)
VRT_RATES(f32, float)
