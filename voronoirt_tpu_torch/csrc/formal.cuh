// Shared device helpers of the regular-sweep kernels.
//
// linear_weights is solvers/formal.py::linear_weights per point: the
// same thresholds (Taylor guard below dtau = 5e-4, large-dtau limit above
// 50 dividing by the true dtau, functions.jl:484-500) and the same
// expressions, branched per point instead of selected with where().
// A NaN dtau falls through to the middle branch and yields NaN weights,
// as the where() form does.  Built with -fmad=false (kernels/build.py),
// every kernel rounds op by op in the plain version's order.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ void linear_weights(T dtau, T& a, T& b, T& e) {
  if (dtau < T(5e-4)) {
    e = T(1) - dtau + T(0.5) * dtau * dtau;
    a = dtau * (T(0.5) - dtau / T(3));
    b = dtau * (T(0.5) - dtau / T(6));
  } else if (dtau > T(50)) {
    a = T(1) / dtau;
    b = T(1) - a;
    e = T(0);
  } else {
    const T ex = exp_t(-dtau);
    a = (T(1) - ex) / dtau - ex;
    b = T(1) - a - ex;
    e = ex;
  }
}

// bezier_weights is solvers/formal.py::bezier_weights per point: the
// series below dtau = 0.05 (its divisions by 36, 90, 360 and 6 true
// divisions, as the plain version makes them), the large-dtau limit above
// 50 on the true dtau, its scalar-over-tensor terms as PyTorch evaluates
// them (2 / x is reciprocal(x) * 2), and the J_k form between, where the
// plain version's clamp is the identity.  A NaN dtau falls through to the
// middle branch.  Returns (w_up, w_c, w_ctrl, exp(-dtau)) in wu, wc, wk, e.
template <typename T>
__device__ __forceinline__ void bezier_weights(T d, T& wu, T& wc, T& wk,
                                               T& e) {
  if (d < T(0.05)) {
    wu = d * (T(1.0 / 3.0) + d * (d * (T(0.1) - d / T(36)) + T(-0.25)));
    wk = d * (T(1.0 / 3.0) + d * (d * (T(0.05) - d / T(90))
                                  + T(-1.0 / 6.0)));
    wc = d * (T(1.0 / 3.0) + d * (d * (T(1.0 / 60.0) - d / T(360))
                                  + T(-1.0 / 12.0)));
    e = ((T(1) - d) + T(0.5) * d * d) - d * d * d / T(6);
  } else if (d > T(50)) {
    const T r1 = T(1) / d, r2 = T(1) / (d * d);
    wu = r2 * T(2);
    wk = r1 * T(2) - r2 * T(4);
    wc = (T(1) - r1 * T(2)) + r2 * T(2);
    e = T(0);
  } else {
    const T E = exp_t(-d);
    const T J0 = T(1) - E;
    const T J1 = d - J0;
    const T J2 = d * d - T(2) * J1;
    const T q = J2 / (d * d);
    wu = (J0 - T(2) * J1 / d) + q;
    wk = T(2) * (J1 / d - q);
    wc = q;
    e = E;
  }
}

template <typename T> __device__ __forceinline__ T bezier_eps();
template <> __device__ __forceinline__ float bezier_eps<float>() {
  return 1e-30f;
}
template <> __device__ __forceinline__ double bezier_eps<double>() {
  return 1e-300;
}

// max(x, lo) with a NaN x kept, as torch.clamp(x, min=lo).
template <typename T>
__device__ __forceinline__ T clamp_min_t(T x, T lo) {
  return x < lo ? lo : x;
}

// torch.minimum: NaN if either is NaN.
template <typename T>
__device__ __forceinline__ T minimum_t(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// bezier_control is solvers/formal.py::bezier_control per point: the
// Steffen-limited slope at the upwind node, the secant slope d2 mixed in
// as (1 - first) slope + first d2 with the plain version's Python-float
// factors (omf = 1 - first, f = first, rounded to T), and
// C = S_up + (0.5 dtau) slope.
template <typename T>
__device__ __forceinline__ T bezier_control(T S_uu, T S_up, T S_c, T dtau_uu,
                                            T dtau, T omf, T f) {
  const T h1 = clamp_min_t(dtau_uu, bezier_eps<T>());
  const T h2 = clamp_min_t(dtau, bezier_eps<T>());
  const T d1 = (S_up - S_uu) / h1;
  const T d2 = (S_c - S_up) / h2;
  const T p = (d1 * h2 + d2 * h1) / (h1 + h2);
  T slope = T(0);
  if (d1 * d2 > T(0)) {
    const T m = minimum_t(fabs(p), T(2) * minimum_t(fabs(d1), fabs(d2)));
    slope = (d2 > T(0) ? T(1) : T(-1)) * m;
  }
  slope = omf * slope + f * d2;
  return S_up + T(0.5) * dtau * slope;
}

// Periodic index: i mod n in [0, n) for any sign of i.
__device__ __forceinline__ int wrap(int i, int n) {
  return ((i % n) + n) % n;
}
