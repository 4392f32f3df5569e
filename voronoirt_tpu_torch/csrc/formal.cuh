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

// Periodic index: i mod n in [0, n) for any sign of i.
__device__ __forceinline__ int wrap(int i, int n) {
  return ((i % n) + n) % n;
}
