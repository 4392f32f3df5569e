// One z-plane of the regular sweep's xy plane-cut case with the
// quadratic-Bezier source integration (X1).
//
// Replaces no Pallas kernel: the JAX package runs this step as plain XLA,
// the body of the lax.scan over an xy segment in its jitted sweep
// (voronoirt_tpu/solvers/sweep_regular.py _xy_step_bezier, :245; the scan
// at :492-511), where it bypasses pallas_xy.py.  The port ran it as ~150
// eager tensor operations a plane; X1 is one launch a plane.  It computes
// what solvers/xy_bezier.py xy_bezier_plain computes, per output point of
// contiguous (B, Nx, Ny) planes:
//
//   st(A, f, g) = lerp_x(lerp_y(A)) at (x + sxs + f, y + sys + g), periodic
//   a_up = st(alpha_p, fx, fy), S_up = st(S_p, ...), I_up = st(I_p, ...)
//   a_uu = st(st(alpha_pp, fx_prev, fy_prev), fx, fy), S_uu likewise
//   dtau    = r (alpha_c + a_up) 0.5,  dtau_uu = r_prev (a_up + a_uu) 0.5
//   C       = bezier_control(S_uu, S_up, S_c, dtau_uu, dtau, first)
//   I_new   = e(dtau) I_up + w_up(dtau) S_up + w_c(dtau) S_c + w_ctrl(dtau) C
//
// The geometry (r, fx, fy, their _prev, first) is one direction's, shared
// by the batch, and passes as doubles: the plain version takes Python
// floats, so 1 - fx is formed in double and rounded to T, as PyTorch
// rounds a Python scalar factor.  The composed stencil is the inner
// stencil evaluated at the outer stencil's four taps: 16 reads of the
// 3x3 neighbourhood at (x + 2 sxs + {0, 1, 2}, y + 2 sys + {0, 1, 2}),
// which each thread loads once.  Every expression rounds op by op in the
// plain version's order (built with -fmad=false, kernels/build.py;
// csrc/formal.cuh bezier_weights and bezier_control), so on the card X1
// is bit-equal to the plain version.
//
// Bound on the card: HBM bytes.  Per point it reads seven planes and
// writes one, 64 B in float64 (32 B in float32): 54.5 MB, 16.3 us at
// (13, 256, 256) and 3.35 TB/s (f32 8.1 us).  Its arithmetic is ~174
// FP64 operations a point, counting each of its six divisions and its
// exp as one (4.4 us at 34 TFLOP/s): the smaller bound, though the
// divisions and the exp are long instruction sequences on the card.  The
// stencils' re-reads (9 taps each of alpha_pp and S_pp, 4 of the other
// upwind planes) hit L1 and L2, so HBM sees each plane about once.
//
// Design: one thread per output point, consecutive threads on consecutive
// y, so a warp's tap loads are one or two contiguous segments; one launch
// a plane, the carried plane in device memory between launches.  The
// unsplit sweep runs a segment a launch instead, the carried plane
// on chip (xy_bezier_segment.cu); this kernel steps split grids' padded
// tiles and planes whose band does not fit that kernel.
#include "formal.cuh"

template <typename T>
__global__ void __launch_bounds__(256)
xy_bezier_kernel(const T* __restrict__ i_p, const T* __restrict__ a_c,
                 const T* __restrict__ a_p, const T* __restrict__ s_c,
                 const T* __restrict__ s_p, const T* __restrict__ a_pp,
                 const T* __restrict__ s_pp, T* __restrict__ out, int B,
                 int nx, int ny, int sxs, int sys, double r, double fx,
                 double fy, double r_prev, double fx_prev, double fy_prev,
                 double first) {
  const long long plane = (long long)nx * ny;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * plane) return;
  const int b = (int)(idx / plane);
  const int rem = (int)(idx - (long long)b * plane);
  const int x = rem / ny;
  const int y = rem - x * ny;
  const long long base = (long long)b * plane;

  // this step's stencil weights and the previous step's
  const T wx0 = T(1.0 - fx), wx1 = T(fx), wy0 = T(1.0 - fy), wy1 = T(fy);
  const T px0 = T(1.0 - fx_prev), px1 = T(fx_prev);
  const T py0 = T(1.0 - fy_prev), py1 = T(fy_prev);

  // rows and columns of the outer taps (x + sxs + {0, 1}) and of the
  // composed stencil's inner taps (x + 2 sxs + {0, 1, 2})
  long long row1[2], row2[3];
  int col1[2], col2[3];
  for (int k = 0; k < 2; ++k) {
    row1[k] = base + (long long)wrap(x + sxs + k, nx) * ny;
    col1[k] = wrap(y + sys + k, ny);
  }
  for (int k = 0; k < 3; ++k) {
    row2[k] = base + (long long)wrap(x + 2 * sxs + k, nx) * ny;
    col2[k] = wrap(y + 2 * sys + k, ny);
  }

  auto st = [&](const T* A) {
    const T lo = wy0 * A[row1[0] + col1[0]] + wy1 * A[row1[0] + col1[1]];
    const T hi = wy0 * A[row1[1] + col1[0]] + wy1 * A[row1[1] + col1[1]];
    return wx0 * lo + wx1 * hi;
  };
  // st(st(A, fx_prev, fy_prev), fx, fy): the inner stencil at each of
  // the outer stencil's taps (i, j)
  auto st2 = [&](const T* A) {
    T v[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) v[i][j] = A[row2[i] + col2[j]];
    T in[2][2];
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) {
        const T lo = py0 * v[i][j] + py1 * v[i][j + 1];
        const T hi = py0 * v[i + 1][j] + py1 * v[i + 1][j + 1];
        in[i][j] = px0 * lo + px1 * hi;
      }
    const T lo = wy0 * in[0][0] + wy1 * in[0][1];
    const T hi = wy0 * in[1][0] + wy1 * in[1][1];
    return wx0 * lo + wx1 * hi;
  };

  const T a_up = st(a_p);
  const T S_up = st(s_p);
  const T I_up = st(i_p);
  const T a_uu = st2(a_pp);
  const T S_uu = st2(s_pp);
  const T Sc = s_c[idx];
  const T dtau = T(r) * (a_c[idx] + a_up) * T(0.5);
  const T dtau_uu = T(r_prev) * (a_up + a_uu) * T(0.5);
  const T C = bezier_control(S_uu, S_up, Sc, dtau_uu, dtau, T(1.0 - first),
                             T(first));
  T wu, wc, wk, ew;
  bezier_weights(dtau, wu, wc, wk, ew);
  out[idx] = ew * I_up + wu * S_up + wc * Sc + wk * C;
}

template <typename T>
static int launch_bezier(const T* i_p, const T* a_c, const T* a_p,
                         const T* s_c, const T* s_p, const T* a_pp,
                         const T* s_pp, T* out, int B, int nx, int ny,
                         int sxs, int sys, double r, double fx, double fy,
                         double r_prev, double fx_prev, double fy_prev,
                         double first, void* stream) {
  const long long n = (long long)B * nx * ny;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  xy_bezier_kernel<T><<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      i_p, a_c, a_p, s_c, s_p, a_pp, s_pp, out, B, nx, ny, sxs, sys, r, fx,
      fy, r_prev, fx_prev, fy_prev, first);
  return (int)cudaGetLastError();
}

extern "C" int vrt_xy_bezier_f64(const double* i_p, const double* a_c,
                                 const double* a_p, const double* s_c,
                                 const double* s_p, const double* a_pp,
                                 const double* s_pp, double* out, int B,
                                 int nx, int ny, int sxs, int sys, double r,
                                 double fx, double fy, double r_prev,
                                 double fx_prev, double fy_prev,
                                 double first, void* stream) {
  return launch_bezier<double>(i_p, a_c, a_p, s_c, s_p, a_pp, s_pp, out, B,
                               nx, ny, sxs, sys, r, fx, fy, r_prev, fx_prev,
                               fy_prev, first, stream);
}

extern "C" int vrt_xy_bezier_f32(const float* i_p, const float* a_c,
                                 const float* a_p, const float* s_c,
                                 const float* s_p, const float* a_pp,
                                 const float* s_pp, float* out, int B,
                                 int nx, int ny, int sxs, int sys, double r,
                                 double fx, double fy, double r_prev,
                                 double fx_prev, double fy_prev,
                                 double first, void* stream) {
  return launch_bezier<float>(i_p, a_c, a_p, s_c, s_p, a_pp, s_pp, out, B,
                              nx, ny, sxs, sys, r, fx, fy, r_prev, fx_prev,
                              fy_prev, first, stream);
}
