// One z-plane of the xy plane-cut case of the regular sweep.
//
// Replaces the Pallas kernel voronoirt_tpu/solvers/pallas_xy.py
// (_xy_kernel, reached from xy_plane_pallas).  Computes what
// sweep_regular._xy_step computes, per output point of a contiguous
// (B, Nx, Ny) plane:
//
//   bil(A)   = lerp_x(lerp_y(A)) at (x + sxs + fx, y + sys + fy), periodic
//   dtau     = r/2 * (alpha_c + bil(alpha_p))
//   I_new    = e(dtau) bil(I_p) + a(dtau) bil(S_p) + b(dtau) S_c
//
// The separable lerp with the integer base shifts sxs, sys (shared by a
// group: they are part of plan_signature) and the per-element fractions
// fx[b], fy[b] and path length r[b] is the evaluation order of the XLA
// path, which keeps rounding closest to it.
//
// Bound on the card: HBM bytes.  Per point it reads five planes and
// writes one (48 B in float64) and does ~40 flops and one exp, far below
// the H100's flop-per-byte balance.  Design: one thread per output point,
// consecutive threads on consecutive y, so every tap load of a warp is
// one or two contiguous segments; the 3x3-neighbourhood re-reads hit L1
// and L2, so HBM sees each input plane about once.  One launch per
// z-plane: the split sweep's, whose padded tiles need the carried plane's
// halo refilled after every step; the unsplit sweep runs a whole segment
// a launch with the carried plane on chip (xy_segment.cu).
#include "formal.cuh"

template <typename T>
__global__ void xy_plane_kernel(const T* __restrict__ a_p,
                                const T* __restrict__ a_c,
                                const T* __restrict__ s_p,
                                const T* __restrict__ s_c,
                                const T* __restrict__ i_p,
                                const T* __restrict__ r,
                                const T* __restrict__ fx,
                                const T* __restrict__ fy,
                                T* __restrict__ out,
                                int B, int nx, int ny, int sxs, int sys) {
  const long long plane = (long long)nx * ny;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * plane) return;
  const int b = (int)(idx / plane);
  const int rem = (int)(idx - (long long)b * plane);
  const int x = rem / ny;
  const int y = rem - x * ny;
  const long long base = (long long)b * plane;
  const long long r0 = base + (long long)wrap(x + sxs, nx) * ny;
  const long long r1 = base + (long long)wrap(x + sxs + 1, nx) * ny;
  const int y0 = wrap(y + sys, ny);
  const int y1 = wrap(y + sys + 1, ny);
  const T fxb = fx[b], fyb = fy[b], rb = r[b];

  auto bil = [&](const T* A) {
    const T lo = (T(1) - fyb) * A[r0 + y0] + fyb * A[r0 + y1];
    const T hi = (T(1) - fyb) * A[r1 + y0] + fyb * A[r1 + y1];
    return (T(1) - fxb) * lo + fxb * hi;
  };

  const T dtau = rb * (a_c[idx] + bil(a_p)) * T(0.5);
  T aw, bw, ew;
  linear_weights(dtau, aw, bw, ew);
  out[idx] = ew * bil(i_p) + aw * bil(s_p) + bw * s_c[idx];
}

template <typename T>
static int launch_xy(const T* a_p, const T* a_c, const T* s_p, const T* s_c,
                     const T* i_p, const T* r, const T* fx, const T* fy,
                     T* out, int B, int nx, int ny, int sxs, int sys,
                     void* stream) {
  const long long n = (long long)B * nx * ny;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  xy_plane_kernel<T><<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      a_p, a_c, s_p, s_c, i_p, r, fx, fy, out, B, nx, ny, sxs, sys);
  return (int)cudaGetLastError();
}

extern "C" int vrt_xy_plane_f64(const double* a_p, const double* a_c,
                                const double* s_p, const double* s_c,
                                const double* i_p, const double* r,
                                const double* fx, const double* fy,
                                double* out, int B, int nx, int ny, int sxs,
                                int sys, void* stream) {
  return launch_xy<double>(a_p, a_c, s_p, s_c, i_p, r, fx, fy, out, B, nx,
                           ny, sxs, sys, stream);
}

extern "C" int vrt_xy_plane_f32(const float* a_p, const float* a_c,
                                const float* s_p, const float* s_c,
                                const float* i_p, const float* r,
                                const float* fx, const float* fy,
                                float* out, int B, int nx, int ny, int sxs,
                                int sys, void* stream) {
  return launch_xy<float>(a_p, a_c, s_p, s_c, i_p, r, fx, fy, out, B, nx,
                          ny, sxs, sys, stream);
}
