// One z-plane of the yz / xz in-plane march of the regular sweep.
//
// Replaces the Pallas kernel voronoirt_tpu/solvers/pallas_march.py
// (_march_kernel, reached from march_plane_pallas); the reference loop is
// characteristics.jl:420-483.  Planes are contiguous (B, Nx, Ny); the
// march runs over x (yz case, march_x = 1, lines along y) or over y (xz
// case, march_x = 0, lines along x), so no transposes are needed around
// the call.  Per column step, with the upwind column at ix + sign
// (periodic) and the 2-tap line interpolation
// LI(A)[m] = (1 - f) A[m + s_base] + f A[m + s_base + 1]:
//
//   a_up  = wp LI(a_p) + wc LI(a_c)          (wp = 1 - wc)
//   dtau  = r/2 (a_centre + a_up)
//   I_new = e (wp LI(i_p) + wc LI(buf)) + a (wp LI(s_p) + wc LI(s_c))
//           + b s_centre
//
// where buf is the previously computed line (zeroed once, kept across the
// n_sweeps passes) and the centre alpha/S blend the previous plane by the
// per-element 0/1 c_prev (the xz-down quirk, characteristics.jl:794,804).
//
// Formulation: the pass-invariant regrouping of sweep_regular._march_step.
// I_new is affine in buf, I_new = coeff LI(buf) + const, so phase 1
// computes coeff = e wc and const (one exp per point) once per plane into
// a scratch tensor the wrapper allocates, and phase 2 runs the
// n_sweeps * N sequential column steps on those two arrays alone.
//
// Bound on the card: latency of the sequential column chain, not HBM.
// Each step depends on the previous line at m + s_base and m + s_base + 1
// (a +-1 neighbour across the line), so one block owns one batch element:
// threads over the line, the line buffer in shared memory, double
// buffered with one __syncthreads() per step so no thread reads a
// neighbour's half-written value.  The scratch is line-contiguous
// (B, 2, N, M), so phase 2's loads are coalesced for both march axes; the
// strided access of the xz case falls on phase 1, which runs once.
// B blocks only (B = angles x wavelengths of a group) under-fill the 132
// SMs at production shapes; filling them is later work.
#include "formal.cuh"

constexpr int kMaxLine = 2048;     // line length bound: 2 points a thread

template <typename T>
__global__ void march_plane_kernel(const T* __restrict__ a_p,
                                   const T* __restrict__ a_c,
                                   const T* __restrict__ s_p,
                                   const T* __restrict__ s_c,
                                   const T* __restrict__ i_p,
                                   const T* __restrict__ r,
                                   const T* __restrict__ f_line,
                                   const T* __restrict__ w_cur,
                                   const T* __restrict__ c_prev,
                                   T* __restrict__ out,
                                   T* scratch,
                                   int nx, int ny, int march_x, int sign,
                                   int s_base, int n_sweeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cur = reinterpret_cast<T*>(smem_raw);

  const int b = blockIdx.x;
  const int N = march_x ? nx : ny;     // columns along the march
  const int M = march_x ? ny : nx;     // points along a line
  const long long plane = (long long)nx * ny;
  const long long base = (long long)b * plane;
  T* coeff = scratch + 2 * base;       // (N, M), line-contiguous
  T* cnst = coeff + plane;

  const T rb = r[b], f = f_line[b], wc = w_cur[b], cp = c_prev[b];
  const T wp = T(1) - wc;

  // plane offset of (column c, line position m)
  auto at = [&](int c, int m) -> long long {
    return base + (march_x ? (long long)c * ny + m : (long long)m * ny + c);
  };

  // ---- phase 1: pass-invariant coeff / const, threads in memory order
  for (long long p = threadIdx.x; p < plane; p += blockDim.x) {
    const int x = (int)(p / ny);
    const int y = (int)(p - (long long)x * ny);
    const int c = march_x ? x : y;
    const int m = march_x ? y : x;
    const int cw = wrap(c + sign, N);
    const long long u0 = at(cw, wrap(m + s_base, M));
    const long long u1 = at(cw, wrap(m + s_base + 1, M));
    auto LI = [&](const T* A) { return (T(1) - f) * A[u0] + f * A[u1]; };
    const long long ctr = base + p;
    const T a_up = wp * LI(a_p) + wc * LI(a_c);
    const T a_c0 = cp * a_p[ctr] + (T(1) - cp) * a_c[ctr];
    const T dtau = rb * (a_c0 + a_up) * T(0.5);
    T aw, bw, ew;
    linear_weights(dtau, aw, bw, ew);
    const T s_up = wp * LI(s_p) + wc * LI(s_c);
    const T s_c0 = cp * s_p[ctr] + (T(1) - cp) * s_c[ctr];
    const long long q = (long long)c * M + m;
    cnst[q] = ew * (wp * LI(i_p)) + aw * s_up + bw * s_c0;
    coeff[q] = ew * wc;
  }

  // ---- phase 2: the sequential column chain on the line buffer
  T* nxt = cur + M;
  for (int m = threadIdx.x; m < M; m += blockDim.x) cur[m] = T(0);
  __syncthreads();   // also publishes phase 1's scratch to the block

  const int steps = n_sweeps * N;
  for (int n = 0; n < steps; ++n) {
    const int i = n % N;
    const int c = sign > 0 ? i : N - 1 - i;
    const bool last = n >= steps - N;
    const T* crow = coeff + (long long)c * M;
    const T* krow = cnst + (long long)c * M;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      const T li = (T(1) - f) * cur[wrap(m + s_base, M)]
                 + f * cur[wrap(m + s_base + 1, M)];
      const T v = crow[m] * li + krow[m];
      nxt[m] = v;
      if (last) out[at(c, m)] = v;
    }
    __syncthreads();
    T* t = cur; cur = nxt; nxt = t;
  }
}

template <typename T>
static int launch_march(const T* a_p, const T* a_c, const T* s_p,
                        const T* s_c, const T* i_p, const T* r,
                        const T* f_line, const T* w_cur, const T* c_prev,
                        T* out, T* scratch, int B, int nx, int ny,
                        int march_x, int sign, int s_base, int n_sweeps,
                        void* stream) {
  if (B == 0 || nx == 0 || ny == 0) return 0;
  const int M = march_x ? ny : nx;
  if (M > kMaxLine) return (int)cudaErrorInvalidValue;
  const int threads = M > 1024 ? 1024 : ((M + 31) / 32) * 32;
  const size_t smem = 2 * (size_t)M * sizeof(T);
  march_plane_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(
      a_p, a_c, s_p, s_c, i_p, r, f_line, w_cur, c_prev, out, scratch, nx,
      ny, march_x, sign, s_base, n_sweeps);
  return (int)cudaGetLastError();
}

extern "C" int vrt_march_plane_f64(
    const double* a_p, const double* a_c, const double* s_p,
    const double* s_c, const double* i_p, const double* r,
    const double* f_line, const double* w_cur, const double* c_prev,
    double* out, double* scratch, int B, int nx, int ny, int march_x,
    int sign, int s_base, int n_sweeps, void* stream) {
  return launch_march<double>(a_p, a_c, s_p, s_c, i_p, r, f_line, w_cur,
                              c_prev, out, scratch, B, nx, ny, march_x, sign,
                              s_base, n_sweeps, stream);
}

extern "C" int vrt_march_plane_f32(
    const float* a_p, const float* a_c, const float* s_p, const float* s_c,
    const float* i_p, const float* r, const float* f_line,
    const float* w_cur, const float* c_prev, float* out, float* scratch,
    int B, int nx, int ny, int march_x, int sign, int s_base, int n_sweeps,
    void* stream) {
  return launch_march<float>(a_p, a_c, s_p, s_c, i_p, r, f_line, w_cur,
                             c_prev, out, scratch, B, nx, ny, march_x, sign,
                             s_base, n_sweeps, stream);
}
