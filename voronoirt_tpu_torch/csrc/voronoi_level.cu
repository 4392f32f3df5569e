// V1: the level steps of a Voronoi sweep stage, one launch a level and pass.
//
// Replaces no Pallas kernel: the JAX package compiles each schedule stage
// of its Voronoi sweep as one plain-XLA lax.scan over the stage's levels
// (voronoirt_tpu/solvers/sweep_voronoi.py: _stage_scan :469 run by
// _run_stage :502, _run_relax_lap :510, _run_hoisted_lap_d :553 and
// _run_hoisted_lap :579, fed by _level_src_ew :451).  The port's plain
// version is solvers/voronoi_level.py::voronoi_stage_plain, an eager loop
// of about 46 small kernels a level.
//
// A stage's rows are its levels, each a contiguous row range of the
// (n_rows + 1, B) intensity array I (the last row the dummy zero row).
// For level l, rows [start + off[l], start + off[l + 1]), and each of its
// `passes`, every (row, lambda) computes, in the plain version's order
// (-fmad=false, kernels/build.py):
//
//   formal:  dtau_j = r_j * (a_c + a_u[j]) * 0.5
//            (aw, bw, ew) = linear_weights(dtau_j)        (formal.cuh)
//            src_j = aw * s_u[j] + bw * s_c
//            i_new = w_0 * (ew_0 * I[up_0] + src_0) + w_1 * (ew_1 * I[up_1] + src_1)
//   hoisted: i_new = A_0 * I[up_0] + A_1 * I[up_1] + b
//
// with the fields gathered from the site-major (n, B) S and extinction
// through the site-id maps and the intensities through the slot ids, and,
// with `fold`, max |i_new - i_old| and max |i_new| folded into change[0]
// and change[1] (atomicMax on the IEEE bits: the values are >= 0, so the
// bit order is the numeric order, and a NaN, positive after fabs, wins as
// torch.maximum propagates it).
//
// Jacobi passes.  The plain version gathers every upwind row of a level
// before it writes any of the level's rows.  A level some of whose upwind
// slots fall inside its own row range (the host marks it in self_ref)
// therefore writes its new rows into `scratch` and copies them into I on
// the stream after the launch; every other level writes in place.
//
// Bound on the card: a row of B values reads two upwind intensities, two
// upwind and one own S and extinction, and writes one value (the hoisted
// form reads 2 intensities and 3 lean values); a level of the
// 442,368-site production plan holds ~1,100 rows, ~6 MB of distinct
// values at B = 91 in float64, ~1.8 us at the card's memory rate.  The
// levels are sequential and each is one short launch, so a step is set
// by launch latency and the kernel's ramp (about 7.6 us an H100 step,
// PERF.md), not by the bytes.  Design: one thread a (row, lambda),
// lambda fastest, so each gathered row of B contiguous values is one
// coalesced run and a row's indices and geometry are one broadcast load;
// the host loop over a stage's levels and passes lives here, in C, so
// Python crosses into the library once a stage or relax lap.
#include "formal.cuh"

constexpr int LEVEL_THREADS = 256;

template <typename T>
struct Bits;
template <>
struct Bits<double> {
  using U = unsigned long long;
  static __device__ __forceinline__ U of(double x) {
    return (U)__double_as_longlong(x);
  }
};
template <>
struct Bits<float> {
  using U = unsigned int;
  static __device__ __forceinline__ U of(float x) { return __float_as_uint(x); }
};

template <typename U>
__device__ __forceinline__ U umax(U a, U b) {
  return a > b ? a : b;
}

template <typename U>
__device__ __forceinline__ U warp_max(U v) {
  for (int o = 16; o > 0; o >>= 1) v = umax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One level pass.  I: the intensities read (upwind rows and, with kFold,
// the level's old rows at i_row0); out: where row `row` of the level goes,
// out[(out_row0 + row) * B + lam] (I itself, or the scratch rows).  o0:
// the level's first row in the stage's per-row arrays.
template <typename T, bool kHoisted, bool kFold>
__global__ void __launch_bounds__(LEVEL_THREADS) voronoi_level_kernel(
    const T* I, T* out, long long i_row0, long long out_row0,
    const T* __restrict__ S_T, const T* __restrict__ a_T,
    const long long* __restrict__ up_slot,
    const long long* __restrict__ up_site,
    const long long* __restrict__ row_site, const T* __restrict__ w,
    const T* __restrict__ r, const T* __restrict__ A,
    const T* __restrict__ bvec, typename Bits<T>::U* change, long long o0,
    int rows, int B) {
  using U = typename Bits<T>::U;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  U d_bits = 0, s_bits = 0;
  if (t < (long long)rows * B) {
    const long long row = t / B;
    const int lam = (int)(t - row * B);
    const long long k = o0 + row;
    const T i0 = I[up_slot[2 * k] * B + lam];
    const T i1 = I[up_slot[2 * k + 1] * B + lam];
    T i_new;
    if (kHoisted) {
      i_new = A[(2 * k) * B + lam] * i0 + A[(2 * k + 1) * B + lam] * i1 +
              bvec[k * B + lam];
    } else {
      const long long c = row_site[k] * B + lam;
      const T a_c = a_T[c], s_c = S_T[c];
      T term[2];
      const T iu[2] = {i0, i1};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const long long u = up_site[2 * k + j] * B + lam;
        const T dtau = r[2 * k + j] * (a_c + a_T[u]) * T(0.5);
        T aw, bw, ew;
        linear_weights(dtau, aw, bw, ew);
        const T src = aw * S_T[u] + bw * s_c;
        term[j] = w[2 * k + j] * (ew * iu[j] + src);
      }
      i_new = term[0] + term[1];
    }
    if (kFold) {
      const T i_old = I[(i_row0 + row) * B + lam];
      d_bits = Bits<T>::of(fabs(i_new - i_old));
      s_bits = Bits<T>::of(fabs(i_new));
    }
    out[(out_row0 + row) * B + lam] = i_new;
  }
  if (kFold) {
    __shared__ U sh[2][LEVEL_THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    d_bits = warp_max(d_bits);
    s_bits = warp_max(s_bits);
    if (lane == 0) {
      sh[0][warp] = d_bits;
      sh[1][warp] = s_bits;
    }
    __syncthreads();
    if (warp == 0) {
      const int nw = blockDim.x >> 5;
      d_bits = lane < nw ? sh[0][lane] : U(0);
      s_bits = lane < nw ? sh[1][lane] : U(0);
      d_bits = warp_max(d_bits);
      s_bits = warp_max(s_bits);
      if (lane == 0) {
        if (d_bits) atomicMax(change, d_bits);
        if (s_bits) atomicMax(change + 1, s_bits);
      }
    }
  }
}

template <typename T, bool kHoisted, bool kFold>
static void launch_level(const T* I, T* out, long long i_row0,
                         long long out_row0, const T* S_T, const T* a_T,
                         const long long* up_slot, const long long* up_site,
                         const long long* row_site, const T* w, const T* r,
                         const T* A, const T* b, void* change, long long o0,
                         int rows, int B, cudaStream_t stream) {
  const long long n = (long long)rows * B;
  const unsigned blocks = (unsigned)((n + LEVEL_THREADS - 1) / LEVEL_THREADS);
  voronoi_level_kernel<T, kHoisted, kFold><<<blocks, LEVEL_THREADS, 0, stream>>>(
      I, out, i_row0, out_row0, S_T, a_T, up_slot, up_site, row_site, w, r, A,
      b, (typename Bits<T>::U*)change, o0, rows, B);
}

// The stage's levels in order, each `passes` times.  off: the n_levels + 1
// host row offsets of the levels in the stage; self_ref: n_levels host
// flags; scratch: the widest self-referencing level's rows (or null when
// none is); A, b (hoisted) or the fields and geometry (formal), the
// others null.  Returns the first CUDA error, or 0.
template <typename T>
static int run_stage(T* I, const T* S_T, const T* a_T,
                     const long long* up_slot, const long long* up_site,
                     const long long* row_site, const T* w, const T* r,
                     const T* A, const T* b, T* scratch, void* change,
                     const long long* off, const int* self_ref, int n_levels,
                     int passes, int B, int start, int hoisted, int fold,
                     void* stream_p) {
  const cudaStream_t stream = (cudaStream_t)stream_p;
  for (int l = 0; l < n_levels; ++l) {
    const long long o0 = off[l];
    const int rows = (int)(off[l + 1] - o0);
    if (rows <= 0) continue;
    const long long row0 = (long long)start + o0;
    const bool in_place = !self_ref[l];
    T* out = in_place ? I : scratch;
    const long long out_row0 = in_place ? row0 : 0;
    for (int p = 0; p < passes; ++p) {
      if (hoisted && fold)
        launch_level<T, true, true>(I, out, row0, out_row0, S_T, a_T, up_slot,
                                    up_site, row_site, w, r, A, b, change, o0,
                                    rows, B, stream);
      else if (hoisted)
        launch_level<T, true, false>(I, out, row0, out_row0, S_T, a_T,
                                     up_slot, up_site, row_site, w, r, A, b,
                                     change, o0, rows, B, stream);
      else if (fold)
        launch_level<T, false, true>(I, out, row0, out_row0, S_T, a_T,
                                     up_slot, up_site, row_site, w, r, A, b,
                                     change, o0, rows, B, stream);
      else
        launch_level<T, false, false>(I, out, row0, out_row0, S_T, a_T,
                                      up_slot, up_site, row_site, w, r, A, b,
                                      change, o0, rows, B, stream);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      if (!in_place) {
        err = cudaMemcpyAsync(I + row0 * B, scratch,
                              (size_t)rows * B * sizeof(T),
                              cudaMemcpyDeviceToDevice, stream);
        if (err != cudaSuccess) return (int)err;
      }
    }
  }
  return 0;
}

#define VRT_STAGE_ENTRY(NAME, T)                                              \
  extern "C" int NAME(T* I, const T* S_T, const T* a_T,                       \
                      const long long* up_slot, const long long* up_site,     \
                      const long long* row_site, const T* w, const T* r,      \
                      const T* A, const T* b, T* scratch, void* change,       \
                      const long long* off, const int* self_ref,              \
                      int n_levels, int passes, int B, int start,             \
                      int hoisted, int fold, void* stream) {                  \
    return run_stage<T>(I, S_T, a_T, up_slot, up_site, row_site, w, r, A, b,  \
                        scratch, change, off, self_ref, n_levels, passes, B,  \
                        start, hoisted, fold, stream);                        \
  }

VRT_STAGE_ENTRY(vrt_voronoi_stage_f64, double)
VRT_STAGE_ENTRY(vrt_voronoi_stage_f32, float)
