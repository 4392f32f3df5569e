// A mirror group's J emit on the regular grid: the angle reduction of
// the swept planes (G1), the flipped stacks the group sweeps (G2), and
// the fold of the group's two J halves into the chunk's J (G3).
//
// Replaces no TPU kernel.  The JAX package compiles all three into its
// one jitted sweep_group_J (voronoirt_tpu/solvers/sweep_regular.py
// :853-887): XLA fuses the flipped jnp.concatenate of S and I0 (:877-881,
// G2), the per-plane `emit` of sweep_batched_J's scan body (:833-845,
// G1) and J_up + flip(J_dn) (:887, G3).  Eager PyTorch made of them a
// flip, a multiply and an add_ for every angle of every plane, P flipped
// copies and a cat a stack, and a flip, an add and a strided add a
// group; these kernels take one launch each.
//
//   G1 vrt_group_emit:  for the L planes j of a piece, t = t0 + j dirn,
//     J_up[t, b] = sum over the originally-up angles e, in order from
//                  0, of w[e] * unflip_e(I[j, e B + b]),
//     J_dn[t, b] the same over the originally-down angles; a class with
//     no angle gets 0.
//   G2 vrt_group_stack: dst[z', e B + b] = flip_e(src_e)[z', b], src_e
//     (nz, B, nx, ny) with any strides but a unit one along y; the S
//     stack passes one source P times, the I0 stack (nz = 1) P sources.
//   G3 vrt_group_fold:  Jc[b, z] += J_up[z, b] + J_dn[nz - 1 - z, b].
//
// Each point's arithmetic is the plain version's (solvers/group_emit.py)
// in its order: G1 starts a sum at 0 and adds each weighted value, G3
// adds the two halves and then the sum into Jc; with -fmad=false
// (kernels/build.py) nothing contracts, so the kernels are bit-equal to
// the plain versions in float64 and float32.
//
// Bound on the card: HBM bytes.  G1 reads P values and writes two a
// point of a J plane (one multiply and one add a value read); G2 reads
// each source value once and writes it P times; G3 reads three values
// and writes one.  Design: one block row of the grid (blockIdx.y) a
// (z, b) plane of the output, blocks along x stride over its nx * ny
// points, THREADS threads a block, consecutive threads on consecutive y,
// so every load and store of a warp is one contiguous (or, where y is
// flipped, reversed) run; the flags of the angles are bit masks and the
// sources a struct passed by value, so a point costs no index loads.
// An error of the launch is returned for the wrapper to raise.
#include <cuda_runtime.h>

// the most angles of a launch: a mirror group holds at most the 4 xy
// quadrants of an up and a down direction; G2 keeps that many source
// pointers in registers
constexpr int GROUP_MAX_ANGLES = 8;
constexpr int THREADS = 256;
constexpr int POINTS = 4;             // points a thread, about
constexpr int MAX_GRID_Y = 65535;

struct StackSources {
  const void* p[GROUP_MAX_ANGLES];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
group_emit_kernel(const T* __restrict__ I, const T* __restrict__ w,
                  T* __restrict__ J_up, T* __restrict__ J_dn, int P, int B,
                  int nx, int ny, int t0, int dirn, int L, unsigned down,
                  unsigned ux, unsigned uy) {
  const int plane = nx * ny;
  for (int q = blockIdx.y; q < L * B; q += gridDim.y) {
    const int j = q / B, b = q - j * B;
    // angle e's block of the piece's plane j, element b
    const T* in = I + ((long long)j * P * B + b) * plane;
    const long long e_step = (long long)B * plane;
    const long long t = t0 + (long long)j * dirn;
    T* up_out = J_up + (t * B + b) * plane;
    T* dn_out = J_dn + (t * B + b) * plane;
    for (int p = blockIdx.x * THREADS + threadIdx.x; p < plane;
         p += gridDim.x * THREADS) {
      const int x = p / ny, y = p - x * ny;
      const int xf = nx - 1 - x, yf = ny - 1 - y;
      T up = T(0), dn = T(0);
      for (int e = 0; e < P; ++e) {
        const int xs = (ux >> e) & 1u ? xf : x;
        const int ys = (uy >> e) & 1u ? yf : y;
        const T v = w[e] * in[e * e_step + xs * ny + ys];
        if ((down >> e) & 1u)
          dn = dn + v;
        else
          up = up + v;
      }
      up_out[p] = up;
      dn_out[p] = dn;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
group_stack_kernel(StackSources src, T* __restrict__ dst, int P, int nz,
                   int B, int nx, int ny, long long sz, long long sb,
                   long long sx, unsigned fx, unsigned fy, unsigned fz) {
  const int plane = nx * ny;
  for (int q = blockIdx.y; q < nz * B; q += gridDim.y) {
    // the source plane (z, b)
    const int z = q / B, b = q - z * B;
    const long long off = z * sz + b * sb;
    for (int p = blockIdx.x * THREADS + threadIdx.x; p < plane;
         p += gridDim.x * THREADS) {
      const int x = p / ny, y = p - x * ny;
      const long long at = off + x * sx + y;
      const void* last = nullptr;
      T v = T(0);
      // unrolled, so src.p is indexed by constants and stays in the
      // parameter space
#pragma unroll
      for (int e = 0; e < GROUP_MAX_ANGLES; ++e) {
        if (e >= P) break;
        // each distinct source read once
        if (src.p[e] != last) {
          last = src.p[e];
          v = static_cast<const T*>(last)[at];
        }
        const int zo = (fz >> e) & 1u ? nz - 1 - z : z;
        const int xo = (fx >> e) & 1u ? nx - 1 - x : x;
        const int yo = (fy >> e) & 1u ? ny - 1 - y : y;
        dst[((long long)zo * P * B + (long long)e * B + b) * plane +
            xo * ny + yo] = v;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
group_fold_kernel(T* __restrict__ Jc, const T* __restrict__ J_up,
                  const T* __restrict__ J_dn, int B, int nz, int nx, int ny,
                  long long sz, long long sb, long long sx) {
  const int plane = nx * ny;
  for (int q = blockIdx.y; q < B * nz; q += gridDim.y) {
    // Jc's plane (b, z): J_up's (z, b) and J_dn's (nz - 1 - z, b)
    const int b = q / nz, z = q - b * nz;
    T* out = Jc + (long long)q * plane;
    const T* u = J_up + z * sz + b * sb;
    const T* d = J_dn + (nz - 1 - z) * sz + b * sb;
    for (int p = blockIdx.x * THREADS + threadIdx.x; p < plane;
         p += gridDim.x * THREADS) {
      const int x = p / ny, y = p - x * ny;
      const long long at = x * sx + y;
      out[p] = out[p] + (u[at] + d[at]);
    }
  }
}

// the grid of a launch over n_planes planes of nx * ny points
static dim3 group_grid(long long n_planes, int nx, int ny) {
  const long long per_block = (long long)THREADS * POINTS;
  const long long gx = ((long long)nx * ny + per_block - 1) / per_block;
  return dim3((unsigned)gx,
              (unsigned)(n_planes < MAX_GRID_Y ? n_planes : MAX_GRID_Y), 1);
}

static unsigned first_bits(int P) { return (1u << P) - 1u; }

template <typename T>
static int launch_emit(const T* I, const T* w, T* J_up, T* J_dn, int P,
                       int B, int nx, int ny, int t0, int dirn, int L,
                       int down, int ux, int uy, void* stream) {
  if (L == 0 || B == 0 || nx == 0 || ny == 0) return 0;
  if (P < 1 || P > GROUP_MAX_ANGLES) return (int)cudaErrorInvalidValue;
  const unsigned m = first_bits(P);
  group_emit_kernel<T><<<group_grid((long long)L * B, nx, ny), THREADS, 0,
                         (cudaStream_t)stream>>>(
      I, w, J_up, J_dn, P, B, nx, ny, t0, dirn, L, (unsigned)down & m,
      (unsigned)ux & m, (unsigned)uy & m);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_stack(const void* const* srcs, T* dst, int P, int nz,
                        int B, int nx, int ny, long long sz, long long sb,
                        long long sx, int fx, int fy, int fz, void* stream) {
  if (nz == 0 || B == 0 || nx == 0 || ny == 0) return 0;
  if (P < 1 || P > GROUP_MAX_ANGLES) return (int)cudaErrorInvalidValue;
  StackSources src = {};
  for (int e = 0; e < P; ++e) src.p[e] = srcs[e];
  const unsigned m = first_bits(P);
  group_stack_kernel<T><<<group_grid((long long)nz * B, nx, ny), THREADS, 0,
                          (cudaStream_t)stream>>>(
      src, dst, P, nz, B, nx, ny, sz, sb, sx, (unsigned)fx & m,
      (unsigned)fy & m, (unsigned)fz & m);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_fold(T* Jc, const T* J_up, const T* J_dn, int B, int nz,
                       int nx, int ny, long long sz, long long sb,
                       long long sx, void* stream) {
  if (nz == 0 || B == 0 || nx == 0 || ny == 0) return 0;
  group_fold_kernel<T><<<group_grid((long long)B * nz, nx, ny), THREADS, 0,
                         (cudaStream_t)stream>>>(Jc, J_up, J_dn, B, nz, nx,
                                                 ny, sz, sb, sx);
  return (int)cudaGetLastError();
}

#define GROUP_EMIT_API(T, SUFFIX)                                            \
  extern "C" int vrt_group_emit_##SUFFIX(                                    \
      const T* I, const T* w, T* J_up, T* J_dn, int P, int B, int nx,        \
      int ny, int t0, int dirn, int L, int down, int ux, int uy,             \
      void* stream) {                                                        \
    return launch_emit<T>(I, w, J_up, J_dn, P, B, nx, ny, t0, dirn, L, down, \
                          ux, uy, stream);                                   \
  }                                                                          \
  extern "C" int vrt_group_stack_##SUFFIX(                                   \
      const void* const* srcs, T* dst, int P, int nz, int B, int nx, int ny, \
      long long sz, long long sb, long long sx, int fx, int fy, int fz,      \
      void* stream) {                                                        \
    return launch_stack<T>(srcs, dst, P, nz, B, nx, ny, sz, sb, sx, fx, fy,  \
                           fz, stream);                                      \
  }                                                                          \
  extern "C" int vrt_group_fold_##SUFFIX(                                    \
      T* Jc, const T* J_up, const T* J_dn, int B, int nz, int nx, int ny,    \
      long long sz, long long sb, long long sx, void* stream) {              \
    return launch_fold<T>(Jc, J_up, J_dn, B, nz, nx, ny, sz, sb, sx,         \
                          stream);                                           \
  }

GROUP_EMIT_API(double, f64)
GROUP_EMIT_API(float, f32)
