// A whole xy segment of the regular sweep (or a piece of one) in one launch.
//
// Replaces the Pallas kernel voronoirt_tpu/solvers/pallas_xy.py
// (_xy_kernel, reached from xy_plane_pallas) on the unsplit sweep, where
// the JAX package runs a segment of it as one lax.scan
// (sweep_regular.py:517-528, :706-719).  For j, t in enumerate(steps),
// t = t0 + j * dirn, it computes what a loop of xy_plane.cu's kernel
// computes:
//
//   I = xy_plane(alpha[t-dirn], alpha[t], S[t-dirn], S[t], I,
//                r[j], fx[j], fy[j], sxs, sys);   out[j] = I
//
// with each point's arithmetic in xy_plane.cu's order (the separable
// lerp_x(lerp_y(.)), dtau = r (a_c + bil(a_p)) / 2, linear_weights of
// formal.cuh; -fmad=false), so the planes are bit-equal to that loop's.
//
// Bound on the card: HBM bytes.  A step reads alpha[t] and S[t] and
// writes I[t] (24 B a point in float64) against ~60 flops and one exp;
// the per-plane kernel reads five planes and writes one.  Batch elements
// are independent, and one step of an element depends on the whole
// previous step of the same element only through the one upwind row of
// the stencil.  Design:
//
// * Placement 'shared' (the production plane and every plane whose band
//   fits): one thread-block cluster per batch element, SEG_CLUSTER = 16
//   CTAs (a non-portable size), each owning a band of R = ceil(nx / 16)
//   x-rows.  A CTA keeps six band buffers in shared memory: alpha and S
//   of the previous and the current plane, and the carried I plane,
//   previous and new.  The stencil reads the band rows in place and the
//   one upwind row outside the band from the neighbouring CTA's shared
//   memory (distributed shared memory, ld.shared::cluster; the x wrap is
//   periodic, so the last CTA's neighbour is the first).  alpha[t+dirn]
//   and S[t+dirn] (and the step's geometry) are loaded into registers
//   while step t computes and stored into the buffers that step t's
//   previous planes leave free, so the current planes become the next
//   step's previous ones and HBM sees each alpha and S plane once and
//   each I plane written once.
//   Steps are ordered by the cluster barrier, split in its two halves: a
//   CTA computes its band's last and first rows first (the row its
//   neighbour reads, and the row that reads its neighbour's), arrives,
//   computes the rest of the band while the barrier completes, and waits
//   at the top of the next step; a CTA barrier orders the band's own
//   rows.  Double buffering is then enough.
//   Sizing: at 256 x 256 a band is 16 rows, 4096 points, 32 KB in float64
//   (16 KB in float32); six buffers are 196,608 B of the 232,448 B a CTA
//   may use.  A CTA's threads own the same points for the whole segment
//   (float64: 512 threads of 8 points; float32: 1024 of 4, as many
//   threads as the registers allow), so every wrap, owner rank and tap
//   address (two registers a point) is computed once before the step
//   loop.  A band of more than SEG_BAND points does not fit and takes
//   the next placement.  The card runs 7 such clusters at once (112
//   SMs, one CTA each: cudaOccupancyMaxActiveClusters on an H100 SXM).
// * Placement 'global' (planes whose band does not fit): the same
//   clusters and bands, the carried plane kept in the output itself (out
//   [j-1] is step j's previous plane, read past L1), alpha and S read
//   through the read-only path; one cluster.sync() a step.
//
// Every plane takes one of the two placements; an error of the launch is
// returned for the wrapper (solvers/xy_segment.py) to raise.
#include <cooperative_groups.h>

#include "cluster.cuh"
#include "formal.cuh"

namespace cg = cooperative_groups;

constexpr int SEG_CLUSTER = 16;
constexpr int SEG_BAND = 4096;      // points a CTA, shared placement
constexpr int GLOBAL_THREADS = 512;  // threads a CTA, global placement

// threads a CTA and points a thread of the shared placement: the most
// threads whose registers still hold a thread's points (float64 needs
// about twice float32's registers a point)
template <typename T>
struct SegShape;
template <>
struct SegShape<double> {
  static constexpr int threads = 512, pts = 8;
};
template <>
struct SegShape<float> {
  static constexpr int threads = 1024, pts = 4;
};

// bilinear tap at the rows a0 (x0) and a1 (x1), column y0 of each; y1
// is dy bytes from y0
template <typename T>
__device__ __forceinline__ T bil_cluster(unsigned a0, unsigned a1, int dy,
                                         T fxb, T fyb) {
  const T lo = (T(1) - fyb) * ld_cluster(a0, T()) +
               fyb * ld_cluster(a0 + dy, T());
  const T hi = (T(1) - fyb) * ld_cluster(a1, T()) +
               fyb * ld_cluster(a1 + dy, T());
  return (T(1) - fxb) * lo + fxb * hi;
}

// A point's tap addresses are kept as two registers: the element-aligned
// shared::cluster addresses of (x0, y0) and (x1, y0), the first with bit
// 0 set where y1 wraps to column 0 (y0 = ny - 1, or ny = 1), so y1 is
// one element on, or ny - 1 elements back.
template <typename T>
__device__ __forceinline__ int tap_dy(unsigned a0, int ny) {
  return (a0 & 1u) ? (1 - ny) * (int)sizeof(T) : (int)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(SegShape<T>::threads, 1)
xy_segment_shared(const T* __restrict__ alpha, const T* __restrict__ S,
                  const T* __restrict__ I0, const T* __restrict__ r,
                  const T* __restrict__ fx, const T* __restrict__ fy,
                  T* __restrict__ out, int B, int nx, int ny, int sxs,
                  int sys, int t0, int dirn, int n_steps, int R) {
  constexpr int SEG_THREADS = SegShape<T>::threads;
  constexpr int SEG_PTS = SegShape<T>::pts;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int rs = rank * R;                         // the band's first row
  const int rows = max(0, min(R, nx - rs));
  const int npts = rows * ny;
  const int RB = R * ny;                           // elements a buffer
  const unsigned RBB = (unsigned)(RB * sizeof(T));  // bytes a buffer
  const long long plane = (long long)B * nx * ny;  // a z-plane of a field
  // the band's first point in a (B, nx, ny) plane: its points are
  // contiguous there, so every load and store below is coalesced
  const long long boff = (long long)b * nx * ny + (long long)rs * ny;
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(sm);
  // The band's last row, then its first, then the rest: the first and
  // last rows are the one a neighbour's stencil reads (the first for
  // sxs = 0, the last for sxs = -1) and the one whose stencil reads a
  // neighbour's row (the other), so the step's barrier arrives once the
  // points up to i_arrive are done and completes while the rest of the
  // band computes.
  const int shift = max(rows - 1, 0) * ny;
  const int i_arrive = min((2 * ny - 1) / SEG_THREADS, SEG_PTS - 1);
  // point i of this thread: band index p (row-major in the band), or -1
  auto point = [&](int i) {
    const int q = tid + i * SEG_THREADS;
    if (q >= npts) return -1;
    const int p = q + shift;
    return p >= npts ? p - npts : p;
  };

  // buffers, RB elements each: alpha 0 / 1, S 2 / 3, I 4 / 5; step j
  // reads slot j & 1 as the previous planes and fills (j + 1) & 1
  unsigned A0[SEG_PTS], A1[SEG_PTS];
#pragma unroll
  for (int i = 0; i < SEG_PTS; ++i) {
    const int p = point(i);
    A0[i] = A1[i] = 0;
    if (p >= 0) {
      const int lx = p / ny;
      const int y = p - lx * ny;
      const int g0 = wrap(rs + lx + sxs, nx);
      const int g1 = wrap(rs + lx + sxs + 1, nx);
      const int o0 = g0 / R, o1 = g1 / R;
      const int y0 = wrap(y + sys, ny);
      const int y1 = wrap(y + sys + 1, ny);
      A0[i] = map_rank(sbase + (unsigned)(((g0 - o0 * R) * ny + y0) *
                                          (int)sizeof(T)), (unsigned)o0);
      A1[i] = map_rank(sbase + (unsigned)(((g1 - o1 * R) * ny + y0) *
                                          (int)sizeof(T)), (unsigned)o1);
      A0[i] |= (y1 != y0 + 1) ? 1u : 0u;
    }
  }

  // the previous planes of step 0 into slot 0, its current ones (and
  // its geometry) into registers
  {
    const T* ap = alpha + (long long)(t0 - dirn) * plane + boff;
    const T* sp = S + (long long)(t0 - dirn) * plane + boff;
    const T* ip = I0 + boff;
#pragma unroll
    for (int i = 0; i < SEG_PTS; ++i) {
      const int p = point(i);
      if (p >= 0) {
        sm[p] = ap[p];
        sm[2 * RB + p] = sp[p];
        sm[4 * RB + p] = ip[p];
      }
    }
  }
  T na[SEG_PTS], ns[SEG_PTS];
  {
    const T* ac = alpha + (long long)t0 * plane + boff;
    const T* sc = S + (long long)t0 * plane + boff;
#pragma unroll
    for (int i = 0; i < SEG_PTS; ++i) {
      const int p = point(i);
      na[i] = ns[i] = T(0);
      if (p >= 0) {
        na[i] = ac[p];
        ns[i] = sc[p];
      }
    }
  }
  T nr = r[b], nfx = fx[b], nfy = fy[b];
  // every CTA of the cluster runs and slot 0 is whole before any read
  // of a neighbour's shared memory
  cluster.sync();

  // Each step arrives at the cluster barrier once its first and last
  // rows are done, and waits on it at the top of the next step: then
  // every neighbour has written the row this step reads and has read
  // the row this step overwrites.  Reads and writes within the band are
  // ordered by the CTA barrier at the end of the step.
  for (int j = 0; j < n_steps; ++j) {
    if (j > 0) cluster_wait();
    const int prv = j & 1, cur = prv ^ 1;
    T* Ca = sm + cur * RB;
    T* Cs = sm + (2 + cur) * RB;
    T* Ni = sm + (4 + cur) * RB;
    // this step's alpha[t], S[t] into the slot that step j - 1's
    // previous planes left
#pragma unroll
    for (int i = 0; i < SEG_PTS; ++i) {
      const int p = point(i);
      if (p >= 0) {
        Ca[p] = na[i];
        Cs[p] = ns[i];
      }
    }
    const T rb = nr, fxb = nfx, fyb = nfy;
    if (j + 1 < n_steps) {
      const long long tn = (long long)(t0 + (j + 1) * dirn) * plane + boff;
#pragma unroll
      for (int i = 0; i < SEG_PTS; ++i) {
        const int p = point(i);
        if (p >= 0) {
          na[i] = alpha[tn + p];
          ns[i] = S[tn + p];
        }
      }
      const long long g = (long long)(j + 1) * B + b;
      nr = r[g];
      nfx = fx[g];
      nfy = fy[g];
    }
    T* o = out + (long long)j * plane + boff;
    const unsigned oa = prv * RBB, os = (2 + prv) * RBB,
                   oi = (4 + prv) * RBB;
#pragma unroll
    for (int i = 0; i < SEG_PTS; ++i) {
      const int p = point(i);
      if (p >= 0) {
        const unsigned a0 = A0[i] & ~1u, a1 = A1[i];
        const int dy = tap_dy<T>(A0[i], ny);
        const T dtau =
            rb * (Ca[p] + bil_cluster<T>(a0 + oa, a1 + oa, dy, fxb, fyb)) *
            T(0.5);
        T aw, bw, ew;
        linear_weights(dtau, aw, bw, ew);
        const T v = ew * bil_cluster<T>(a0 + oi, a1 + oi, dy, fxb, fyb) +
                    aw * bil_cluster<T>(a0 + os, a1 + os, dy, fxb, fyb) +
                    bw * Cs[p];
        Ni[p] = v;
        o[p] = v;
      }
      if (i == i_arrive) cluster_arrive();
    }
    __syncthreads();
  }
  // no CTA leaves while a neighbour may still read its shared memory
  if (n_steps > 0) cluster_wait();
}

template <typename T>
__global__ void __launch_bounds__(GLOBAL_THREADS)
xy_segment_global(const T* __restrict__ alpha, const T* __restrict__ S,
                  const T* __restrict__ I0, const T* __restrict__ r,
                  const T* __restrict__ fx, const T* __restrict__ fy,
                  T* out, int B, int nx, int ny, int sxs, int sys, int t0,
                  int dirn, int n_steps, int R) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int rs = rank * R;
  const int npts = max(0, min(R, nx - rs)) * ny;
  const long long plane = (long long)B * nx * ny;
  const long long eoff = (long long)b * nx * ny;   // the element's plane

  for (int j = 0; j < n_steps; ++j) {
    const long long t = t0 + (long long)j * dirn;
    const T* ap = alpha + (t - dirn) * plane + eoff;
    const T* ac = alpha + t * plane + eoff;
    const T* sp = S + (t - dirn) * plane + eoff;
    const T* sc = S + t * plane + eoff;
    // the carried plane: written by the cluster's other CTAs in the last
    // step, so read from L2 (the barrier orders it)
    const T* ip = j == 0 ? I0 + eoff : out + (j - 1) * plane + eoff;
    T* o = out + (long long)j * plane + eoff;
    const T rb = r[(long long)j * B + b];
    const T fxb = fx[(long long)j * B + b];
    const T fyb = fy[(long long)j * B + b];
    for (int p = threadIdx.x; p < npts; p += GLOBAL_THREADS) {
      const int lx = p / ny;
      const int y = p - lx * ny;
      const int x = rs + lx;
      const int r0 = wrap(x + sxs, nx) * ny;
      const int r1 = wrap(x + sxs + 1, nx) * ny;
      const int y0 = wrap(y + sys, ny);
      const int y1 = wrap(y + sys + 1, ny);
      auto bil = [&](const T* A, bool carried) {
        auto ld = [&](int k) { return carried ? __ldcg(A + k) : __ldg(A + k); };
        const T lo = (T(1) - fyb) * ld(r0 + y0) + fyb * ld(r0 + y1);
        const T hi = (T(1) - fyb) * ld(r1 + y0) + fyb * ld(r1 + y1);
        return (T(1) - fxb) * lo + fxb * hi;
      };
      const int idx = x * ny + y;
      const T dtau = rb * (__ldg(ac + idx) + bil(ap, false)) * T(0.5);
      T aw, bw, ew;
      linear_weights(dtau, aw, bw, ew);
      o[idx] = ew * bil(ip, true) + aw * bil(sp, false) +
               bw * __ldg(sc + idx);
    }
    cluster.sync();
  }
}

// the cluster and band of a (nx, ny) plane, and whether its band fits
// the shared placement
static void seg_layout(int nx, int ny, int& C, int& R, bool& fits) {
  C = 1;
  while (C < SEG_CLUSTER && C < nx) C *= 2;
  R = (nx + C - 1) / C;
  fits = (long long)R * ny <= SEG_BAND;
}

// the launch at (nx, ny): the shared placement where the band fits,
// else the global one
template <typename T>
static void seg_config(int nx, int ny, bool& shared, int& C, int& R,
                       size_t& smem) {
  seg_layout(nx, ny, C, R, shared);
  smem = shared ? 6 * (size_t)R * ny * sizeof(T) : 0;
}

template <typename T>
static int seg_attributes() {
  // the attributes are the current device's: set them at every launch
  cudaError_t e = cudaFuncSetAttribute(
      xy_segment_shared<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(6 * SEG_BAND * sizeof(T)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(xy_segment_shared<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(xy_segment_global<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  return (int)e;
}

static cudaLaunchConfig_t seg_launch_config(int B, int C, int threads,
                                            size_t smem, void* stream,
                                            cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * C, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
static int launch_seg(const T* alpha, const T* S, const T* I0, const T* r,
                      const T* fx, const T* fy, T* out, int B, int nx,
                      int ny, int sxs, int sys, int t0, int dirn,
                      int n_steps, void* stream) {
  if (n_steps == 0 || B == 0) return 0;
  bool shared;
  int C, R;
  size_t smem;
  seg_config<T>(nx, ny, shared, C, R, smem);
  const int err = seg_attributes<T>();
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = seg_launch_config(
      B, C, shared ? SegShape<T>::threads : GLOBAL_THREADS, smem, stream,
      attr);
  cudaError_t e = shared
      ? cudaLaunchKernelEx(&cfg, xy_segment_shared<T>, alpha, S, I0, r, fx,
                           fy, out, B, nx, ny, sxs, sys, t0, dirn, n_steps, R)
      : cudaLaunchKernelEx(&cfg, xy_segment_global<T>, alpha, S, I0, r, fx,
                           fy, out, B, nx, ny, sxs, sys, t0, dirn, n_steps, R);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// what a launch at (nx, ny) would be: info[0] 1 for the shared placement,
// 0 for the global one; [1] CTAs a cluster; [2] rows a band; [3] dynamic
// shared memory a CTA (bytes); [4] clusters the card can run at once
// (cudaOccupancyMaxActiveClusters)
template <typename T>
static int info_seg(int nx, int ny, int* info) {
  bool shared;
  int C, R;
  size_t smem;
  seg_config<T>(nx, ny, shared, C, R, smem);
  const int err = seg_attributes<T>();
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = seg_launch_config(
      1, C, shared ? SegShape<T>::threads : GLOBAL_THREADS, smem, 0, attr);
  int clusters = 0;
  const cudaError_t e = shared
      ? cudaOccupancyMaxActiveClusters(&clusters, xy_segment_shared<T>, &cfg)
      : cudaOccupancyMaxActiveClusters(&clusters, xy_segment_global<T>, &cfg);
  info[0] = shared ? 1 : 0;
  info[1] = C;
  info[2] = R;
  info[3] = (int)smem;
  info[4] = clusters;
  return (int)e;
}

extern "C" int vrt_xy_segment_f64(const double* alpha, const double* S,
                                  const double* I0, const double* r,
                                  const double* fx, const double* fy,
                                  double* out, int B, int nx, int ny, int sxs,
                                  int sys, int t0, int dirn, int n_steps,
                                  void* stream) {
  return launch_seg<double>(alpha, S, I0, r, fx, fy, out, B, nx, ny, sxs,
                            sys, t0, dirn, n_steps, stream);
}

extern "C" int vrt_xy_segment_f32(const float* alpha, const float* S,
                                  const float* I0, const float* r,
                                  const float* fx, const float* fy,
                                  float* out, int B, int nx, int ny, int sxs,
                                  int sys, int t0, int dirn, int n_steps,
                                  void* stream) {
  return launch_seg<float>(alpha, S, I0, r, fx, fy, out, B, nx, ny, sxs, sys,
                           t0, dirn, n_steps, stream);
}

extern "C" int vrt_xy_segment_info_f64(int nx, int ny, int* info) {
  return info_seg<double>(nx, ny, info);
}

extern "C" int vrt_xy_segment_info_f32(int nx, int ny, int* info) {
  return info_seg<float>(nx, ny, info);
}
