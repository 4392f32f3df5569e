// A Bezier xy segment of the regular sweep in one launch (X1 as a
// segment).
//
// Replaces no Pallas kernel: the JAX package runs a Bezier xy segment as
// plain XLA, a lax.scan of _xy_step_bezier in its jitted sweep
// (voronoirt_tpu/solvers/sweep_regular.py:245, the scan at :492-511).
// For steps j = 0 .. n_steps - 1 of the segment, t = t0 + j dirn, it
// computes what a loop of xy_bezier.cu's kernel computes (the loop of
// solvers/sweep_regular.py _xy_segment_bezier):
//
//   I = xy_bezier(I, alpha[t], alpha[t-dirn], S[t], S[t-dirn],
//                 alpha[t2], S[t2], geometry of step j and of step
//                 max(j - 1, 0), first = (j == 0));   out[t] = I
//
// with t2 = t - 2 dirn (the first step: t2 as given, clamped to the
// grid), and each point's arithmetic in xy_bezier.cu's order
// (-fmad=false), so the planes are bit-equal to that loop's and to its
// plain version.  The launch runs the whole segment: nothing but the
// step count bounds it, and each plane goes straight into the sweep's
// output cube.
//
// Bound on the card: a step reads alpha[t] and S[t] and writes I[t],
// 24 B a point in float64 (6.1 us at (13, 256, 256) and 3.35 TB/s;
// float32 3.05 us), against ~174 FP64 operations a point (4.4 us at 34
// TFLOP/s, each division and the exp counted as one, though each is a
// sequence of a dozen or more instructions on the card).  The per-plane
// kernel reads seven planes and writes one.  Measured on an H100 SXM, a
// step at (13, 256, 256) takes ~31 us in float64, 20 % of the bytes
// bound, and half of it is the Bezier weights and control point: with
// 16 warps an SM the step waits on the latency of each point's chain of
// divisions and exp (PERF.md section 6).  Design:
//
// * One thread-block cluster of BZ_CLUSTER = 16 CTAs (a non-portable
//   size; fewer where the plane has fewer rows) a batch element, each
//   CTA owning a band of R = ceil(nx / C) x-rows, as xy_segment.cu.  A
//   CTA keeps six band buffers in shared memory: alpha and S of the
//   previous plane (t - dirn) and of the second-upwind plane (t2), and
//   the carried I plane, previous and new.  alpha[t] and S[t] are read
//   only at a thread's own points: they live in registers, loaded one
//   step ahead, and after step t are stored over the second-upwind
//   buffers, which step t + 1 no longer reads, so the previous planes
//   become the next step's second-upwind ones without a copy.  HBM sees
//   each alpha and S plane read once and each I plane written once.
//   At 256 x 256 a band is 16 rows, 4096 points: six buffers are 196,608
//   B in float64 of the 232,448 a CTA may use (float32 half).
// * The stencils read the band in place and the rows beyond it from the
//   neighbouring CTAs' shared memory (ld.shared::cluster; the x wrap is
//   periodic).  The composed second-upwind stencil reads rows x + 2 sxs
//   + {0, 1, 2}: two rows of the neighbouring band.
// * A thread owns a run of BZ_RUN = 8 consecutive x-rows of one column
//   (512 threads: every point of a 16 x 256 band) and walks it row by
//   row, so each stencil's y-interpolation at a row is made once and
//   used by the two points that share it, in the plain version's order
//   (the same values bit for bit): per point one new row of each
//   stencil, 54 FP64 operations of stencils instead of 117.  The walk
//   goes away from the neighbour the stencil reads (down for sxs = 0,
//   up for sxs = -1), so the points that read a neighbour's rows come
//   first.
// * Two cluster barriers a step, each split in its halves.  B2: a CTA
//   arrives once its first two points of each run (every point whose
//   taps reach a neighbour) are done, computes the rest of the band,
//   then waits before storing alpha[t] and S[t] over its second-upwind
//   buffers, which a neighbour may be reading until then.  B1: it
//   arrives after those stores and loads the next step's alpha and S
//   into registers while the barrier completes, and waits at the top of
//   the next step.  The carried I is double-buffered: step t + 1 writes
//   the buffer step t read, which B1 of step t has freed.
// * Waves: a CTA takes one SM (its shared memory in float64, its
//   registers in both types), so the card runs 7 16-CTA clusters at once
//   (cudaOccupancyMaxActiveClusters on an H100 SXM): B = 13 runs in two
//   waves, and B <= 7 leaves most SMs idle.
//
// A plane fits where its columns times the runs of a band do not exceed
// BZ_THREADS (bz_layout; solvers/xy_bezier_segment.py fits()); others
// take the per-plane kernel, by that rule, before any launch, and a
// launch at a plane that does not fit returns an error.
#include <cooperative_groups.h>

#include "cluster.cuh"
#include "formal.cuh"

namespace cg = cooperative_groups;

constexpr int BZ_CLUSTER = 16;
constexpr int BZ_THREADS = 512;
constexpr int BZ_RUN = 8;

template <typename T, int SXS, int SYS>
__global__ void __launch_bounds__(BZ_THREADS, 1)
xy_bezier_segment_kernel(const T* __restrict__ alpha,
                         const T* __restrict__ S, const T* I0,
                         const double* __restrict__ geom, T* out, int B,
                         int nx, int ny, int t0, int dirn, int n_steps,
                         int t2, int R) {
  // the walk goes up for sxs = -1 (the stencils read rows below) and
  // down for sxs = 0 (rows above)
  constexpr bool UP = SXS == -1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int rs = rank * R;                          // the band's first row
  const int rows = max(0, min(R, nx - rs));
  const int RB = R * ny;                            // elements a buffer
  const unsigned RBB = (unsigned)(RB * (int)sizeof(T));
  const long long plane = (long long)B * nx * ny;   // a z-plane of a field
  // the band's first point in a (B, nx, ny) plane
  const long long boff = (long long)b * nx * ny + (long long)rs * ny;
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(sm);

  // this thread's run: column y, band rows lx0 .. lx0 + len - 1; its
  // k-th point in walk order is band point p0 + k * pstep
  const int tid = threadIdx.x;
  const int y = tid % ny;
  const int lx0 = (tid / ny) * BZ_RUN;
  const int len = max(0, min(BZ_RUN, rows - lx0));
  const int p0 = (UP ? lx0 : lx0 + len - 1) * ny + y;
  const int pstep = UP ? ny : -ny;
  // the B2 arrival follows the walk's second point (its first where the
  // run is one point; at once for a thread without points)
  const int k_arrive = min(1, len - 1);

  // Tap rows in walk order: W[v] is the shared::cluster address of band
  // row lx0 - 2 + v (up) or lx0 + len + 1 - v (down) at column c0, so the
  // k-th point's three second-upwind rows are W[k], W[k+1], W[k+2]
  // (W[k+2] the one the previous point did not read) and its two outer
  // rows W[k+1], W[k+2].  Columns: c0, c1, c2 = y + 2 sys + {0, 1, 2}
  // (periodic) at byte offsets 0, d1, d2 from c0; the outer stencil's
  // are c0, c1 (sys = 0) or c1, c2 (sys = -1).
  const int c0 = wrap(y + 2 * SYS, ny);
  const int d1 = (wrap(c0 + 1, ny) - c0) * (int)sizeof(T);
  const int d2 = (wrap(c0 + 2, ny) - c0) * (int)sizeof(T);
  const int e0 = SYS == 0 ? 0 : d1, e1 = SYS == 0 ? d1 : d2;
  unsigned W[BZ_RUN + 2];
#pragma unroll
  for (int v = 0; v < BZ_RUN + 2; ++v) {
    W[v] = 0;
    if (v < len + 2) {
      const int g = wrap(rs + (UP ? lx0 - 2 + v : lx0 + len + 1 - v), nx);
      const int o = g / R;
      W[v] = map_rank(
          sbase + (unsigned)(((g - o * R) * ny + c0) * (int)sizeof(T)),
          (unsigned)o);
    }
  }

  // buffers, RB elements each: alpha 0 / 1, S 2 / 3, I 4 / 5.  Step j
  // reads alpha and S of the previous plane from slot j & 1, of the
  // second-upwind plane from the other, and the carried I from 4 + (j &
  // 1), and writes I into 4 + ((j & 1) ^ 1)
  {
    const T* ap = alpha + (long long)(t0 - dirn) * plane + boff;
    const T* sp = S + (long long)(t0 - dirn) * plane + boff;
    const T* app = alpha + (long long)t2 * plane + boff;
    const T* spp = S + (long long)t2 * plane + boff;
    const T* ip = I0 + boff;
#pragma unroll
    for (int k = 0; k < BZ_RUN; ++k) {
      if (k < len) {
        const int p = p0 + k * pstep;
        sm[p] = ap[p];
        sm[RB + p] = app[p];
        sm[2 * RB + p] = sp[p];
        sm[3 * RB + p] = spp[p];
        sm[4 * RB + p] = ip[p];
      }
    }
  }
  T ca[BZ_RUN], cs[BZ_RUN];   // alpha[t], S[t] at the run's points
  {
    const T* ac = alpha + (long long)t0 * plane + boff;
    const T* sc = S + (long long)t0 * plane + boff;
#pragma unroll
    for (int k = 0; k < BZ_RUN; ++k) {
      ca[k] = cs[k] = T(0);
      if (k < len) {
        ca[k] = ac[p0 + k * pstep];
        cs[k] = sc[p0 + k * pstep];
      }
    }
  }
  // every CTA of the cluster runs and the buffers are whole before any
  // read of a neighbour's shared memory
  cluster.sync();

  for (int j = 0; j < n_steps; ++j) {
    if (j > 0) cluster_wait();                       // B1 of step j - 1
    const int s = j & 1;
    const unsigned oa = s * RBB, oaa = (s ^ 1) * RBB;
    const unsigned os = (2 + s) * RBB, oss = (2 + (s ^ 1)) * RBB;
    const unsigned oi = (4 + s) * RBB;
    T* Inew = sm + (4 + (s ^ 1)) * RB;
    T* o = out + (long long)(t0 + j * dirn) * plane + boff;
    // the step's geometry (r, fx, fy) and the step before's (the first
    // step's own at j = 0), as doubles: 1 - f is formed in double and
    // rounded to T, as the plain version rounds a Python float factor
    const double* gc = geom + 3 * j;
    const double* gp = geom + 3 * max(j - 1, 0);
    const T rc = T(gc[0]), wx0 = T(1.0 - gc[1]), wx1 = T(gc[1]);
    const T wy0 = T(1.0 - gc[2]), wy1 = T(gc[2]);
    const T rp = T(gp[0]), px0 = T(1.0 - gp[1]), px1 = T(gp[1]);
    const T py0 = T(1.0 - gp[2]), py1 = T(gp[2]);
    const double fst = j == 0 ? 1.0 : 0.0;
    const T omf = T(1.0 - fst), ff = T(fst);

    // y-interpolations at row address a: the outer stencil's (this
    // step's fy) and the inner one's at column pair c (prev fy)
    auto lyo = [&](unsigned a) {
      return wy0 * ld_cluster(a + e0, T()) + wy1 * ld_cluster(a + e1, T());
    };
    auto lyp = [&](unsigned a, int c) {
      const int q0 = c == 0 ? 0 : d1, q1 = c == 0 ? d1 : d2;
      return py0 * ld_cluster(a + q0, T()) + py1 * ld_cluster(a + q1, T());
    };
    // lo / hi in x of a pair (old: the row or pair the previous point
    // shares, new: the other)
    auto lerp_x = [&](T w0, T w1, T old_v, T new_v) {
      return UP ? w0 * old_v + w1 * new_v : w0 * new_v + w1 * old_v;
    };

    // carried from point to point along the walk: the outer
    // y-interpolation at the new row (alpha_p, S_p, I_p), the inner one
    // of alpha_pp and S_pp at the new row (both column pairs), and the
    // outer y-interpolation of their inner plane at the new row pair
    T ko[3], kp[2][2], ki[2];
#pragma unroll
    for (int k = 0; k < BZ_RUN; ++k) {
      if (k < len) {
        const unsigned wo = W[k + 1], wn = W[k + 2];
        // outer stencils: this step's fractions over alpha_p, S_p, I_p
        T up3[3];
        const unsigned offs[3] = {oa, os, oi};
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const T old_v = k == 0 ? lyo(wo + offs[f]) : ko[f];
          const T new_v = lyo(wn + offs[f]);
          ko[f] = new_v;
          up3[f] = lerp_x(wx0, wx1, old_v, new_v);
        }
        // composed stencils over alpha_pp, S_pp: the inner stencil (the
        // previous step's fractions) at the outer stencil's four taps
        T uu[2];
        const unsigned offp[2] = {oaa, oss};
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          T li_old;
          T lp_mid[2], lp_new[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            lp_mid[c] = k == 0 ? lyp(wo + offp[f], c) : kp[f][c];
            lp_new[c] = lyp(wn + offp[f], c);
          }
          if (k == 0) {
            T in_old[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const T lp_far = lyp(W[k] + offp[f], c);
              in_old[c] = lerp_x(px0, px1, lp_far, lp_mid[c]);
            }
            li_old = wy0 * in_old[0] + wy1 * in_old[1];
          } else {
            li_old = ki[f];
          }
          T in_new[2];
#pragma unroll
          for (int c = 0; c < 2; ++c)
            in_new[c] = lerp_x(px0, px1, lp_mid[c], lp_new[c]);
          const T li_new = wy0 * in_new[0] + wy1 * in_new[1];
          kp[f][0] = lp_new[0];
          kp[f][1] = lp_new[1];
          ki[f] = li_new;
          uu[f] = lerp_x(wx0, wx1, li_old, li_new);
        }
        const T a_up = up3[0], S_up = up3[1], I_up = up3[2];
        const T Sc = cs[k];
        const T dtau = rc * (ca[k] + a_up) * T(0.5);
        const T dtau_uu = rp * (a_up + uu[0]) * T(0.5);
        const T Cp = bezier_control(uu[1], S_up, Sc, dtau_uu, dtau, omf, ff);
        T wu, wc, wk, ew;
        bezier_weights(dtau, wu, wc, wk, ew);
        const T v = ew * I_up + wu * S_up + wc * Sc + wk * Cp;
        const int p = p0 + k * pstep;
        Inew[p] = v;
        o[p] = v;
      }
      if (k == k_arrive) cluster_arrive();           // B2 of step j
    }
    if (k_arrive < 0) cluster_arrive();
    // the band's own reads of this step are done, and (B2) every
    // neighbour's of its rows
    __syncthreads();
    cluster_wait();
    if (j + 1 < n_steps) {
      // alpha[t], S[t] over the second-upwind buffers: the next step's
      // previous planes
      T* A = sm + (s ^ 1) * RB;
      T* Sb = sm + (2 + (s ^ 1)) * RB;
#pragma unroll
      for (int k = 0; k < BZ_RUN; ++k) {
        if (k < len) {
          A[p0 + k * pstep] = ca[k];
          Sb[p0 + k * pstep] = cs[k];
        }
      }
      cluster_arrive();                              // B1 of step j
      const long long tn = (long long)(t0 + (j + 1) * dirn) * plane + boff;
#pragma unroll
      for (int k = 0; k < BZ_RUN; ++k) {
        if (k < len) {
          ca[k] = alpha[tn + p0 + k * pstep];
          cs[k] = S[tn + p0 + k * pstep];
        }
      }
    }
  }
}

// the cluster and band of a (nx, ny) plane, and whether it fits: every
// run of BZ_RUN rows of a column a thread of BZ_THREADS
static void bz_layout(int nx, int ny, int& C, int& R, bool& fits) {
  C = 1;
  while (C < BZ_CLUSTER && C < nx) C *= 2;
  R = (nx + C - 1) / C;
  fits = (long long)ny * ((R + BZ_RUN - 1) / BZ_RUN) <= BZ_THREADS;
}

template <typename T, int SXS, int SYS>
static int bz_attributes() {
  // the attributes are the current device's: set them at every launch
  cudaError_t e = cudaFuncSetAttribute(
      xy_bezier_segment_kernel<T, SXS, SYS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(6 * BZ_RUN * BZ_THREADS * sizeof(T)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(xy_bezier_segment_kernel<T, SXS, SYS>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  return (int)e;
}

static cudaLaunchConfig_t bz_config(int B, int C, size_t smem, void* stream,
                                    cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * C, 1, 1);
  cfg.blockDim = dim3((unsigned)BZ_THREADS, 1, 1);
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

template <typename T, int SXS, int SYS>
static int launch_bz(const T* alpha, const T* S, const T* I0,
                     const double* geom, T* out, int B, int nx, int ny,
                     int t0, int dirn, int n_steps, int t2, void* stream) {
  int C, R;
  bool fits;
  bz_layout(nx, ny, C, R, fits);
  if (!fits) return (int)cudaErrorInvalidValue;
  const int err = bz_attributes<T, SXS, SYS>();
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      bz_config(B, C, 6 * (size_t)R * ny * sizeof(T), stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, xy_bezier_segment_kernel<T, SXS, SYS>, alpha, S, I0, geom, out,
      B, nx, ny, t0, dirn, n_steps, t2, R);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

template <typename T>
static int launch_bz_shifts(const T* alpha, const T* S, const T* I0,
                            const double* geom, T* out, int B, int nx,
                            int ny, int sxs, int sys, int t0, int dirn,
                            int n_steps, int t2, void* stream) {
  if (n_steps <= 0 || B <= 0) return 0;
  if (sxs == 0 && sys == 0)
    return launch_bz<T, 0, 0>(alpha, S, I0, geom, out, B, nx, ny, t0, dirn,
                              n_steps, t2, stream);
  if (sxs == 0 && sys == -1)
    return launch_bz<T, 0, -1>(alpha, S, I0, geom, out, B, nx, ny, t0,
                               dirn, n_steps, t2, stream);
  if (sxs == -1 && sys == 0)
    return launch_bz<T, -1, 0>(alpha, S, I0, geom, out, B, nx, ny, t0,
                               dirn, n_steps, t2, stream);
  if (sxs == -1 && sys == -1)
    return launch_bz<T, -1, -1>(alpha, S, I0, geom, out, B, nx, ny, t0,
                                dirn, n_steps, t2, stream);
  return (int)cudaErrorInvalidValue;
}

// one instance's registers and local memory (bytes a thread: spills and
// stack), the larger into info[0], info[1]
template <typename T, int SXS, int SYS>
static int bz_func_info(int* info) {
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, xy_bezier_segment_kernel<T, SXS, SYS>);
  if (a.numRegs > info[0]) info[0] = a.numRegs;
  if ((int)a.localSizeBytes > info[1]) info[1] = (int)a.localSizeBytes;
  return (int)e;
}

// what a launch at (nx, ny) would be: info[0] 1 where the plane fits; [1]
// CTAs a cluster; [2] rows a band; [3] dynamic shared memory a CTA
// (bytes); [4] clusters the card can run at once
// (cudaOccupancyMaxActiveClusters); [5] registers a thread and [6] local
// memory a thread (bytes), the most of the four shift instances
template <typename T>
static int info_bz(int nx, int ny, int* info) {
  int C, R;
  bool fits;
  bz_layout(nx, ny, C, R, fits);
  const size_t smem = 6 * (size_t)R * ny * sizeof(T);
  int err = bz_attributes<T, -1, 0>();
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = bz_config(1, C, smem, 0, attr);
  int clusters = 0;
  if (fits) {
    err = (int)cudaOccupancyMaxActiveClusters(
        &clusters, xy_bezier_segment_kernel<T, -1, 0>, &cfg);
    if (err) return err;
  }
  info[0] = fits ? 1 : 0;
  info[1] = C;
  info[2] = R;
  info[3] = fits ? (int)smem : 0;
  info[4] = clusters;
  int regs[2] = {0, 0};
  if ((err = bz_func_info<T, 0, 0>(regs))) return err;
  if ((err = bz_func_info<T, 0, -1>(regs))) return err;
  if ((err = bz_func_info<T, -1, 0>(regs))) return err;
  if ((err = bz_func_info<T, -1, -1>(regs))) return err;
  info[5] = regs[0];
  info[6] = regs[1];
  return 0;
}

extern "C" int vrt_xy_bezier_segment_f64(const double* alpha,
                                         const double* S, const double* I0,
                                         const double* geom, double* out,
                                         int B, int nx, int ny, int sxs,
                                         int sys, int t0, int dirn,
                                         int n_steps, int t2, void* stream) {
  return launch_bz_shifts<double>(alpha, S, I0, geom, out, B, nx, ny, sxs,
                                  sys, t0, dirn, n_steps, t2, stream);
}

extern "C" int vrt_xy_bezier_segment_f32(const float* alpha, const float* S,
                                         const float* I0, const double* geom,
                                         float* out, int B, int nx, int ny,
                                         int sxs, int sys, int t0, int dirn,
                                         int n_steps, int t2, void* stream) {
  return launch_bz_shifts<float>(alpha, S, I0, geom, out, B, nx, ny, sxs,
                                 sys, t0, dirn, n_steps, t2, stream);
}

extern "C" int vrt_xy_bezier_segment_info_f64(int nx, int ny, int* info) {
  return info_bz<double>(nx, ny, info);
}

extern "C" int vrt_xy_bezier_segment_info_f32(int nx, int ny, int* info) {
  return info_bz<float>(nx, ny, info);
}
