// V1: the level steps of a Voronoi sweep stage, one persistent launch a
// stage (or relax lap), a grid barrier between its steps.
//
// Replaces no Pallas kernel: the JAX package compiles each schedule stage
// of its Voronoi sweep as one plain-XLA lax.scan over the stage's levels
// (voronoirt_tpu/solvers/sweep_voronoi.py: _stage_scan :469 run by
// _run_stage :502, _run_relax_lap :510, _run_hoisted_lap_d :553 and
// _run_hoisted_lap :579, fed by _level_src_ew :451 and, for the hoisted
// laps, _precompute_lean).  The port's plain version is
// solvers/voronoi_level.py::voronoi_stage_plain, an eager loop of about 46
// small kernels a level.
//
// A stage's rows are its levels, each a contiguous row range of the
// (n_rows + 1, B) intensity array I (the last row the dummy zero row).
// Its steps are its levels in order, each `passes` times; the host's step
// table (sweep_voronoi._step_table) gives each step's first row in the
// stage (k0), its rows and the scratch buffer it writes (-1: in place).
// Every (row, lambda) of a step computes, in the plain version's order
// (-fmad=false, kernels/build.py):
//
//   dtau_j = r_j * (a_c + a_u[j]) * 0.5
//   (aw, bw, ew) = linear_weights(dtau_j)                 (formal.cuh)
//   src_j = aw * s_u[j] + bw * s_c
//   formal:  i_new = w_0 * (ew_0 * I[up_0] + src_0) + w_1 * (ew_1 * I[up_1] + src_1)
//   hoisted: A_j = w_j * ew_j,  b = w_0 * src_0 + w_1 * src_1,
//            i_new = (A_0 * I[up_0] + A_1 * I[up_1]) + b
//
// (the hoisted form is the relax laps' lean-weight formula, formed here
// from the fields instead of read from a precomputed (R, 2, B) A and
// (R, B) b), and, with `fold`, max |i_new - i_old| and max |i_new| are
// folded into change[0] and change[1] (atomicMax on the IEEE bits: the
// values are >= 0, so the bit order is the numeric order, and a NaN,
// positive after fabs, wins as torch.maximum propagates it).
//
// Bound on the card: a row of B values reads two upwind intensities, two
// upwind and one own S and extinction, and writes one value; a level of
// the 442,368-site production plan holds ~1,100 rows, ~6 MB of distinct
// values at B = 91 in float64, ~1.8 us at the card's memory rate.  The
// steps are sequential, so a launch a step was set by launch latency and
// a short kernel's ramp, not by the bytes (7.6 us a step against 1.8);
// within one launch a step is set by the grid barrier and the latency of
// the loads that depend on the previous step.
//
// Design.  One cooperative launch (every block resident) walks all of a
// stage's steps; a grid barrier (an arrive counter, below) separates
// them.  Only the two I[up] loads, i_old and the write depend on the
// previous step: every thread forms the field work of its first item of
// the next step (gathers, linear weights, the terms' constants, the read
// and write addresses; the item's ids were loaded a barrier earlier) in
// registers between its block's arrival at the barrier and its wait
// there, while the other blocks drain the step, so after the barrier a
// step is two L2 round trips and a few multiply-adds.  One item ahead
// keeps 4 blocks of 256 threads an SM resident, about one item a thread
// at the production shape (two ahead halve the resident blocks and were
// measured slower); a thread's further items (the widest levels of the
// largest plans) form theirs after the barrier, one at a time (loading
// the next one's ids while one finishes was measured slower too).  Reads
// of I and of the scratch rows go through L2 (__ldcg):
// blocks on other SMs wrote them in this launch, and L1 is not coherent;
// S, the extinction and the geometry, which no step writes, go through
// the read-only path.
//
// Jacobi steps.  The plain version gathers every upwind row of a level
// pass before it writes any of the pass's rows.  A step some of whose
// upwind slots lie in its own rows (self_ref, every 'layer' level) writes
// into one of two scratch buffers, alternating by step; the next step
// reads any upwind or i_old in that step's rows from the scratch buffer
// and everything else from I, while its threads copy the scratch rows
// back into I, complete at its own barrier, before the step after can
// read them from I.  The last step's rows are copied after the last
// barrier.  Every other step writes in place.
//
// The lap's change is folded in registers over all of the launch's steps
// and reduced once a block at its end.
#include "formal.cuh"

constexpr int STAGE_THREADS = 256;

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

// The grid barrier, split in two so that a block does the next step's
// field work between its arrival and its wait.  arrive: once every thread
// of the block is done with the step (the block barrier), thread 0 adds
// one to *bar with release semantics, which orders the block's writes
// before it; wait: thread 0 spins until all gridDim.x blocks have arrived
// `target / gridDim.x` times (the counter only grows within a launch; the
// host zeroes it before), its acquire load and the block barrier order
// every later read of the block after the other blocks' writes.
__device__ __forceinline__ void barrier_arrive(unsigned long long* bar) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;"
                 :
                 : "l"(bar)
                 : "memory");
}

__device__ __forceinline__ void barrier_wait(unsigned long long* bar,
                                             unsigned long long target) {
  if (threadIdx.x == 0) {
    unsigned long long seen;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                   : "=l"(seen)
                   : "l"(bar)
                   : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

template <typename T>
struct StageArgs {
  T* I;
  T* scratch;       // two buffers of scratch_len values
  int scratch_len;  // the widest self-referencing level's rows * B
  const T* S_T;
  const T* a_T;
  const long long* up_slot;   // (R, 2)
  const long long* up_site;   // (R, 2)
  const long long* row_site;  // (R,)
  const T* w;                 // (R, 2)
  const T* r;                 // (R, 2)
  const long long* steps;     // (n_steps, 3): k0, rows, scratch buffer or -1
  typename Bits<T>::U* change;
  unsigned long long* bar;
  int n_steps, B, start;
};

// A step: its first row in the stage, its rows, and the scratch buffer
// it writes (-1: in place).  The wrapper keeps every row and value index
// of I and the scratch buffers below 2^31, so they are 32-bit here.
struct Step {
  int k0, rows, buf;
};

__device__ __forceinline__ Step load_step(const long long* steps, int s) {
  return {(int)__ldg(steps + 3 * s), (int)__ldg(steps + 3 * s + 1),
          (int)__ldg(steps + 3 * s + 2)};
}

// Where a step reads row u of I: the previous step's scratch buffer when
// u lies in that step's rows and it wrote them there, else I.
template <typename T>
__device__ __forceinline__ const T* read_at(const StageArgs<T>& a,
                                            const Step& prev, int u,
                                            int lam) {
  const int rel = u - (a.start + prev.k0);
  if (prev.buf >= 0 && rel >= 0 && rel < prev.rows)
    return a.scratch + (prev.buf * a.scratch_len + rel * a.B + lam);
  return a.I + (u * a.B + lam);
}

// An item's ids, loaded a step before its field work (no step writes
// them).
struct Ids {
  int up_slot[2], up_site[2], row_site;
};

// One item's work before the barrier: its addresses and the constants of
// its two terms (formal: w, ew, src a term; hoisted: A_0, A_1, b).
template <typename T, bool kHoisted>
struct Item {
  const T* in0;
  const T* in1;
  const T* old;
  T* out;
  T c[kHoisted ? 3 : 6];
};

template <typename T>
__device__ __forceinline__ void load_ids(const StageArgs<T>& a,
                                         const Step& st, int t, Ids& e) {
  const int k = st.k0 + t / a.B;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    e.up_slot[j] = (int)__ldg(a.up_slot + 2 * k + j);
    e.up_site[j] = (int)__ldg(a.up_site + 2 * k + j);
  }
  e.row_site = (int)__ldg(a.row_site + k);
}

template <typename T, bool kHoisted, bool kFold>
__device__ __forceinline__ void prepare(const StageArgs<T>& a,
                                        const Step& cur, const Step& prev,
                                        int t, const Ids& e,
                                        Item<T, kHoisted>& q) {
  const int row = t / a.B;
  const int lam = t - row * a.B;
  const int k = cur.k0 + row;
  const int self = a.start + k;
  q.in0 = read_at(a, prev, e.up_slot[0], lam);
  q.in1 = read_at(a, prev, e.up_slot[1], lam);
  if (kFold) q.old = read_at(a, prev, self, lam);
  q.out = cur.buf < 0
              ? a.I + (self * a.B + lam)
              : a.scratch + (cur.buf * a.scratch_len + row * a.B + lam);
  const int c = e.row_site * a.B + lam;
  const T a_c = __ldg(a.a_T + c), s_c = __ldg(a.S_T + c);
  T wj[2], ew[2], src[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int u = e.up_site[j] * a.B + lam;
    const T dtau = __ldg(a.r + 2 * k + j) * (a_c + __ldg(a.a_T + u)) * T(0.5);
    T aw, bw;
    linear_weights(dtau, aw, bw, ew[j]);
    src[j] = aw * __ldg(a.S_T + u) + bw * s_c;
    wj[j] = __ldg(a.w + 2 * k + j);
  }
  if (kHoisted) {
    q.c[0] = wj[0] * ew[0];
    q.c[1] = wj[1] * ew[1];
    q.c[2] = wj[0] * src[0] + wj[1] * src[1];
  } else {
    q.c[0] = wj[0];
    q.c[1] = ew[0];
    q.c[2] = src[0];
    q.c[3] = wj[1];
    q.c[4] = ew[1];
    q.c[5] = src[1];
  }
}

// One item's work after the barrier.
template <typename T, bool kHoisted, bool kFold>
__device__ __forceinline__ void finish(const Item<T, kHoisted>& q,
                                       typename Bits<T>::U& d_bits,
                                       typename Bits<T>::U& s_bits) {
  const T i0 = __ldcg(q.in0), i1 = __ldcg(q.in1);
  T i_new;
  if (kHoisted)
    i_new = q.c[0] * i0 + q.c[1] * i1 + q.c[2];
  else
    i_new = q.c[0] * (q.c[1] * i0 + q.c[2]) + q.c[3] * (q.c[4] * i1 + q.c[5]);
  if (kFold) {
    const T i_old = __ldcg(q.old);
    d_bits = umax(d_bits, Bits<T>::of(fabs(i_new - i_old)));
    s_bits = umax(s_bits, Bits<T>::of(fabs(i_new)));
  }
  __stcg(q.out, i_new);
}

// Copy a self-referencing step's scratch rows back into I, this thread's
// share.
template <typename T>
__device__ __forceinline__ void copy_back(const StageArgs<T>& a,
                                          const Step& st, int g, int G) {
  const T* src = a.scratch + st.buf * a.scratch_len;
  T* dst = a.I + (a.start + st.k0) * a.B;
  const int n = st.rows * a.B;
  for (int t = g; t < n; t += G) __stcg(dst + t, __ldcg(src + t));
}

// One item ahead: at most 64 registers a thread, so that 4 blocks an SM
// are resident and a step of the 442k-site production plans is about
// one item a thread at B = 91.
template <typename T, bool kHoisted, bool kFold>
__global__ void __launch_bounds__(STAGE_THREADS, 4)
    voronoi_stage_kernel(const StageArgs<T> a) {
  using U = typename Bits<T>::U;
  const int G = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  U d_bits = 0, s_bits = 0;
  Item<T, kHoisted> q;
  Ids e;
  Step prev = {0, 0, -1};
  Step cur = load_step(a.steps, 0);
  Step next = a.n_steps > 1 ? load_step(a.steps, 1) : Step{0, 0, -1};
  if (g < cur.rows * a.B) {
    load_ids(a, cur, g, e);
    prepare<T, kHoisted, kFold>(a, cur, prev, g, e, q);
  }
  if (g < next.rows * a.B) load_ids(a, next, g, e);
  unsigned long long target = 0;
  for (int s = 0; s < a.n_steps; ++s) {
    const int n = cur.rows * a.B;
    if (g < n) finish<T, kHoisted, kFold>(q, d_bits, s_bits);
    // the items past the first: ids, field work and loads after the
    // barrier
    for (int t = g + G; t < n; t += G) {
      Ids late;
      load_ids(a, cur, t, late);
      prepare<T, kHoisted, kFold>(a, cur, prev, t, late, q);
      finish<T, kHoisted, kFold>(q, d_bits, s_bits);
    }
    if (prev.buf >= 0) copy_back(a, prev, g, G);
    prev = cur;
    // the last step needs its barrier only to copy its scratch rows back
    const bool sync = s + 1 < a.n_steps || prev.buf >= 0;
    if (sync) barrier_arrive(a.bar);
    if (s + 1 < a.n_steps) {
      cur = next;
      next = s + 2 < a.n_steps ? load_step(a.steps, s + 2) : Step{0, 0, -1};
      if (g < cur.rows * a.B)
        prepare<T, kHoisted, kFold>(a, cur, prev, g, e, q);
      if (g < next.rows * a.B) load_ids(a, next, g, e);
    }
    if (sync) {
      target += gridDim.x;
      barrier_wait(a.bar, target);
    }
  }
  if (prev.buf >= 0) copy_back(a, prev, g, G);
  if (kFold) {
    __shared__ U sh[2][STAGE_THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    d_bits = warp_max(d_bits);
    s_bits = warp_max(s_bits);
    if (lane == 0) {
      sh[0][warp] = d_bits;
      sh[1][warp] = s_bits;
    }
    __syncthreads();
    if (warp == 0) {
      d_bits = lane < STAGE_THREADS / 32 ? sh[0][lane] : U(0);
      s_bits = lane < STAGE_THREADS / 32 ? sh[1][lane] : U(0);
      d_bits = warp_max(d_bits);
      s_bits = warp_max(s_bits);
      if (lane == 0) {
        if (d_bits) atomicMax(a.change, d_bits);
        if (s_bits) atomicMax(a.change + 1, s_bits);
      }
    }
  }
}

template <typename T>
using StageKernel = void (*)(const StageArgs<T>);

template <typename T>
static StageKernel<T> pick(int hoisted, int fold) {
  if (hoisted && fold) return voronoi_stage_kernel<T, true, true>;
  if (hoisted) return voronoi_stage_kernel<T, true, false>;
  if (fold) return voronoi_stage_kernel<T, false, true>;
  return voronoi_stage_kernel<T, false, false>;
}

// info[0]: blocks of the variant an SM holds at once; info[1]: the
// device's SMs; info[2]: threads a block; info[3]: 1 if the device takes
// cooperative launches.
template <typename T>
static int stage_info(int hoisted, int fold, int* info) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info[0], pick<T>(hoisted, fold), STAGE_THREADS, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&info[1], cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&info[3], cudaDevAttrCooperativeLaunch, dev);
  info[2] = STAGE_THREADS;
  return (int)err;
}

// One stage (or relax lap) on the stream, in one cooperative launch of
// `blocks` blocks.  scratch: two buffers of scratch_rows * B values (null
// when no step is self-referencing); steps: the device step table; bar:
// one 64-bit word, zeroed here.  Returns the first CUDA error, or 0.
template <typename T>
static int run_stage(T* I, const T* S_T, const T* a_T,
                     const long long* up_slot, const long long* up_site,
                     const long long* row_site, const T* w, const T* r,
                     T* scratch, void* change, const long long* steps,
                     void* bar, int n_steps, int scratch_rows, int B,
                     int start, int hoisted, int fold, int blocks,
                     void* stream_p) {
  const cudaStream_t stream = (cudaStream_t)stream_p;
  const StageArgs<T> a{I, scratch, scratch_rows * B, S_T, a_T,
                       up_slot, up_site, row_site, w, r, steps,
                       (typename Bits<T>::U*)change, (unsigned long long*)bar,
                       n_steps, B, start};
  cudaError_t err = cudaMemsetAsync(bar, 0, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)pick<T>(hoisted, fold),
                                    dim3(blocks), dim3(STAGE_THREADS), args, 0,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#define VRT_STAGE_ENTRY(NAME, INFO, T)                                        \
  extern "C" int NAME(T* I, const T* S_T, const T* a_T,                       \
                      const long long* up_slot, const long long* up_site,     \
                      const long long* row_site, const T* w, const T* r,      \
                      T* scratch, void* change, const long long* steps,       \
                      void* bar, int n_steps, int scratch_rows, int B,        \
                      int start, int hoisted, int fold, int blocks,           \
                      void* stream) {                                         \
    return run_stage<T>(I, S_T, a_T, up_slot, up_site, row_site, w, r,       \
                        scratch, change, steps, bar, n_steps, scratch_rows,   \
                        B, start, hoisted, fold, blocks, stream);             \
  }                                                                           \
  extern "C" int INFO(int hoisted, int fold, int* info) {                     \
    return stage_info<T>(hoisted, fold, info);                                \
  }

VRT_STAGE_ENTRY(vrt_voronoi_stage_f64, vrt_voronoi_stage_info_f64, double)
VRT_STAGE_ENTRY(vrt_voronoi_stage_f32, vrt_voronoi_stage_info_f32, float)
