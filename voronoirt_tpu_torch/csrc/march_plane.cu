// One z-plane of the yz / xz in-plane march of the regular sweep, as two
// kernels: march_coeffs (the pass-invariant precompute, over the whole
// card) and march_chain (the sequential column chain, W warps a line).
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
// I_new is affine in buf, I_new = coeff LI(buf) + const (the regrouping
// of sweep_regular._march_step), so:
//
// march_coeffs computes coeff = e wc and const (one exp per point) for all
// B planes into the scratch, laid out (B, N, MP, 2): batch element,
// column along the march, point along the line, then the pair (coeff,
// const) interleaved, so one 16-byte (f64) or 8-byte (f32) load brings a
// point's two values.  MP is the line padded to 32 * PPL points, PPL the
// smallest power of two with 32 * PPL >= M (solvers/march_plane.py
// line_pad); the padding pairs are zero.  Blocks of 32 x 4 threads own a
// 32 x 32 tile of the plane, read it in memory order and write it through
// shared memory along m, so both the reads and the writes are coalesced
// for either march axis.  Bound on the card: HBM bytes, 5 planes in and
// 2 out (7 x 27.26 MB at B = 52, 256 x 256, f64: 57 us at 3.35 TB/s).
//
// march_chain runs the n_sweeps * N dependent column steps.  Its bound is
// the latency of that chain: each step needs the previous line at
// m + s_base and m + s_base + 1.  A block of W warps (W = 1, 4 or 8)
// owns one batch element's line (B blocks).  Warp w owns the run of
// RUN = MP / W points from w RUN, and also steps a halo of kHalo = 32
// points on the run's upwind side: after it for s_base 0, before it for
// s_base -1.  A step's point reads only itself and its upwind neighbour
// in the line before, so k steps after the halo was exact its first
// kHalo - k points still are: every kHalo steps each warp writes the
// points of its run that the other warps' halos read (its first or last
// kHalo) into an exchange line in shared memory, indexed by point and
// double-buffered, the block meets at its one barrier (bar.sync over the
// W warps), and each warp reloads its halo from the line.  Between
// exchanges no warp waits on another.  The line is periodic: the halo
// after the last run is the first run's head, and on a line shorter than
// MP the halo after point M - 1 is point 0, as the point map pt(e) = (w
// RUN + e - lead) mod M gives it; a warp whose run lies past M owns
// nothing and only meets the barrier.  Lane l of a warp holds the points
// e = 32 j + l of its stretch (its run and halo), j < SL = RUN / 32 + 1
// (SL = PPL at W = 1), in registers, and each step's neighbours come from
// the adjacent lane by __shfl_sync (SL shuffles a step); the slot at the
// stretch's downwind end reads a wrapped lane and is stale until the
// next exchange, as no owned point reads it before.  W = 1 is one warp a
// line: the whole line in its lanes, the periodic wrap between lane 31
// and lane 0 and, on a line shorter than MP, between point M - 1 and
// point 0 (RAGGED), no barrier at all.  The (coeff, const) rows stream
// through a ring of kStages shared-memory stages with cp.async, kStages
// rows ahead of use; each warp has its own part of a stage and each lane
// copies and reads only its own slots' pairs, so cp.async.wait_group
// alone orders a row's arrival, and a warp waits once every 4 rows.  A
// warp's copies, ring reads and yz stores each touch 32 consecutive
// points.  In the xz case the last pass's lines collect in a shared tile
// of up to 32 columns, double-buffered: a full tile drains during the
// next tile's steps, a few rows a step, as runs of consecutive y per x,
// so no store is strided by ny and none waits on a flush; each warp
// drains the rows of its own run; tile rows are an odd number of words
// apart, so the drain's reads do not conflict on the banks.  The stencil
// shift, the march axis, W and a ragged one-warp line are template
// parameters, and the last pass, which writes the output, is a loop of
// its own, so the other passes compile alike for both axes.  Lines of up
// to kMaxLine = 2048 points run in the same kernel with PPL up to 64.
//
// W is a function of the line: solvers/march_plane.py chain_split
// chooses W = min(8, PPL) from PPL 4 and one warp below, and the
// launcher refuses any other (VRT_CHAIN_SPLITS lists the instances
// built).  On the H100 (PERF.md §6, K2b by split, measured with W = 2
// and 4 built too and the halo a launch argument) a step at 256 points
// cost about 235 ns at W = 1 and 2, 177 at W = 4 and 170 at W = 8, at B =
// 1, 13 and 52, and about 215 at W = 4 and 8 against 245 at B = 124; an
// exchange every step cost more than the split saved, and a halo of 32,
// the widest one extra slot a lane holds, was the fastest or within 4 %
// of it.  What is left of a step is its latency: the shuffles, the four
// dependent float64 operations and, in the xz case, the drain; a ring of
// bulk (TMA) copies and reads a step ahead were measured and bought
// nothing.  At B = 124 the chain reads its scratch n_sweeps times from
// HBM (390 MB a launch at 256 x 256) and HBM sets its pace.
//
// Why points are strided over the lanes, not contiguous runs of PPL with
// one shuffle a step: the contiguous layout's per-lane copies touch 32
// lines an instruction, and with coalesced copies into a permuted ring
// plus one __syncwarp a step it measured no faster on the H100 than this
// layout.
//
// Rounding: op for op the plain version's order, built with -fmad=false:
// (1 - f) lo + f hi, then coeff * LI + const as a multiply and an add.
#include "formal.cuh"

constexpr int kMaxLine = 2048;
constexpr int kTile = 32;        // march_coeffs: a 32 x 32 tile a block
constexpr int kTileRows = 4;     // of 32 x 4 threads, 8 points a thread
constexpr int kRingBytes = 131072;   // march_chain: row ring budget
constexpr int kSmemMax = 232448;     // shared memory a block may have (227 KB)
constexpr int kHalo = 32;   // march_chain at W > 1: halo points, and steps
                            // between exchanges

template <typename T> struct PairOf;
template <> struct PairOf<double> { using type = double2; };
template <> struct PairOf<float> { using type = float2; };

// ------------------------------------------------------------ march_coeffs

template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows)
march_coeffs_kernel(const T* __restrict__ a_p, const T* __restrict__ a_c,
                    const T* __restrict__ s_p, const T* __restrict__ s_c,
                    const T* __restrict__ i_p, const T* __restrict__ r,
                    const T* __restrict__ f_line,
                    const T* __restrict__ w_cur,
                    const T* __restrict__ c_prev, T* __restrict__ scratch,
                    int nx, int ny, int mp, int march_x, int sign,
                    int s_base) {
  using P = typename PairOf<T>::type;
  __shared__ P tile[kTile][kTile + 1];

  const int b = blockIdx.z;
  const int x0 = blockIdx.y * kTile, y0 = blockIdx.x * kTile;
  const int N = march_x ? nx : ny;     // columns along the march
  const int M = march_x ? ny : nx;     // points along a line
  const long long base = (long long)b * nx * ny;
  const T rb = r[b], f = f_line[b], wc = w_cur[b], cp = c_prev[b];
  const T wp = T(1) - wc;

  // plane offset of (column c, line position m)
  auto at = [&](int c, int m) -> long long {
    return base + (march_x ? (long long)c * ny + m : (long long)m * ny + c);
  };

  // compute in memory order (x rows, threadIdx.x along y); points
  // outside the plane are the line's zero padding
#pragma unroll
  for (int i = threadIdx.y; i < kTile; i += kTileRows) {
    const int x = x0 + i, y = y0 + threadIdx.x;
    P v;
    v.x = T(0);
    v.y = T(0);
    if (x < nx && y < ny) {
      const int c = march_x ? x : y;
      const int m = march_x ? y : x;
      const int cw = wrap(c + sign, N);
      const long long u0 = at(cw, wrap(m + s_base, M));
      const long long u1 = at(cw, wrap(m + s_base + 1, M));
      auto LI = [&](const T* A) { return (T(1) - f) * A[u0] + f * A[u1]; };
      const long long ctr = base + (long long)x * ny + y;
      const T a_up = wp * LI(a_p) + wc * LI(a_c);
      const T a_c0 = cp * a_p[ctr] + (T(1) - cp) * a_c[ctr];
      const T dtau = rb * (a_c0 + a_up) * T(0.5);
      T aw, bw, ew;
      linear_weights(dtau, aw, bw, ew);
      const T s_up = wp * LI(s_p) + wc * LI(s_c);
      const T s_c0 = cp * s_p[ctr] + (T(1) - cp) * s_c[ctr];
      v.x = ew * wc;
      v.y = ew * (wp * LI(i_p)) + aw * s_up + bw * s_c0;
    }
    tile[i][threadIdx.x] = v;
  }
  __syncthreads();

  // store along m: (c, m) = (x, y) in the yz case, (y, x) in the xz case
  P* out = reinterpret_cast<P*>(scratch);
  for (int i = threadIdx.y; i < kTile; i += kTileRows) {
    const int c = (march_x ? x0 : y0) + i;
    const int m = (march_x ? y0 : x0) + threadIdx.x;
    if (c < N && m < mp)
      out[((long long)b * N + c) * mp + m] =
          march_x ? tile[i][threadIdx.x] : tile[threadIdx.x][i];
  }
}

// ------------------------------------------------------------- march_chain

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// asynchronous global -> shared copy of one (coeff, const) pair
template <int BYTES>
__device__ __forceinline__ void cp_async_pair(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                 "r"(smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::
                 "r"(smem_addr(dst)), "l"(src), "n"(BYTES) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// no barrier follows the wait: its "memory" clobber alone keeps the
// compiler from hoisting the ring's shared loads above it
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

template <typename T, int PPL, int W>
struct ChainShape {
  using P = typename PairOf<T>::type;
  static constexpr int kMP = 32 * PPL;                    // padded line
  // a warp's run of the line, and the slots a lane holds: the whole line
  // at W = 1, else the run and its halo, one slot a lane
  static constexpr int kRun = kMP / W;
  static constexpr int kSL = W == 1 ? PPL : kRun / 32 + kHalo / 32;
  static constexpr int kRowBytes = W * 32 * kSL * (int)sizeof(P);
  // xz last pass: two tiles of kTileCols columns, one row of kMP points
  // a column, rows an odd number of T apart; 66 KB a tile up to 256
  // points a line, 32.5 KB above, so ring and tiles fit in 227 KB
  static constexpr int kTileStride = kMP + 1;
  static constexpr int kTileBytes = PPL <= 8 ? 67584 : 33280;
  static constexpr int kTileColsRaw =
      kTileBytes / (kTileStride * (int)sizeof(T));
  static constexpr int kTileCols =
      kTileColsRaw > 32 ? 32 : (kTileColsRaw < 1 ? 1 : kTileColsRaw);
  static constexpr int kTilesBytes =
      2 * kTileCols * kTileStride * (int)sizeof(T);
  // W > 1: the exchange line, double-buffered, indexed by point
  static constexpr int kXBytes = W == 1 ? 0 : 2 * kMP * (int)sizeof(T);
  static constexpr int kRingBudget =
      W == 1 || kRingBytes <= kSmemMax - kTilesBytes - kXBytes
          ? kRingBytes : kSmemMax - kTilesBytes - kXBytes;
  static constexpr int kStagesRaw = kRingBudget / kRowBytes;
  static constexpr int kStages =
      kStagesRaw > 16 ? 16 : (kStagesRaw < 2 ? 2 : kStagesRaw);
  // rows a warp drains a step: its run's tile drains in kTileCols steps
  // up to 256 points a run (at most 16 rows a step, held in registers)
  static constexpr int kDrainRaw = (kRun + kTileCols - 1) / kTileCols;
  static constexpr int kDrainRows = kDrainRaw > 16 ? 16 : kDrainRaw;
  static constexpr size_t kSmem =
      (size_t)kStages * kRowBytes + kTilesBytes + kXBytes;
  static_assert(W == 1 || kRun >= kHalo, "a run holds its neighbour's halo");
  static_assert(kHalo == 32, "the halo is one slot a lane");
  static_assert(kSmem <= (size_t)kSmemMax, "shared memory of a block");
};

template <typename T, int PPL, int W, bool RAGGED, int S_BASE, bool MARCH_X>
__global__ void __launch_bounds__(32 * W)
march_chain_kernel(const T* __restrict__ scratch,
                   const T* __restrict__ f_line, T* __restrict__ out,
                   int nx, int ny, int sign, int n_sweeps) {
  using Shape = ChainShape<T, PPL, W>;
  using P = typename Shape::P;
  constexpr int MP = Shape::kMP;
  constexpr int RUN = Shape::kRun;
  constexpr int SL = Shape::kSL;
  constexpr int E = 32 * SL;                 // a warp's slots
  constexpr int S = Shape::kStages;
  constexpr int TS = Shape::kTileStride;
  constexpr int TW = Shape::kTileCols;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* ring = reinterpret_cast<P*>(smem_raw);                  // [S][W][E]
  T* tiles = reinterpret_cast<T*>(ring + (size_t)S * W * E);  // [2][TW][TS]
  T* xline = tiles + 2 * TW * TS;                             // [2][MP]

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int N = MARCH_X ? nx : ny;
  const int M = MARCH_X ? ny : nx;
  const long long base = (long long)b * nx * ny;
  const P* rows = reinterpret_cast<const P*>(scratch) + (long long)b * N * MP;
  const T f = f_line[b];
  const T omf = T(1) - f;
  const int steps = n_sweeps * N;
  const int first_last = steps - N;          // first step of the last pass

  // warp w's slots: slot j of a lane is point e = 32 j + lane of the
  // warp's stretch, which is the line point pt(e) = (w RUN + e - lead)
  // mod M.  The warp owns the points of its run, e in [lead, lead +
  // n_own); the kHalo points on the upwind side of it are its halo, after
  // the run for S_BASE 0 (lead 0), before it for S_BASE -1 (lead kHalo).
  // At W = 1 the stretch is the line, lead 0, and pt(e) = e
  const int start = w * RUN;
  const int lead = W > 1 && S_BASE != 0 ? kHalo : 0;
  const int n_own = W == 1 ? M : (M - start < 0 ? 0 : (M - start < RUN
                                                        ? M - start : RUN));
  const int h_lo = S_BASE == 0 ? n_own : 0;
  // the points of the run the other warps' halos read: its first kHalo
  // (S_BASE 0) or its last kHalo (S_BASE -1)
  const int n_x = kHalo < n_own ? kHalo : n_own;
  const int x_lo = S_BASE == 0 ? 0 : lead + n_own - n_x;
  int pt[SL];
#pragma unroll
  for (int j = 0; j < SL; ++j) {
    const int m = (start + 32 * j + lane - lead) % M;
    pt[j] = W == 1 ? 32 * j + lane : (m < 0 ? m + M : m);
  }

  // point M - 1, where the line wraps to point 0: lane 31's last slot
  // unless the line is RAGGED (shorter than MP; W = 1 only)
  const int wrap_lane = (M - 1) % 32, wrap_slot = (M - 1) / 32;
  const int src_next = (lane + 1) & 31, src_prev = (lane + 31) & 31;

  // issue the next row into its ring stage (an empty group past the end):
  // each lane copies the pairs of its own slots
  int n_issue = 0, i_issue = 0;              // i_issue = n_issue % N
  auto issue = [&]() {
    if (n_issue < steps) {
      const int c = sign > 0 ? i_issue : N - 1 - i_issue;
      const P* src = rows + (long long)c * MP;
      P* dst = ring + ((n_issue % S) * W + w) * E + lane;
#pragma unroll
      for (int j = 0; j < SL; ++j)
        cp_async_pair<sizeof(P)>(dst + j * 32, src + pt[j]);
    }
    cp_async_commit();
    ++n_issue;
    if (++i_issue == N) i_issue = 0;
  };

  // xz case: the last pass's lines collect in tile g % 2 for the columns
  // of tile group g, and the full tile g - 1 drains during group g, a
  // few rows a step: lane cc writes column clo + cc, so every store is a
  // run of consecutive y at one x.  A warp drains the rows of its own
  // run, so only __syncwarp orders a tile's writes and reads
  constexpr int R = Shape::kDrainRows;
  const int d_end = start + n_own;           // past the warp's last row
  const T* d_tile = tiles;                   // the tile draining
  int d_m = d_end, d_clo = 0, d_w = 0;       // its next row, columns
  auto drain = [&]() {                       // its next R rows: all loads
    if (lane < d_w) {                        // first, then all stores
      const T* trow = d_tile + (sign > 0 ? lane : d_w - 1 - lane) * TS;
      T* ocol = out + base + d_clo + lane + (long long)d_m * ny;
      T vals[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        vals[r] = d_m + r < d_end ? trow[d_m + r] : T(0);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (d_m + r < d_end) ocol[(long long)r * ny] = vals[r];
    }
    d_m = d_m + R < d_end ? d_m + R : d_end;
  };
  // start draining tile group g (its first step g0, its `cols` columns)
  auto start_drain = [&](int g0, int cols) {
    d_tile = tiles + ((g0 / TW) & 1) * TW * TS;
    d_clo = sign > 0 ? g0 : N - g0 - cols;
    d_w = cols;
    d_m = start;
  };

  for (int k = 0; k < S; ++k) issue();

  T v[SL];
#pragma unroll
  for (int j = 0; j < SL; ++j) v[j] = T(0);

  // one column step: the stretch v from row n of the ring.  At W > 1
  // the slot past the stretch's downwind end takes a wrapped lane's
  // value: it is stale, and no owned point reads it before an exchange
  auto step = [&](int n) {
    const P* st = ring + ((n % S) * W + w) * E + lane;
    if (S_BASE == 0) {
      // point m + 1: lane + 1's same slot; lane 31 takes lane 0's next
      // slot; point M - 1 takes point 0.  Ascending j, so every value
      // sent is still the previous line's (v[0] kept for the last slot)
      const T p0 = RAGGED ? __shfl_sync(kFull, v[0], 0) : T(0);
      const T v0 = v[0];
#pragma unroll
      for (int j = 0; j < SL; ++j) {
        T hi = __shfl_sync(
            kFull, lane == 0 ? (j + 1 < SL ? v[j + 1] : v0) : v[j],
            src_next);
        if (RAGGED && lane == wrap_lane && j == wrap_slot) hi = p0;
        const P ck = st[j * 32];
        const T li = omf * v[j] + f * hi;
        v[j] = ck.x * li + ck.y;
      }
    } else {
      // point m - 1: lane - 1's same slot; lane 0 takes lane 31's
      // previous slot; point 0 takes point M - 1.  Descending j, so
      // every value sent is still the previous line's
      T pm = v[0];
      if (RAGGED) {
#pragma unroll
        for (int j = 1; j < SL; ++j)
          if (j == wrap_slot) pm = v[j];
        pm = __shfl_sync(kFull, pm, wrap_lane);
      }
      const T vl = v[SL - 1];
#pragma unroll
      for (int j = SL - 1; j >= 0; --j) {
        T lo = __shfl_sync(
            kFull, lane == 31 ? (j > 0 ? v[j - 1] : vl) : v[j], src_prev);
        if (RAGGED && lane == 0 && j == 0) lo = pm;
        const P ck = st[j * 32];
        const T li = omf * lo + f * v[j];
        v[j] = ck.x * li + ck.y;
      }
    }
  };

  // W > 1: after kHalo steps a halo is exact no more, so every kHalo
  // steps each warp puts the points the others' halos read into the
  // exchange line, the block's warps meet at one barrier, and each warp
  // reloads its halo.  The line alternates between two buffers, so a
  // warp may write the next one while another still reads this one
  int since = 0, x_buf = 0;
  auto exchange = [&]() {
    T* xl = xline + x_buf * MP;
    x_buf ^= 1;
#pragma unroll
    for (int j = 0; j < SL; ++j)
      if ((unsigned)(32 * j + lane - x_lo) < (unsigned)n_x) xl[pt[j]] = v[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SL; ++j)
      if (n_own > 0 && (unsigned)(32 * j + lane - h_lo) < (unsigned)kHalo)
        v[j] = xl[pt[j]];
  };
  auto next_step = [&](int n) {
    if (W > 1) {
      if (since == kHalo) {
        exchange();
        since = 0;
      }
      ++since;
    }
    step(n);
  };
  // is slot j of this lane one of the warp's own points
  auto owned = [&](int j) {
    return (unsigned)(32 * j + lane - lead) < (unsigned)n_own;
  };

  // the ring is waited on once every K steps: rows n .. n + K - 1 have
  // landed when the wait returns
  constexpr int K = S >= 8 ? 4 : 1;
  int n = 0;
  for (; n < first_last; ++n) {              // every pass but the last
    if (n % K == 0) cp_async_wait<S - K>();
    next_step(n);
    issue();
  }
  for (int i = 0; i < N; ++i, ++n) {         // the last pass, with output
    if (n % K == 0) cp_async_wait<S - K>();
    next_step(n);
    if (MARCH_X) {                           // yz: the line is a row of y
      const int c = sign > 0 ? i : N - 1 - i;
      T* orow = out + base + (long long)c * ny + start - lead;
#pragma unroll
      for (int j = 0; j < SL; ++j)
        if (owned(j)) orow[j * 32 + lane] = v[j];
    } else {                                 // xz: collect, and drain
      const int slot = i % TW;               // step in its tile group
      if (slot == 0 && i > 0) {              // the group before is full
        while (d_m < d_end) drain();         // (the one before drains)
        __syncwarp();
        start_drain(i - TW, TW);
      }
      T* trow = tiles + ((i / TW) & 1) * TW * TS + slot * TS + start - lead +
                lane;
#pragma unroll
      for (int j = 0; j < SL; ++j)
        if (owned(j)) trow[j * 32] = v[j];
      if (d_m < d_end) drain();
    }
    issue();
  }
  cp_async_wait<0>();
  if (!MARCH_X) {                            // the last group, and the one
    while (d_m < d_end) drain();             // before if it was short
    __syncwarp();
    const int g_last = (N - 1) - (N - 1) % TW;
    start_drain(g_last, N - g_last);
    while (d_m < d_end) drain();
  }
}

// ---------------------------------------------------------------- launches

template <typename T>
static int launch_coeffs(const T* a_p, const T* a_c, const T* s_p,
                         const T* s_c, const T* i_p, const T* r,
                         const T* f_line, const T* w_cur, const T* c_prev,
                         T* scratch, int B, int nx, int ny, int mp,
                         int march_x, int sign, int s_base, void* stream) {
  if (B == 0 || nx == 0 || ny == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  // the tile grid covers the plane, and the padded line along m
  const int ext_x = march_x ? nx : mp, ext_y = march_x ? mp : ny;
  const dim3 grid((ext_y + kTile - 1) / kTile, (ext_x + kTile - 1) / kTile,
                  B);
  march_coeffs_kernel<T><<<grid, dim3(kTile, kTileRows), 0,
                           (cudaStream_t)stream>>>(
      a_p, a_c, s_p, s_c, i_p, r, f_line, w_cur, c_prev, scratch, nx, ny,
      mp, march_x, sign, s_base);
  return (int)cudaGetLastError();
}

template <typename T, int PPL, int W, bool RAGGED, int S_BASE, bool MARCH_X>
static int launch_chain_cfg(const T* scratch, const T* f_line, T* out, int B,
                            int nx, int ny, int sign, int n_sweeps,
                            void* stream) {
  const size_t smem = ChainShape<T, PPL, W>::kSmem;
  auto kernel = march_chain_kernel<T, PPL, W, RAGGED, S_BASE, MARCH_X>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, 32 * W, smem, (cudaStream_t)stream>>>(scratch, f_line, out, nx,
                                                     ny, sign, n_sweeps);
  return (int)cudaGetLastError();
}

// the stencil shift, the march axis and a line shorter than MP are
// compile-time: as runtime branches they cost the chain 10 % a step.  A
// split line (W > 1) reaches its wrap through pt(), so its ragged lines
// run the full lines' instance
template <typename T, int PPL, int W>
static int launch_chain_split(const T* scratch, const T* f_line, T* out,
                              int B, int nx, int ny, bool ragged,
                              int march_x, int sign, int s_base,
                              int n_sweeps, void* stream) {
  using Launch = int (*)(const T*, const T*, T*, int, int, int, int, int,
                         void*);
  constexpr bool RG = W == 1;
  static constexpr Launch table[2][2][2] = {
      {{launch_chain_cfg<T, PPL, W, false, 0, false>,
        launch_chain_cfg<T, PPL, W, false, 0, true>},
       {launch_chain_cfg<T, PPL, W, false, -1, false>,
        launch_chain_cfg<T, PPL, W, false, -1, true>}},
      {{launch_chain_cfg<T, PPL, W, RG, 0, false>,
        launch_chain_cfg<T, PPL, W, RG, 0, true>},
       {launch_chain_cfg<T, PPL, W, RG, -1, false>,
        launch_chain_cfg<T, PPL, W, RG, -1, true>}}};
  return table[ragged][s_base != 0][march_x != 0](scratch, f_line, out, B,
                                                  nx, ny, sign, n_sweeps,
                                                  stream);
}

// the (PPL, W) pairs built, one W a line: solvers/march_plane.py
// chain_split's choice; a launch at any other W is refused
#define VRT_CHAIN_SPLITS(X)                                                \
  X(1, 1) X(2, 1) X(4, 4) X(8, 8) X(16, 8) X(32, 8) X(64, 8)

template <typename T>
static int launch_chain(const T* scratch, const T* f_line, T* out, int B,
                        int nx, int ny, int mp, int march_x, int sign,
                        int s_base, int n_sweeps, int w, void* stream) {
  if (B == 0 || nx == 0 || ny == 0) return 0;
  const int M = march_x ? ny : nx;
  if (M > kMaxLine || mp < M || mp > 32 * 64 || mp % 32 != 0 ||
      (s_base != 0 && s_base != -1))
    return (int)cudaErrorInvalidValue;
  const bool ragged = M != mp;
#define VRT_CHAIN(PPL, W)                                                  \
  if (mp == 32 * PPL && w == W)                                            \
    return launch_chain_split<T, PPL, W>(scratch, f_line, out, B, nx, ny,  \
                                         ragged, march_x, sign, s_base,    \
                                         n_sweeps, stream);
  VRT_CHAIN_SPLITS(VRT_CHAIN)
#undef VRT_CHAIN
  return (int)cudaErrorInvalidValue;
}

extern "C" int vrt_march_coeffs_f64(
    const double* a_p, const double* a_c, const double* s_p,
    const double* s_c, const double* i_p, const double* r,
    const double* f_line, const double* w_cur, const double* c_prev,
    double* scratch, int B, int nx, int ny, int mp, int march_x, int sign,
    int s_base, void* stream) {
  return launch_coeffs<double>(a_p, a_c, s_p, s_c, i_p, r, f_line, w_cur,
                               c_prev, scratch, B, nx, ny, mp, march_x, sign,
                               s_base, stream);
}

extern "C" int vrt_march_coeffs_f32(
    const float* a_p, const float* a_c, const float* s_p, const float* s_c,
    const float* i_p, const float* r, const float* f_line,
    const float* w_cur, const float* c_prev, float* scratch, int B, int nx,
    int ny, int mp, int march_x, int sign, int s_base, void* stream) {
  return launch_coeffs<float>(a_p, a_c, s_p, s_c, i_p, r, f_line, w_cur,
                              c_prev, scratch, B, nx, ny, mp, march_x, sign,
                              s_base, stream);
}

extern "C" int vrt_march_chain_f64(const double* scratch,
                                   const double* f_line, double* out, int B,
                                   int nx, int ny, int mp, int march_x,
                                   int sign, int s_base, int n_sweeps, int w,
                                   void* stream) {
  return launch_chain<double>(scratch, f_line, out, B, nx, ny, mp, march_x,
                              sign, s_base, n_sweeps, w, stream);
}

extern "C" int vrt_march_chain_f32(const float* scratch, const float* f_line,
                                   float* out, int B, int nx, int ny, int mp,
                                   int march_x, int sign, int s_base,
                                   int n_sweeps, int w, void* stream) {
  return launch_chain<float>(scratch, f_line, out, B, nx, ny, mp, march_x,
                             sign, s_base, n_sweeps, w, stream);
}
