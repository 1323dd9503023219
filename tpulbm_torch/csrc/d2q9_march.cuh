// The D2Q9 row march: N fused D2Q9 timesteps per launch on an NVIDIA
// Hopper GPU (sm_90a), float32, for any depth N >= 1. step_d2q9.cu
// instantiates it at N = 1 (one step a launch), step_d2q9_blocked.cu at
// N = 2-4 and, in its deep build, 5-8: one design serves every D2Q9 depth.
// Each substep is the sequence of d2q9_common.cuh: collide (+ source,
// + force profile) -> pull-stream -> ghost rule -> the domain's boundary
// sequence (the cylinder's walls, Zou-He inlet and outlet, clean corners
// and obstacle; the channel's periodic x and walls, or the slab's periodic
// x and mask; the cavity's walls, lid and corners; the box's periodic x
// and y).
//
// Design: a row march (wavefront temporal blocking), the TPU kernels' own
// shape (make_local_step_pallasN marches y with 3-slot rings per stage). A
// block owns a strip of kBX = kW0 - 2N output columns and a segment
// [y0, y1) of rows and marches up the segment kR rows (a batch) per march
// step. Stage s (0 <= s < N) holds the state after s substeps, collided,
// over stage 0's widened row of kW0 columns (the strip and N columns a
// side; stage s computes columns s .. kW0-1-s of it) and over the rows
// [y0 - (N - s), y1 + (N - s)), in a ring of rows in shared memory. Stage
// 0 collides the raw rows in place; stage s (1 <= s < N) pulls its rows
// from stage s-1's ring, applies the boundary sequence at the cell's global
// coordinates and collides them into its own ring; stage N pulls the
// strip's own columns, applies the boundary sequence and stores them to
// `out` (at N = 1 stage 0's ring is the only one). Stage s works on batch
// m - kLag s at march step m, so every row it reads was written at an
// earlier march step: all stages of a step run at once and ONE barrier
// ends the step. A thread is one stage's cell of a column and a row of the
// batch: (N + 1) kW0 kR threads, each stage whole warps where kW0 is a
// multiple of 32, so no warp mixes stages; a thread carries one cell's 9
// populations and the collision's temporaries. One code path serves every
// stage (the stage a run-time value), so the collision and the pull are
// compiled once, not once a stage: the stages' warps run at once, and
// N + 1 inlined copies of a heavy collision would crowd the instruction
// cache. Threads whose cell lies outside the interior (an edge a cell
// away) run the pull and the boundary sequence at the cell's coordinates;
// the others run them at the constant coordinates (1, 1) of a 3 x 3 grid,
// where every edge test folds away and the same operations remain.
//
// Work: a segment of S rows collides sum_s (kW0 - 2s)(S + 2(N-s)) cells
// for its N kBX S cell-steps (at N = 4, kW0 = 96 and the 46.5 rows of
// 2048x512's 11 segments: 1.17 a cell and step; at N = 1 (kW0 / kBX)
// (S + 2) / S). Device memory is read once a launch for each cell of the
// segment's widened rows (kW0 (S + 2N) / (kBX S), the strip's neighbours'
// columns mostly from L2). The launcher asks for as many segments as fill
// the card once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs,
// over the strips), at least 2N rows each, rows split as evenly as they go.
//
// Rings. Stage s at batch b reads stage s-1's batches b - kReach .. b +
// kReach, while stage s-1 writes batch b + kLag: a ring of 2 kReach + 2
// batches, kLag = kReach + 1. Stage 0 collides batch m in place while the
// raw rows of batches m+1 .. m+kAhead arrive: 2 kReach + 2 + kAhead
// batches. kReach is 1, or 2
// where a corner rule reads two rows inward (below) and a batch is one row.
// Every ring is rounded up to a power of two rows, so that a ring row is a
// mask. At N=4, kW0 = 96, kR = 1 the rings take (8 + 3 x 4) x 96 x 36 B =
// 69,120 B, the solid mask's rows 1,536 B more. The shared memory grows
// linearly in N (the deep build's N=8: 124,416 B; N = 1: 8 x kW0 x 36 B);
// above 48 KB the launcher asks for it with cudaFuncSetAttribute.
//
// Stage 0 is fed kAhead batches ahead by stage N's threads, one cell each
// of their column and row: at the start of march step m each issues
// asynchronous copies (cp.async, __pipeline_memcpy_async, 4 B: a strip's
// widened row starts N columns left of an aligned column, and ragged grids
// align nothing) of its cell of batch m+kAhead's populations into stage
// 0's ring slots (the y-axis force profile's rows into theirs) and loads
// the cell's mask byte into a register; after its stage it stores the mask
// byte into the mask's ring of rows and waits for its copies of batch m+1
// (__pipeline_wait_prior(kAhead - 1)) before the step's barrier. At N >= 2
// copies two to four batches ahead timed no faster on an H100 (PERF.md
// §6): the N-step source keeps kAhead 1; at N = 1, where a march step is
// short, the wait for one batch's copies bounds it. The source of a
// row is found once a row (tpulbm::RowSource: the grid row, or a shard's
// block row with its x rings, or one of its ring rows), so no cell of the
// rings build goes through Shard::find and locate.
//
// A pull from y outside the domain (corners included) reads the frozen
// equilibrium eq_in and one from x outside reads zero at every stage; cells
// outside the domain are never computed or read. In the channel and the
// slab a strip's widened columns wrap (a cell at gx < 0 or gx >= nx holds
// cell gx mod nx, loaded from there and stepped like every other cell: the
// channel's rules do not depend on x); in the box the segment's widened
// rows wrap as well.
//
// The corners. The clean Zou-He corners' inlet rule and the cavity's
// corners read sources two rows (and, in the cavity, two columns) inward:
// a corner recomputes the pull of its inward neighbour. A stage's ring
// then holds those rows where a corner is computed (kReach above), and
// each stage's rows and columns reach one further than the next stage's,
// so they hold every source wherever a stage computes a corner, except
// when the corner is the first row (column) of a segment (strip) of one
// row (column) at the domain's edge. Segments where a corner rule acts
// therefore keep at least 2 rows, and in the cavity the strips start one
// column left of x = 0 where the last would hold one column
// (tpulbm::tile_col_shift). Any strip and segment give the same bits.
//
// The Bouzidi obstacle (-DTPULBM_BOUZIDI=1): at every stage a cell whose
// mask byte carries kLinkBit rewrites its cut links after its edge rules
// (apply_bouzidi), from its entries of the link table, read from device
// memory at the cell's global index (a shard: its padded block's), and from
// its own post-collision values of that substep, which lie in the previous
// stage's ring and stay there until that row's slot is reused kLag steps
// later. The widened cells rewrite theirs too, as on one device, so one
// launch keeps the bits of N one-step launches. tpulbm's q ring and q halo
// rows have no counterpart. With TPULBM_LINK_AHEAD a stage thread loads its
// next cell's entries into registers at the end of a march step, so that
// the loads overlap the barrier instead of holding the next step (the
// N-step source leaves it off).
//
// The force profile (-DTPULBM_FORCE=1): along x the block stages the
// entries of its widened columns once, after the rings in shared memory;
// along y each row's entries arrive with its populations into a ring of
// rows beside the mask's; each at the coordinate of the cell that owns it
// (tpulbm::ForceTable), and every collision of every stage adds them, so
// one launch keeps the bits of N one-step launches.
//
// Bits. Collision, pull and boundary code come from d2q9_common.cuh and
// the libraries are built with -fmad=false: one launch at depth N gives
// the same bits as N launches at depth 1.
//
// Built with -DTPULBM_RINGS=1 the kernel steps one shard of a mesh from
// its block and the rings its neighbours sent, N cells deep
// (tpulbm::Shard), into a range of the block's rows. The segments cover
// the launch's rows [r0, r1), the strips the block's columns; cells keep
// global coordinates and a row's populations come from the block or a
// ring (Shard::row, column, row_source); a cell the launch does not hold
// (outside the domain or beyond the rings) is never stepped, so the bits
// are the one-device build's. A ranged launch whose rows keep N + 1 rows
// clear of an edge of the block reads no ring row there (the overlap
// mode's interior launch passes none). The rings add 2 N (nxl + 2 hx + hx
// nyl) x 36 B a launch to the 73/N B a cell and step.
//
// Knobs, which the including source gives defaults (utils/tile_sweep.py
// builds it with other values): TPULBM_WIDTH (kW0), TPULBM_ROWS (kR),
// TPULBM_SEGMENT (rows a segment, 0: the launcher's choice),
// TPULBM_MIN_BLOCKS (blocks an SM asked of ptxas, 0: none),
// TPULBM_AHEAD (kAhead, the batches the copies run ahead) and
// TPULBM_LINK_AHEAD (1: Bouzidi link entries loaded a march step ahead).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "d2q9_common.cuh"
#include "hopper_async.cuh"

#if !defined(TPULBM_WIDTH) || !defined(TPULBM_ROWS) || \
    !defined(TPULBM_SEGMENT) || !defined(TPULBM_MIN_BLOCKS) || \
    !defined(TPULBM_AHEAD) || !defined(TPULBM_LINK_AHEAD)
#error "the including source sets the march's knobs"
#endif

namespace {

using tpulbm::kQ;
using tpulbm::StepConsts;

constexpr int kW0 = TPULBM_WIDTH;         // stage 0's widened row
constexpr int kR = TPULBM_ROWS;           // rows of a batch
constexpr int kSegment = TPULBM_SEGMENT;  // rows of a segment, 0: chosen
constexpr int kAhead = TPULBM_AHEAD;      // batches the copies run ahead
// a Bouzidi cell's link entries loaded into registers a march step before
// the cell is stepped (else read when it is)
constexpr bool kLinkAhead = TPULBM_LINK_AHEAD != 0 && tpulbm::kBouzidi;
constexpr int kLinkFloats = kLinkAhead ? 2 * kQ : 1;
constexpr size_t kMaxBlockSmem = 232448;  // what a block may take on sm_90
static_assert(kR >= 1 && kSegment >= 0 && kAhead >= 1 && kAhead <= 8,
              "rows a batch and a segment, batches ahead");

// The least power of two >= n: ring sizes, so that a ring row is a mask.
__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// The march of depth N: its strip, rings, batches and shared memory.
template <int N, bool kCorners>
struct March {
  static_assert(N >= 1, "a march of at least one step");
  static constexpr int kN = N;
  static constexpr bool kCornerKernel = kCorners;
  // the strip's output columns: the widened row less N a side
  static constexpr int kBX = kW0 - 2 * N;
  static_assert(kBX >= 3, "a cavity strip keeps 2 columns after its shift");
  // a thread a stage, a column of the widened row and a row of the batch,
  // in whole warps
  static constexpr int kThreads = ((N + 1) * kW0 * kR + 31) / 32 * 32;
  static_assert(kThreads <= 1024, "at most 1024 threads");
  // a corner rule reads two rows inward: the clean corners, the cavity's
  static constexpr bool kCornerRows =
      kCorners || tpulbm::kDomain == tpulbm::kCavity;
  // batches a stage reads on either side of its own, and the march steps
  // between one stage and the next
  static constexpr int kReach = kCornerRows && kR == 1 ? 2 : 1;
  static constexpr int kLag = kReach + 1;
  // rows of the ring of stage 0 (the batches stage 1 reads, the one stage
  // 0 collides and the kAhead the copies bring) and of stages 1 .. N-1,
  // each kW0 wide; powers of two
  static constexpr int kRows0 =
      pow2_at_least((2 * kReach + 2 + kAhead) * kR);
  static constexpr int kRows = pow2_at_least((2 * kReach + 2) * kR);
  // rows of the mask's ring (and the y-axis force profile's): the batches
  // stage N reads at step m up to the last the copies bring
  static constexpr int kMaskRows = pow2_at_least(
      (kLag * N + kReach + 1 + kAhead) * kR);
  __host__ __device__ static constexpr int ring_rows(int s) {
    return s == 0 ? kRows0 : kRows;
  }
  // the floats before stage s's ring: [kQ][ring_rows(s)][kW0] each
  __host__ __device__ static constexpr int ring_offset(int s) {
    return s == 0 ? 0 : kQ * kW0 * (kRows0 + (s - 1) * kRows);
  }
  // after the rings: the force profile's entries (kForce) of the widened
  // columns or of the ring of rows, then the mask's ring of rows
  static constexpr int kProf =
      tpulbm::kForce ? kQ * (kW0 > kMaskRows ? kW0 : kMaskRows) : 0;
  static constexpr size_t kMaskBytes =
      tpulbm::kHasObstacle ? static_cast<size_t>(kMaskRows) * kW0 : 0;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (ring_offset(N) + kProf) + kMaskBytes;
  static_assert(kSmemBytes <= kMaxBlockSmem, "rings exceed a block's 227 KB");
};

// Where a block finds the cells it steps: on one device the grid, a cell
// outside it wrapped where an axis is periodic; in the rings build the
// shard's block and rings (tpulbm::Shard). A row index and a column index
// name a cell: one device, the wrapped global row and column; the rings
// build, the block row and column.
struct Cells {
  const float* f;
  const uint8_t* solid;
  int nx, ny;
  tpulbm::Shard sh;

  // Whether the block steps the cells of row gy (global, unwrapped); if so
  // `row` is its index.
  __device__ __forceinline__ bool row(int gy, int& row) const {
    if constexpr (tpulbm::kRings) {
      return sh.row(gy, ny, row);
    } else {
      if constexpr (tpulbm::kPeriodicY) {
        gy %= ny;
        if (gy < 0) gy += ny;
      }
      row = gy;
      return tpulbm::kPeriodicY || (gy >= 0 && gy < ny);
    }
  }
  // Whether it steps column gx of such a row; if so `col` is its index.
  __device__ __forceinline__ bool column(int gx, int& col) const {
    if constexpr (tpulbm::kRings) {
      return sh.column(gx, nx, col);
    } else {
      if constexpr (tpulbm::kPeriodicX) {
        gx %= nx;
        if (gx < 0) gx += nx;
      }
      col = gx;
      return tpulbm::kPeriodicX || (gx >= 0 && gx < nx);
    }
  }
  __device__ __forceinline__ tpulbm::RowSource source(int row) const {
    if constexpr (tpulbm::kRings) {
      return sh.row_source(row);
    } else {
      return {f + static_cast<size_t>(row) * nx, nullptr, nullptr,
              static_cast<size_t>(nx) * ny, 0, 0};
    }
  }
  // the cell's mask byte (the obstacle domain and the slab)
  __device__ __forceinline__ uint8_t mask_byte(int row, int col) const {
    if constexpr (tpulbm::kRings) {
      return sh.mask_byte(col, row);
    } else {
      return solid[static_cast<size_t>(row) * nx + col];
    }
  }
  // the cell's entry in the link table's plane 0 (kBouzidi)
  __device__ __forceinline__ size_t link_index(int row, int col) const {
    if constexpr (tpulbm::kRings) {
      return sh.padded(col, row);
    } else {
      return static_cast<size_t>(row) * nx + col;
    }
  }
};

// What a thread keeps through the march: the block's places, its stage s
// and its own column c of the widened row (global gx; col its index where
// the block steps it) and row j of a batch.
template <int N, bool kCorners>
struct Thread {
  using M = March<N, kCorners>;
  Cells cells;
  float* rings;    // the stages' rings, one after another
  float* prof;     // the force profile's entries (kForce)
  uint8_t* mask;   // the mask's ring of rows [kMaskRows][kW0]
  int y0, y1;      // the segment's output rows [y0, y1), global
  int qbase;       // y0 - N: batch 0's first row
  int axis;        // the force profile's axis (kForce)
  int s, c, j, gx, col;
  bool held;       // the block steps this column
  bool out;        // it is one of the strip's output columns
  bool inner;      // no rule reads its x (an x edge is a column away)

  // ring row of row q in a ring of `rows` rows, a power of two
  __device__ __forceinline__ int ring_row(int q, int rows) const {
    return (q - qbase) & (rows - 1);
  }
  // row q of batch b
  __device__ __forceinline__ int row_of(int b) const {
    return qbase + b * kR + j;
  }
  // the force profile's entry of population 0 at this column and row q,
  // and the floats between populations
  __device__ __forceinline__ const float* prof_at(int q) const {
    return axis == 0 ? prof + c : prof + ring_row(q, M::kMaskRows);
  }
  __device__ __forceinline__ int prof_stride() const {
    return axis == 0 ? kW0 : M::kMaskRows;
  }
  __device__ __forceinline__ uint8_t* mask_row(int q) const {
    return mask + ring_row(q, M::kMaskRows) * kW0;
  }
};

// The copies of batch b into stage 0's ring (and the y-axis force
// profile's rows into theirs): one cp.async of 4 B a population, one group
// a thread, and the cell's mask byte into `pending`; stage 0 collides the
// cell in place at the march step after.
template <int N, bool kCorners>
__device__ __forceinline__ void prefetch(const Thread<N, kCorners>& th,
                                         const tpulbm::ForceTable& force,
                                         uint8_t& pending, int b) {
  using M = March<N, kCorners>;
  const int q = th.row_of(b);
  int row;
  if (th.held && q < th.y1 + N && th.cells.row(q, row)) {
    size_t stride;
    const float* src = th.cells.source(row).at(th.col, stride);
    float* dst = th.rings + th.ring_row(q, M::kRows0) * kW0 + th.c;
#pragma unroll
    for (int i = 0; i < kQ; ++i)
      __pipeline_memcpy_async(dst + i * M::kRows0 * kW0, src + i * stride,
                              sizeof(float));
    if constexpr (tpulbm::kHasObstacle)
      pending = th.cells.mask_byte(row, th.col);
  }
  if constexpr (tpulbm::kForce) {
    // the batch's kQ kR entries, from as many of the stage's kW0 kR
    // threads (a narrow widened row takes more than one each)
    for (int t = th.j * kW0 + th.c; force.axis == 1 && t < kQ * kR;
         t += kW0 * kR) {
      const int i = t / kR;
      const int qi = th.qbase + b * kR + t % kR;
      int y = qi % th.cells.ny;
      if (y < 0) y += th.cells.ny;
      __pipeline_memcpy_async(th.prof + i * M::kMaskRows +
                                  th.ring_row(qi, M::kMaskRows),
                              force.table + i * th.cells.ny + y,
                              sizeof(float));
    }
  }
  __pipeline_commit();
}

// The mask byte `pending` of batch b into the mask's ring of rows.
// Under kBouzidi a cell of batch b with a cut link also asks for its
// entries of the link table in L1 (prefetch.global.L1), kLag or more march
// steps before a stage reads them: a warp that waited on device memory
// there would hold its block's barrier.
template <int N, bool kCorners>
__device__ __forceinline__ void keep_mask(const Thread<N, kCorners>& th,
                                          const tpulbm::Links& links,
                                          uint8_t pending, int b) {
  if constexpr (tpulbm::kHasObstacle) {
    const int q = th.row_of(b);
    int row;
    if (th.held && q < th.y1 + N) {
      th.mask_row(q)[th.c] = pending;
      if (tpulbm::kBouzidi && (pending & tpulbm::kLinkBit) &&
          th.cells.row(q, row)) {
        const float* at = links.q + th.cells.link_index(row, th.col);
        const int planes = links.moving ? 2 * kQ : kQ;
        for (int j = 1; j < planes; ++j)
          tpulbm_async::prefetch_l1(at + j * links.plane);
      }
    }
  }
}

// The thread's cell at march step m: stage s = th.s works on batch
// m - kLag s. Stage 0 takes the raw populations the copies brought into
// its ring; stage s > 0 pulls them from stage s-1's ring and runs the
// boundary sequence (a cell whose rules read neither its x nor its y,
// no edge a cell away, runs the same pull and boundary sequence at the
// constant coordinates (1, 1) of a 3 x 3 grid, where they fold to the
// operations they do there). Stage s < N collides the cell into its ring
// (stage 0 in place), stage N stores it to `out`. One code path serves
// every stage, the stage a run-time value: the collision is compiled
// once, not once a stage.
template <int N, bool kCorners>
__device__ __forceinline__ void step_cell(const Thread<N, kCorners>& th,
                                          float* __restrict__ out,
                                          const StepConsts& k,
                                          const tpulbm::Links& links, int m,
                                          const float (&lq)[kLinkFloats]) {
  using M = March<N, kCorners>;
  const int s = th.s;
  const int q = th.row_of(m - M::kLag * s);
  const int d = s == N ? 0 : N - s;  // the stage's rows beyond the segment
  int row;
  if (!th.held || (s == N ? !th.out : (th.c < s || th.c >= kW0 - s)) ||
      q < th.y0 - d || q >= th.y1 + d || !th.cells.row(q, row))
    return;
  const uint8_t mb = tpulbm::kHasObstacle ? th.mask_row(q)[th.c] : 0;
  const bool is_solid = tpulbm::is_solid(mb);
  const int nx = th.cells.nx, ny = th.cells.ny;
  float g[kQ];
  if (s == 0) {
    const float* at = th.rings + th.ring_row(q, M::kRows0) * kW0 + th.c;
#pragma unroll
    for (int i = 0; i < kQ; ++i) g[i] = at[i * M::kRows0 * kW0];
  } else {
    const int zp = s == 1 ? M::kRows0 : M::kRows;  // stage s-1's ring rows
    const float* src = th.rings + M::ring_offset(s - 1) + th.c;
    const int rm = th.ring_row(q - 1, zp) * kW0;
    const int r0 = th.ring_row(q, zp) * kW0;
    const int rp = th.ring_row(q + 1, zp) * kW0;
    auto post_at = [&](int i, int dx, int dy) {
      const int r = dy == 0    ? r0
                    : dy == -1 ? rm
                    : dy == 1  ? rp
                               : th.ring_row(q + dy, zp) * kW0;
      return src[i * zp * kW0 + r + dx];
    };
    auto solid_at = [&](int dx, int dy) {
      if constexpr (tpulbm::kHasObstacle) {
        return tpulbm::is_solid(th.mask_row(q + dy)[th.c + dx]);
      } else {
        return false;
      }
    };
    // a link cell's entries from the table, or (kLinkAhead) from the
    // registers lq, where the cut-link rewrite follows the boundary
    // sequence as apply_boundaries would end it
    const float* link = tpulbm::kBouzidi && !kLinkAhead &&
                                (mb & tpulbm::kLinkBit)
                            ? links.q + th.cells.link_index(row, th.col)
                            : nullptr;
    if (th.inner && (tpulbm::kPeriodicY || (q >= 1 && q < ny - 1))) {
      tpulbm::pull_d2q9(g, 1, 1, 3, 3, k, post_at);
      tpulbm::apply_boundaries<kCorners>(g, is_solid, 1, 1, 3, 3, k, post_at,
                                         solid_at, link, links);
    } else {
      tpulbm::pull_d2q9(g, th.gx, q, nx, ny, k, post_at);
      tpulbm::apply_boundaries<kCorners>(g, is_solid, th.gx, q, nx, ny, k,
                                         post_at, solid_at, link, links);
    }
    if constexpr (kLinkAhead) {
      if (!is_solid && (mb & tpulbm::kLinkBit))
        tpulbm::apply_bouzidi_at(
            g, [&](int j) { return lq[j]; }, links.moving != 0, post_at);
    }
  }
  if (s < N) {
    tpulbm::collide_cell(g, k, tpulbm::kBounceBack && is_solid,
                         th.prof_at(q), th.prof_stride());
    const int z = s == 0 ? M::kRows0 : M::kRows;
    float* dst = th.rings + M::ring_offset(s) + th.ring_row(q, z) * kW0 +
                 th.c;
#pragma unroll
    for (int i = 0; i < kQ; ++i) dst[i * z * kW0] = g[i];
  } else if constexpr (tpulbm::kRings) {
    const tpulbm::Shard& sh = th.cells.sh;
    const size_t block = static_cast<size_t>(sh.nxl) * sh.nyl;
    const size_t cell = static_cast<size_t>(row) * sh.nxl + th.col;
#pragma unroll
    for (int i = 0; i < kQ; ++i) out[i * block + cell] = g[i];
  } else {
    const size_t plane = static_cast<size_t>(nx) * ny;
    const size_t cell = static_cast<size_t>(row) * nx + th.col;
#pragma unroll
    for (int i = 0; i < kQ; ++i) out[i * plane + cell] = g[i];
  }
}

// kLinkAhead: the link entries of the cell a stage thread steps at march
// step m (batch m - kLag s) into its registers lq (plane 1: q_j at lq[j],
// a moving wall's scalars at lq[kQ + j]), loaded at the end of step m - 1,
// so that the loads overlap the step's barrier; the cell's mask byte was
// stored to the mask's ring two or more steps before.
template <int N, bool kCorners>
__device__ __forceinline__ void fetch_links(const Thread<N, kCorners>& th,
                                            const tpulbm::Links& links,
                                            float (&lq)[kLinkFloats], int m) {
  using M = March<N, kCorners>;
  const int s = th.s;
  const int q = th.row_of(m - M::kLag * s);
  const int d = s == N ? 0 : N - s;
  int row;
  if (s < 1 || s > N || !th.held ||
      (s == N ? !th.out : (th.c < s || th.c >= kW0 - s)) ||
      q < th.y0 - d || q >= th.y1 + d || !th.cells.row(q, row) ||
      !(th.mask_row(q)[th.c] & tpulbm::kLinkBit))
    return;
  const float* at = links.q + th.cells.link_index(row, th.col);
#pragma unroll
  for (int j = 1; j < kQ; ++j) lq[j] = at[j * links.plane];
  if (links.moving) {
#pragma unroll
    for (int j = 1; j < kQ; ++j) lq[kQ + j] = at[(kQ + j) * links.plane];
  }
}

template <int N, bool kCorners>
__global__ void
#if TPULBM_MIN_BLOCKS
__launch_bounds__(March<N, kCorners>::kThreads, TPULBM_MIN_BLOCKS)
#else
__launch_bounds__(March<N, kCorners>::kThreads)
#endif
    d2q9_march_kernel(const float* __restrict__ f, float* __restrict__ out,
                        const uint8_t* __restrict__ solid, int nx, int ny,
                        int x_shift, int rows_lo, int rows, int segments,
                        StepConsts k, tpulbm::Shard sh,
                        tpulbm::ForceTable force, tpulbm::Links links) {
  using M = March<N, kCorners>;
  extern __shared__ float smem[];
  Thread<N, kCorners> th;
  th.cells = Cells{f, solid, nx, ny, sh};
  th.rings = smem;
  th.prof = smem + M::ring_offset(N);
  th.mask = reinterpret_cast<uint8_t*>(th.prof + M::kProf);
  th.axis = force.axis;
  // the strip: kBX columns from the block's (the shard's) first, shifted;
  // this thread's column of its widened row
  const int gx_lo = tpulbm::kRings ? sh.x0 : 0;
  const int gx_hi = tpulbm::kRings ? sh.x0 + sh.nxl : nx;
  const int x0 = gx_lo + static_cast<int>(blockIdx.x) * M::kBX - x_shift;
  const int t = static_cast<int>(threadIdx.x);
  th.s = t / (kW0 * kR);
  th.j = t / kW0 % kR;
  th.c = t % kW0;
  th.gx = x0 - N + th.c;
  th.held = th.s <= N && th.cells.column(th.gx, th.col);
  th.out = th.c >= N && th.c < kW0 - N && th.gx >= gx_lo && th.gx < gx_hi;
  th.inner = tpulbm::kPeriodicX || (th.gx >= 1 && th.gx < nx - 1);
  // the segment: its share of the rows [rows_lo, rows_lo + rows)
  const int ylo = (tpulbm::kRings ? sh.y0 : 0) + rows_lo;
  const int seg = static_cast<int>(blockIdx.y);
  th.y0 = ylo + static_cast<int>(static_cast<long long>(seg) * rows /
                                 segments);
  th.y1 = ylo + static_cast<int>(static_cast<long long>(seg + 1) * rows /
                                 segments);
  th.qbase = th.y0 - N;
  if constexpr (tpulbm::kForce) {
    if (force.axis == 0)
      force.stage(th.prof, kW0, x0 - N, nx, threadIdx.x, M::kThreads);
  }
  // batches: stage 0 loads 0 .. last0, stage N stores its last at step
  // steps - 1
  const int last0 = (th.y1 + N - 1 - th.qbase) / kR;
  const int steps = (th.y1 - 1 - th.qbase) / kR + M::kLag * N + 1;
  // stage N's threads feed stage 0 kAhead batches ahead, the cells of
  // their columns and rows: at step m the copies of batch m + kAhead
  // leave, their mask bytes into `pending`, and the copies of batch m + 1
  // are waited for after the stages
  const bool feeds = th.s == N;
  uint8_t pending = 0;
  float lq[kLinkFloats];
  if (feeds) {
    for (int b = 0; b < kAhead; ++b) {
      prefetch(th, force, pending, b);
      keep_mask(th, links, pending, b);
    }
    __pipeline_wait_prior(kAhead - 1);
  }
  __syncthreads();
  for (int m = 0; m < steps; ++m) {
    if (feeds) prefetch(th, force, pending, m + kAhead);
    if (th.s <= N) step_cell(th, out, k, links, m, lq);
    if (feeds) {
      keep_mask(th, links, pending, m + kAhead);
      __pipeline_wait_prior(kAhead - 1);
    }
    if constexpr (kLinkAhead) fetch_links(th, links, lq, m + 1);
    __syncthreads();
  }
}

// The blocks of the march of depth N the card holds at once (its SMs
// times the blocks one SM holds), after the kernel's shared-memory
// attribute is set: both once per device.
template <int N, bool kCorners>
cudaError_t prepare(int device, int& resident) {
  static int cache[64];
  const bool cached = device >= 0 && device < 64;
  if (cached && cache[device] > 0) {
    resident = cache[device];
    return cudaSuccess;
  }
  constexpr size_t smem = March<N, kCorners>::kSmemBytes;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        d2q9_march_kernel<N, kCorners>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, d2q9_march_kernel<N, kCorners>,
          March<N, kCorners>::kThreads, smem) != cudaSuccess ||
      sms * per <= 0) {
    resident = 1;
    return cudaSuccess;
  }
  resident = sms * per;
  if (cached) cache[device] = resident;
  return cudaSuccess;
}

// The segments of `rows` rows for `strips` strips: -DTPULBM_SEGMENT's
// length, else as many as fill the card's resident blocks once, each of at
// least 2N rows; rows split evenly, at least 2 a segment where a corner
// rule acts.
int segments_for(int rows, int strips, int resident, int n, bool corners) {
  int k;
  if (kSegment > 0) {
    k = (rows + kSegment - 1) / kSegment;
  } else {
    k = resident / strips;
    const int most = rows / (2 * n);
    if (k > most) k = most;
  }
  if (corners && k > rows / 2) k = rows / 2;
  return k > 1 ? k : 1;
}

// The strips of a launch over `cols` columns (shifted one column left in
// the cavity where the last would hold one, tpulbm::tile_col_shift).
template <int N, bool kCorners>
int strips_for(int cols, int& x_shift) {
  constexpr int kBX = March<N, kCorners>::kBX;
  x_shift = tpulbm::tile_col_shift(cols, kBX);
  return (cols + x_shift + kBX - 1) / kBX;
}

template <int N, bool kCorners>
cudaError_t launch(const float* f, float* out, const uint8_t* solid, int nx,
                   int ny, int cols, int rows_lo, int rows,
                   const StepConsts& k, const tpulbm::Shard& sh,
                   const tpulbm::ForceTable& force,
                   const tpulbm::Links& links, int device,
                   cudaStream_t stream) {
  using M = March<N, kCorners>;
  int resident, x_shift;
  const cudaError_t err = prepare<N, kCorners>(device, resident);
  if (err != cudaSuccess) return err;
  const int strips = strips_for<N, kCorners>(cols, x_shift);
  const int segments =
      segments_for(rows, strips, resident, N, M::kCornerRows);
  const dim3 grid(strips, segments);
  constexpr size_t smem = M::kSmemBytes;
  constexpr int threads = M::kThreads;
  d2q9_march_kernel<N, kCorners><<<grid, threads, smem, stream>>>(
      f, out, solid, nx, ny, x_shift, rows_lo, rows, segments, k, sh, force,
      links);
  return cudaGetLastError();
}

// N steps at depth N with the clean corners (corners) or without: the
// kernels of the other domains ignore the corner rule, so they are built
// without it whatever the caller says (tpulbm::kCornerRule).
template <int N>
cudaError_t launch_depth(const float* f, float* out, const uint8_t* solid,
                         int nx, int ny, int cols, int rows_lo, int rows,
                         bool corners, const StepConsts& k,
                         const tpulbm::Shard& sh,
                         const tpulbm::ForceTable& force,
                         const tpulbm::Links& links, int device,
                         cudaStream_t stream) {
  return corners && tpulbm::kCornerRule
             ? launch<N, tpulbm::kCornerRule>(f, out, solid, nx, ny, cols,
                                              rows_lo, rows, k, sh, force,
                                              links, device, stream)
             : launch<N, false>(f, out, solid, nx, ny, cols, rows_lo, rows,
                                k, sh, force, links, device, stream);
}

// A query of the march of depth N with the clean corners (corners) or
// without: q(March<N, kCorners>{}).
template <int N, class Q>
int query(bool corners, Q q) {
  return corners && tpulbm::kCornerRule ? q(March<N, tpulbm::kCornerRule>{})
                                        : q(March<N, false>{});
}

// The queries a library of the march answers for depth N: the dynamic
// shared memory of a block, in bytes; the threads of a block; and the
// strips x segments of a launch over cols x rows cells on `device`
// (strips * 65536 + segments, -1 if the card cannot be asked).
template <int N>
int smem_bytes(bool corners) {
  return query<N>(corners, [](auto m) {
    return static_cast<int>(decltype(m)::kSmemBytes);
  });
}
template <int N>
int threads() {
  return March<N, false>::kThreads;
}
template <int N>
int grid(int cols, int rows, bool corners, int device) {
  return query<N>(corners, [&](auto m) {
    using M = decltype(m);
    int resident, x_shift;
    if (prepare<M::kN, M::kCornerKernel>(device, resident) != cudaSuccess)
      return -1;
    const int strips = strips_for<M::kN, M::kCornerKernel>(cols, x_shift);
    return strips * 65536 +
           segments_for(rows, strips, resident, M::kN, M::kCornerRows);
  });
}

}  // namespace
