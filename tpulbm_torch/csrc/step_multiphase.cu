// One fused Shan-Chen multiphase timestep on an NVIDIA Hopper GPU (sm_90a),
// float32, D2Q9: ψ(ρ) of the pre-collision density -> interaction force
// F = -g ψ Σ_{i>0} w_i ψ(x + c_i) c_i -> velocity-shift BGK toward
// equilibrium(ρ, m/ρ + τ F/ρ) -> pull-stream -> exact-mass y walls. The
// channel is periodic in x; a ψ pull beyond a y wall reads the phantom wall
// fluid's ψ.
//
// Replaces tpulbm/ops/step_multiphase_pallas.py::make_local_step_multiphase_pallas
// (:121, the fused 1-step Shan-Chen Pallas TPU kernel) on one full-width
// device and, built with -DTPULBM_RINGS=1, on a shard of a mesh with its
// depth-2 ring rows and its x_halo columns (below). Both compute one step of
// tpulbm/ops/step_multiphase.py::make_step_multiphase; so does this kernel,
// cell by cell. Its plain version is tpulbm_torch/ops/step_multiphase.py.
//
// Layout: the state is SoA (9, ny, nx) float32 with x fastest. Any nx and
// ny run: x coordinates wrap, so grids narrower than a block's row (7x3)
// work too. The Pallas kernel's nx % 128 rule is a TPU layout rule.
//
// What bounds it: device-memory traffic. A step reads and writes the 9
// populations of every cell once, 72 B per cell, no mask, against about 150
// floating-point operations per cell (one expf). At 2048x512 that is 75.5 MB
// a step, 0.02254 ms at 3.35 TB/s. Unlike every other model the collision is
// not pointwise: a cell's force needs ψ of its 8 neighbours, and the pull
// needs the post-collision values of a 1-cell ring, so an output cell needs
// ψ on a 2-cell ring.
//
// Design: a row march, the D2Q9 kernels' design (d2q9_march.cuh) with the
// Shan-Chen step's own stages. A block owns a strip of kW - 4 output
// columns; its widened row is the strip and 2 columns a side (ψ's stencil
// reaches one column and the pull another). It marches up a segment
// [y0, y1) of rows kR rows (a batch) a march step, in three stages of
// kW kR threads each (one a column and row of the batch, whole warps where
// kW is a multiple of 32):
//   stage 0, at batch m: issues the asynchronous copies (cp.async,
//     __pipeline_memcpy_async, 4 B: the widened row starts 2 columns left
//     of an aligned one) of batch m+kAhead's raw populations into the ring
//     of rows in shared memory, and puts ψ of batch m (its copies waited
//     for a step earlier) into the ψ ring; rows outside the domain hold
//     the wall's ψ and their populations are never read;
//   stage 1, at batch m - 2: collides its cells in place, reading ψ of the
//     batches on either side (written two and one steps earlier);
//   stage 2, at batch m - 4: pulls the strip's cells from the
//     post-collision rows on either side, applies the walls and stores them.
// Each stage reads only rows written at an earlier march step, so one
// barrier ends the step (stage 0 waits for its copies of batch m+1 before
// it: with one batch in flight that wait, not the work, bounds a step).
// The population ring holds batches m-5 .. m+kAhead and the ψ ring m-3 ..
// m, each rounded up to a power of two rows: at kW = 64, kR = 2, kAhead 2,
// 16 + 8 rows, 38,912 B a block. Against the 32x8 tiles this replaced
// (36x12 cells loaded and 34x10 collided for 32x8 outputs: 1.69 and 1.33 a
// cell), a segment of S rows loads (kW / (kW - 4)) (S + 4) / S cells a cell and
// collides (kW - 2) (S + 2) / ((kW - 4) S); the launcher sizes the segments
// so that the card fills once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// x the SMs, over the strips), at least 4 rows each. On a shard of 128-256
// rows the segments are short and the march is slower than the tiles were
// (PERF.md §6).
//
// The wall ψ: tpulbm has two forms. The plain step (the oracle) substitutes
// ψ of a float64 ρ = init_rho, rounded to float32 where it enters; the
// Pallas kernel computes ψ of the float32 equilibrium ring rows in the
// kernel. This kernel takes the oracle's form: the host computes ψ in
// float64 once and rounds it to float32 (ops/step_multiphase_cuda.py), and
// every ring row outside the domain holds it.
//
// Walls: at y = 0 the populations with c_y > 0, and at y = ny-1 those with
// c_y < 0, take the node's own post-collision opposite (full-way
// bounce-back, so total mass is exact); the pulls they replace are never
// read.
//
// Rounding follows the plain version: directions are summed in tpulbm's i
// order, the force components accumulate per direction as
// shan_chen_force does, u = m/ρ + (τF)/ρ with true divisions, ψ uses expf
// (never __expf, and no fast math), and the library is built with
// -fmad=false so no multiply and add share one rounding. expf and PyTorch's
// exp may differ by an ulp, so a kernel step agrees with the plain step to
// the port's one-step tolerance, rtol 5e-6 / atol 1e-7, not bitwise. Every
// cell's arithmetic is the 32x8-tile kernel's this design replaced, so the
// two give the same bits.
//
// Built with -DTPULBM_RINGS=1 the kernel steps one shard of a mesh
// (tpulbm_multiphase_step_rings): the shard's block and the pre-collision
// rings its neighbours sent, two cells deep (tpulbm::Shard, depth 2): rb
// and rt the rows below and above, rl and rr the columns beside it where
// the mesh cuts x (tpulbm's x_halo mode, :135-145: ψ's stencil consumes
// one ring column and the pull the other). Cells keep global coordinates:
// a row's populations come from the block or the ring that holds it, found
// once a row (Shard::row, row_source; where the block spans every column,
// x wraps inside it), rows beyond a y wall hold the wall's ψ, and the
// walls act at the global rows y = 0 and ny-1 only. So a shard's cells get
// the bits of the one-device build. The rings add 2 (2 (nxl + 2 hx) + hx
// nyl) x 36 B a launch to the 72 B a cell.
//
// Knobs (utils/tile_sweep.py --multiphase builds the source with other
// values): -DTPULBM_WIDTH (kW), -DTPULBM_ROWS (kR), -DTPULBM_SEGMENT (rows a
// segment, 0: the launcher's choice), -DTPULBM_MIN_BLOCKS (blocks an SM
// asked of ptxas, 0: none) and -DTPULBM_AHEAD (kAhead); the libraries the
// port loads use the defaults below.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "d2q9_common.cuh"

// a 64-column widened row and 2-row batches: as fast as 128 and 1 on
// one device at 2048x512 and 7-8% faster on its 4x1 and 2x2 shards on an
// H100 (PERF.md §6)
#ifndef TPULBM_WIDTH
#define TPULBM_WIDTH 64
#endif
#ifndef TPULBM_ROWS
#define TPULBM_ROWS 2
#endif
#ifndef TPULBM_SEGMENT
#define TPULBM_SEGMENT 0
#endif
// ptxas is asked for three blocks an SM: with up to 56 registers a thread
// (40 unasked) it ran faster than four blocks' shorter segments on an H100
// (PERF.md §6)
#ifndef TPULBM_MIN_BLOCKS
#define TPULBM_MIN_BLOCKS 3
#endif
#ifndef TPULBM_AHEAD
#define TPULBM_AHEAD 2
#endif

// The 9 D2Q9 directions: X(i, cx, cy, opposite), tpulbm.lattice.D2Q9's
// order. tests/test_torch_multiphase.py parses this table and compares it
// with the lattice.
#define TPULBM_MP_DIRS(X) \
  X(0, 0, 0, 0)           \
  X(1, 1, 0, 3)           \
  X(2, 0, 1, 4)           \
  X(3, -1, 0, 1)          \
  X(4, 0, -1, 2)          \
  X(5, 1, 1, 7)           \
  X(6, -1, 1, 8)          \
  X(7, -1, -1, 5)         \
  X(8, 1, -1, 6)

namespace {

constexpr int kQ = tpulbm::kQ;
constexpr int kRing = 2;                  // ψ's stencil a cell, the pull one
constexpr int kW = TPULBM_WIDTH;          // the widened row
constexpr int kR = TPULBM_ROWS;           // rows of a batch
constexpr int kSegment = TPULBM_SEGMENT;  // rows of a segment, 0: chosen
constexpr int kAhead = TPULBM_AHEAD;      // batches the copies run ahead
constexpr int kBX = kW - 2 * kRing;       // the strip's output columns
constexpr int kLag = 2;                   // batches between two stages
constexpr int kStages = 3;                // copies and ψ, collision, pull
constexpr int kMinRows = 2 * kRing;       // the least rows of a segment
constexpr size_t kMaxBlockSmem = 232448;  // what a block may take on sm_90
static_assert(kBX >= 1 && kR >= 1 && kSegment >= 0 && kAhead >= 1 &&
                  kAhead <= 8,
              "the march's knobs");

// The least power of two >= n: ring sizes, so that a ring row is a mask.
constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// a thread a stage, a column of the widened row and a row of the batch
constexpr int kThreads = (kStages * kW * kR + 31) / 32 * 32;
static_assert(kThreads <= 1024, "at most 1024 threads");
// the population ring: batches m-5 .. m+kAhead at march step m; the ψ
// ring: batches m-3 .. m
constexpr int kPopRows = pow2_at_least((2 * kLag + 2 + kAhead) * kR);
constexpr int kPsiRows = pow2_at_least((kLag + 2) * kR);
constexpr size_t kSmemBytes = sizeof(float) * (kQ * kPopRows + kPsiRows) * kW;
static_assert(kSmemBytes <= kMaxBlockSmem, "rings exceed a block's 227 KB");

struct MultiphaseConsts {
  float inv_tau;   // 1 / tau
  float tau;       // 1 / (1 / tau), the plain step's velocity-shift factor
  float neg_g;     // -g
  float rho0;      // ψ's saturation density
  float wall_psi;  // ψ of the phantom wall fluid
  float w[kQ];     // lattice weights
};

__host__ __device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

__device__ __forceinline__ float psi_of(float rho, const MultiphaseConsts& k) {
  return k.rho0 * (1.0f - expf(-rho / k.rho0));
}

// Where a block finds the cells it steps: on one device the grid (x
// wrapped); in the rings build the shard's block and rings (tpulbm::Shard,
// depth 2; x wraps inside a block that spans every column). A row index
// and a column index name a cell: one device, the global row and wrapped
// column; the rings build, the block row and column.
struct Cells {
  const float* f;
  int nx, ny;
  tpulbm::Shard sh;

  // Whether the launch reads the populations of row gy (global, in the
  // domain); if so `row` is its index.
  __device__ __forceinline__ bool row(int gy, int& row) const {
    if constexpr (tpulbm::kRings) {
      return sh.row(gy, ny, row);
    } else {
      row = gy;
      return gy >= 0 && gy < ny;
    }
  }
  // Whether it reads column gx of such a row; if so `col` is its index.
  __device__ __forceinline__ bool column(int gx, int& col) const {
    if constexpr (tpulbm::kRings) {
      col = gx - sh.x0;
      if (sh.hx == 0) {
        col = wrap(col, sh.nxl);
        return true;
      }
      return col >= -sh.hx && col < sh.nxl + sh.hx;
    } else {
      col = wrap(gx, nx);
      return true;
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
};

// What a thread keeps through the march: its stage s, its column c of the
// widened row (global gx; col its index where the launch reads it) and
// row j of a batch, and the block's segment.
struct Thread {
  Cells cells;
  float* pop;   // [kQ][kPopRows][kW]: raw, then post-collision in place
  float* psi;   // [kPsiRows][kW]
  int y0, y1;   // the segment's output rows [y0, y1), global
  int qbase;    // y0 - kRing: batch 0's first row
  int s, c, j, col;
  bool held;    // the launch reads this column
  bool out;     // it is one of the strip's output columns

  // row q of batch b
  __device__ __forceinline__ int row_of(int b) const {
    return qbase + b * kR + j;
  }
  // population i of this column, row q (+ dx columns)
  __device__ __forceinline__ float* pop_at(int i, int q, int dx = 0) const {
    return pop + (i * kPopRows + ((q - qbase) & (kPopRows - 1))) * kW + c +
           dx;
  }
  __device__ __forceinline__ float* psi_at(int q, int dx = 0) const {
    return psi + ((q - qbase) & (kPsiRows - 1)) * kW + c + dx;
  }
};

// Stage 0: the copies of batch b's raw populations into the ring, one
// cp.async of 4 B a population and one group a thread.
__device__ __forceinline__ void prefetch(const Thread& th, int b) {
  const int q = th.row_of(b);
  int row;
  if (th.held && q < th.y1 + kRing && th.cells.row(q, row)) {
    size_t stride;
    const float* src = th.cells.source(row).at(th.col, stride);
#pragma unroll
    for (int i = 0; i < kQ; ++i)
      __pipeline_memcpy_async(th.pop_at(i, q), src + i * stride,
                              sizeof(float));
  }
  __pipeline_commit();
}

// Stage 0: ψ of batch b, whose populations arrived a step earlier; the
// wall's ψ on a row outside the domain.
__device__ __forceinline__ void put_psi(const Thread& th,
                                        const MultiphaseConsts& k, int b) {
  const int q = th.row_of(b);
  if (q >= th.y1 + kRing) return;
  if (q < 0 || q >= th.cells.ny) {
    *th.psi_at(q) = k.wall_psi;
    return;
  }
  int row;
  if (!th.held || !th.cells.row(q, row)) return;
  float rho = 0.0f;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const float v = *th.pop_at(i, q);
    rho = i == 0 ? v : rho + v;
  }
  *th.psi_at(q) = psi_of(rho, k);
}

// Stage 1: the collision of batch b's cells in place (the strip's cells
// and a column and row a side, rows inside the domain only).
__device__ __forceinline__ void collide(const Thread& th,
                                        const MultiphaseConsts& k, int b) {
  const int q = th.row_of(b);
  int row;
  if (b < 0 || !th.held || th.c < 1 || th.c >= kW - 1 || q < th.y0 - 1 ||
      q >= th.y1 + 1 || !th.cells.row(q, row))
    return;
  float v[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) v[i] = *th.pop_at(i, q);
  float rho = v[0];
#pragma unroll
  for (int i = 1; i < kQ; ++i) rho = rho + v[i];
  const float mx = v[1] - v[3] + v[5] - v[6] - v[7] + v[8];
  const float my = v[2] - v[4] + v[5] + v[6] - v[7] - v[8];
  // Σ_i w_i c_i ψ(x + c_i), per component in tpulbm's i order; a term
  // with c = -1 is subtracted, which rounds as adding (-w_i) ψ does
  const auto nb = [&](int cx, int cy) { return *th.psi_at(q + cy, cx); };
  float sx = k.w[1] * nb(1, 0);
  sx = sx - k.w[3] * nb(-1, 0);
  sx = sx + k.w[5] * nb(1, 1);
  sx = sx - k.w[6] * nb(-1, 1);
  sx = sx - k.w[7] * nb(-1, -1);
  sx = sx + k.w[8] * nb(1, -1);
  float sy = k.w[2] * nb(0, 1);
  sy = sy - k.w[4] * nb(0, -1);
  sy = sy + k.w[5] * nb(1, 1);
  sy = sy + k.w[6] * nb(-1, 1);
  sy = sy - k.w[7] * nb(-1, -1);
  sy = sy - k.w[8] * nb(1, -1);
  const float gpsi = k.neg_g * nb(0, 0);
  const float fx = gpsi * sx;
  const float fy = gpsi * sy;
  // velocity shift: u = m/ρ + (τ F)/ρ, then BGK toward equilibrium(ρ, u)
  const tpulbm::Moments m = {rho, mx / rho + k.tau * fx / rho,
                             my / rho + k.tau * fy / rho};
  tpulbm::relax_bgk(v, m, k.inv_tau, k.w);
#pragma unroll
  for (int i = 0; i < kQ; ++i) *th.pop_at(i, q) = v[i];
}

// Stage 2: the pull of batch b's output cells, x wrapped by the widened
// row; at a wall row the inward populations take the node's own
// post-collision opposite. Stored to `out`.
__device__ __forceinline__ void pull(const Thread& th,
                                     float* __restrict__ out, int b) {
  const int q = th.row_of(b);
  int row;
  if (b < 0 || !th.held || !th.out || q < th.y0 || q >= th.y1 ||
      !th.cells.row(q, row))
    return;
  const int ny = th.cells.ny;
  float g[kQ];
#define TPULBM_PULL(i, cx, cy, o)                          \
  if (((cy) > 0 && q == 0) || ((cy) < 0 && q == ny - 1)) { \
    g[i] = *th.pop_at(o, q);                               \
  } else {                                                 \
    g[i] = *th.pop_at(i, q - (cy), -(cx));                 \
  }
  TPULBM_MP_DIRS(TPULBM_PULL)
#undef TPULBM_PULL
  size_t plane, cell;
  if constexpr (tpulbm::kRings) {
    const tpulbm::Shard& sh = th.cells.sh;
    plane = static_cast<size_t>(sh.nxl) * sh.nyl;
    cell = static_cast<size_t>(row) * sh.nxl + th.col;
  } else {
    plane = static_cast<size_t>(th.cells.nx) * ny;
    cell = static_cast<size_t>(row) * th.cells.nx + th.col;
  }
#pragma unroll
  for (int i = 0; i < kQ; ++i) out[i * plane + cell] = g[i];
}

__global__ void
#if TPULBM_MIN_BLOCKS
__launch_bounds__(kThreads, TPULBM_MIN_BLOCKS)
#else
__launch_bounds__(kThreads)
#endif
    multiphase_step_kernel(const float* __restrict__ f,
                           float* __restrict__ out, int nx, int ny, int rows,
                           int segments, MultiphaseConsts k,
                           tpulbm::Shard sh) {
  extern __shared__ float smem[];
  Thread th;
  th.cells = Cells{f, nx, ny, sh};
  th.pop = smem;
  th.psi = smem + kQ * kPopRows * kW;
  // the strip: kBX columns from the block's (the shard's) first; this
  // thread's column of its widened row
  const int gx_lo = tpulbm::kRings ? sh.x0 : 0;
  const int gx_hi = tpulbm::kRings ? sh.x0 + sh.nxl : nx;
  const int x0 = gx_lo + static_cast<int>(blockIdx.x) * kBX;
  const int t = static_cast<int>(threadIdx.x);
  th.s = t / (kW * kR);
  th.j = t / kW % kR;
  th.c = t % kW;
  const int gx = x0 - kRing + th.c;
  th.held = th.s < kStages && th.cells.column(gx, th.col);
  th.out = th.c >= kRing && th.c < kW - kRing && gx < gx_hi;
  // the segment: its share of the rows
  const int ylo = tpulbm::kRings ? sh.y0 : 0;
  const int seg = static_cast<int>(blockIdx.y);
  th.y0 = ylo + static_cast<int>(static_cast<long long>(seg) * rows /
                                 segments);
  th.y1 = ylo + static_cast<int>(static_cast<long long>(seg + 1) * rows /
                                 segments);
  th.qbase = th.y0 - kRing;
  // stage 2 stores its last batch at step steps - 1
  const int steps = (th.y1 - 1 - th.qbase) / kR + 2 * kLag + 1;
  if (th.s == 0) {
    for (int b = 0; b < kAhead; ++b) prefetch(th, b);
    __pipeline_wait_prior(kAhead - 1);
  }
  __syncthreads();
  for (int m = 0; m < steps; ++m) {
    if (th.s == 0) {
      prefetch(th, m + kAhead);
      put_psi(th, k, m);
    } else if (th.s == 1) {
      collide(th, k, m - kLag);
    } else if (th.s == 2) {
      pull(th, out, m - 2 * kLag);
    }
    if (th.s == 0) __pipeline_wait_prior(kAhead - 1);
    __syncthreads();
  }
}

// The blocks the card holds at once (its SMs times the blocks one SM
// holds), after the kernel's shared-memory attribute is set: both once per
// device.
cudaError_t prepare(int device, int& resident) {
  static int cache[64];
  const bool cached = device >= 0 && device < 64;
  if (cached && cache[device] > 0) {
    resident = cache[device];
    return cudaSuccess;
  }
  if constexpr (kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        multiphase_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, multiphase_step_kernel, kThreads, kSmemBytes) !=
          cudaSuccess ||
      sms * per <= 0) {
    resident = 1;
    return cudaSuccess;
  }
  resident = sms * per;
  if (cached) cache[device] = resident;
  return cudaSuccess;
}

// The strips and segments of a launch over cols x rows cells: segments of
// -DTPULBM_SEGMENT rows, else as many as fill the card's resident blocks
// once, each of at least kMinRows rows; rows split evenly.
dim3 grid_for(int cols, int rows, int resident) {
  const int strips = (cols + kBX - 1) / kBX;
  int k;
  if (kSegment > 0) {
    k = (rows + kSegment - 1) / kSegment;
  } else {
    k = resident / strips;
    const int most = rows / kMinRows;
    if (k > most) k = most;
  }
  return dim3(strips, k > 1 ? k : 1);
}

cudaError_t launch(const float* f, float* out, int nx, int ny, int cols,
                   int rows, const MultiphaseConsts& k,
                   const tpulbm::Shard& sh, int device,
                   cudaStream_t stream) {
  int resident;
  const cudaError_t err = prepare(device, resident);
  if (err != cudaSuccess) return err;
  const dim3 grid = grid_for(cols, rows, resident);
  multiphase_step_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      f, out, nx, ny, rows, static_cast<int>(grid.y), k, sh);
  return cudaGetLastError();
}

MultiphaseConsts make_consts(const float* scalars, const float* w) {
  MultiphaseConsts k;
  k.inv_tau = scalars[0];
  k.tau = scalars[1];
  k.neg_g = scalars[2];
  k.rho0 = scalars[3];
  k.wall_psi = scalars[4];
  for (int i = 0; i < kQ; ++i) k.w[i] = w[i];
  return k;
}

}  // namespace

// Plain C interface, loaded with ctypes
// (tpulbm_torch/ops/step_multiphase_cuda.py). Each launcher launches one
// step on `stream` and returns cudaGetLastError(): it neither
// synchronizes nor allocates. scalars = {1/tau, tau, -g, rho0, wall ψ};
// w = the 9 lattice weights.
#if !TPULBM_RINGS
// One step of the (9, ny, nx) state `f` into `out`.
extern "C" int tpulbm_multiphase_step(const float* f, float* out, int nx,
                                      int ny, const float* scalars,
                                      const float* w, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(f, out, nx, ny, nx, ny, make_consts(scalars, w),
               tpulbm::Shard{}, device, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
#else
// One step of the shard (nxl x nyl at global x0, y0 of the nx x ny grid)
// from its (9, nyl, nxl) block `f` and its pre-collision rings two cells
// deep (rb and rt (9, 2, nxl + 2 hx), rl and rr (9, nyl, hx); hx 2 where
// the mesh cuts x, 0 where the block spans every column) into `out`.
extern "C" int tpulbm_multiphase_step_rings(
    const float* f, float* out, const float* rb, const float* rt,
    const float* rl, const float* rr, int nx, int ny, int nxl, int nyl,
    int x0, int y0, int hx, const float* scalars, const float* w,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hx != 0 && hx != kRing) return cudaErrorInvalidValue;
  const tpulbm::Shard sh{f, rb, rt, rl, rr, nullptr, nxl, nyl,
                         x0, y0, hx, kRing, 0, nyl};
  err = launch(f, out, nx, ny, nxl, nyl, make_consts(scalars, w), sh, device,
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
#endif

// The launch shape: the widened row (the strip is 2 columns narrower a
// side), the rows of a batch, the threads and the dynamic shared memory of
// a block; and the strips x segments of a launch over cols x rows cells on
// `device` (strips * 65536 + segments, -1 if the card cannot be asked).
extern "C" int tpulbm_multiphase_width() { return kW; }
extern "C" int tpulbm_multiphase_rows() { return kR; }
extern "C" int tpulbm_multiphase_threads() { return kThreads; }
extern "C" int tpulbm_multiphase_smem_bytes() {
  return static_cast<int>(kSmemBytes);
}
extern "C" int tpulbm_multiphase_grid(int cols, int rows, int device) {
  int resident;
  if (prepare(device, resident) != cudaSuccess) return -1;
  const dim3 grid = grid_for(cols, rows, resident);
  return static_cast<int>(grid.x) * 65536 + static_cast<int>(grid.y);
}

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
