// N fused D2Q9 timesteps per launch (temporal blocking) on an NVIDIA Hopper
// GPU (sm_90a), float32, N = 2, 3 or 4, and in the deep build
// (-DTPULBM_DEEP=1) N = 5-8, the depths only TPULBM_SUBSTEPS asks for.
// Each substep is the 1-step kernel's
// sequence (step_d2q9.cu): collide (+ source, + force profile) ->
// pull-stream -> ghost rule -> the domain's boundary sequence (the
// cylinder's walls, Zou-He inlet and outlet, clean corners and obstacle;
// the channel's periodic x and walls, or the slab's periodic x and mask;
// the cavity's walls, lid and corners; the box's periodic x and y).
//
// Replaces tpulbm/ops/step_pallas.py::make_local_step_pallasN (the N-step
// Pallas cascade, N = 3 and 4; the deep build N = 5-8) and
// ::make_local_step_pallas2 (its 2-step form) with their src, force_fn,
// periodic_x, periodic y, walls_x, lid_u, bounce_back and bz modes and
// walls_y off with a solid mask (the slab), under each of their collisions
// and with either corner rule (one library per collision, domain, source,
// force profile and obstacle rule; d2q9_common.cuh). Its plain version is
// N applications of tpulbm_torch/ops/step_torch.py's step.
//
// What bounds it: one launch moves the 73 B per cell of one step through
// device memory (read and write 9 f32, read the 1-byte solid mask) and
// advances N steps, so device-memory traffic falls to 73/N B per cell per
// step. Against it stand shared-memory traffic and redundant halo work: a
// block loads its BX x BY output tile plus an N-cell halo and computes a
// region that shrinks by one cell a side per substep, so the first
// substep collides (BX+2N)(BY+2N)/(BX*BY) times the tile's cells: 1.88x
// for the 32x16 tile at N=4 (2.5x for 32x8, 1.69x for 64x16), 3.0x at
// N=8.
//
// Design. The block (256 threads) loads the window's populations and solid
// mask from device memory once, collides every in-domain cell, and keeps
// the post-collision values in ONE shared buffer of 9 planes x
// (BX+2N)(BY+2N) f32. Substep s (1 <= s < N) computes the cells at depth
// >= s into the window: each thread pulls its cells from the buffer into
// registers, applies the boundary sequence at the cell's global
// coordinates, and collides; after a barrier it writes them back, and a
// second barrier publishes them to the next substep. Substep N computes
// the tile alone and stores it. A pull from y outside the domain (corners
// included) reads the frozen equilibrium eq_in and one from x outside reads
// zero at every substep, exactly the 1-step kernel's rule; out-of-domain
// cells are never computed. 32x16 was the fastest tile of those timed on
// an H100 at N=3 and 4 (32x8, 64x8, 32x16, 64x16, 128x8, 64x4); its window
// takes 35,520 B of dynamic shared memory at N=4 (34,560 B of populations
// and the mask), and a larger one above 48 KB asks for it with
// cudaFuncSetAttribute. The deep build keeps the 32x16 tile: its windows
// take 40,404, 45,584, 51,060 and 56,832 B at N = 5-8 (above 48 KB from
// N=7 on), and a thread holds up to 6 cells at substep 1 (N=8). Its
// depths live in a library of their own so that the default libraries
// keep their instantiations and build times.
//
// Every boundary condition but the clean corners' inlet rule and the
// cavity's corners is cell-local, so the TPU kernel's slab ring, DMA
// semaphores, ring inputs rb/rt/mrb/mrt and slab-skip flags have no
// counterpart here. A corner recomputes the pull of its inward neighbour
// (one row inward at the inlet, diagonally inward in the cavity) from the
// buffer, so it reads sources two rows (and columns) inward. The left
// column and the bottom row sit N cells into the only window that holds
// them, and the top row and the right column at least N cells in, so
// those sources hold the previous substep's values wherever a corner is
// computed, except at substep N when a top (right) corner is the tile's
// first row (column): its sources then sit at depth N-2, one cell short.
// The tiling then starts one row lower (one column further left;
// tpulbm::tile_row_shift, tile_col_shift), which leaves every cell's bits
// as they are. Nothing in this argument depends on N beyond N < kBX, so it
// holds for the deep build's depths too.
//
// In the channel the window's x-halo wraps: a window cell at gx < 0 or
// gx >= nx holds cell gx mod nx, loaded from there and stepped like every
// other window cell (the channel's rules do not depend on x), so the
// trapezoid of valid cells is that of an interior block. In the box the
// y-halo wraps as well.
//
// The Bouzidi obstacle (-DTPULBM_BOUZIDI=1): at every substep a window
// cell whose mask byte carries kLinkBit rewrites its cut links after its
// edge rules (apply_bouzidi), from its entries of the link table, read
// from device memory at the cell's global index (a shard: its padded
// block's), and from its own post-collision values of that substep, which
// it reads from the buffer before the barrier that overwrites them. The
// window's halo cells rewrite theirs too, as on one device, so one launch
// keeps the bits of N launches of the 1-step kernel. tpulbm's q ring and
// q halo rows have no counterpart.
//
// The force profile (-DTPULBM_FORCE=1): the block stages the entries of
// its window's columns (a force along x) or rows (along y) once, after the
// populations in shared memory, each at the coordinate of the cell that
// owns it (tpulbm::ForceTable), and every collision of every substep adds
// them: a window cell adds what the cell it holds adds on one device, so
// one launch keeps the bits of N 1-step launches.
//
// Bits. Collision, pull and boundary code come from d2q9_common.cuh, shared
// with step_d2q9.cu, and both libraries are built with -fmad=false: one
// launch gives the same bits as N launches of the 1-step kernel.
//
// Built with -DTPULBM_RINGS=1 the kernel steps one shard of a mesh
// (tpulbm_d2q9_step_blocked_rings) from its block and the rings its
// neighbours sent, N cells deep (tpulbm::Shard), into a range of the
// block's rows: it replaces make_local_step_pallasN (ranged=True too) and
// make_local_step_pallas2 with their ring inputs, and make_local_step_tiled
// at N = 2-4 (the x rings, the extended ring rows carrying the diagonal
// neighbours' corners). The window keeps global coordinates and loads a
// cell outside the block from its ring; a window cell the launch does not
// hold (outside the domain or beyond the rings) is marked kNotHeld in the
// mask and never stepped, so the trapezoid and the bits are the
// one-device build's. The rings add 2 N (nxl + 2 hx + hx nyl) x 36 B a
// launch to the 73/N B a cell and step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d2q9_common.cuh"

namespace {

using tpulbm::kQ;
using tpulbm::StepConsts;

constexpr int kThreads = 256;
constexpr int kBX = 32;  // output tile of one block (cells along x)
constexpr int kBY = 16;  // and rows

// The window a block holds: its tile plus an N-cell halo on every side.
template <int N>
struct Window {
  static constexpr int kTX = kBX + 2 * N;
  static constexpr int kTY = kBY + 2 * N;
  static constexpr int kCells = kTX * kTY;
  // the force profile's entries (kForce): one per window column or row
  static constexpr int kProf = tpulbm::kForce ? kQ * (kTX > kTY ? kTX : kTY)
                                              : 0;
  // 9 post-collision planes, the force profile's entries, then the solid
  // mask (one byte per cell)
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kQ * kCells + kProf) + kCells;
  // cells of the largest region a thread holds in registers (substep 1)
  static constexpr int kPerThread =
      ((kTX - 2) * (kTY - 2) + kThreads - 1) / kThreads;
};

// The mask byte of a window cell the rings builds do not hold (find():
// outside the domain or beyond the rings); a held cell's byte is its solid
// flag, 0 or 1.
constexpr uint8_t kNotHeld = 2;

// Whether the window cell at global (gx, gy) is stepped: a cell of the
// domain, or in the channel any cell of a domain row, gx then taken mod nx
// (the cell it holds), or in the box any cell, gx and gy taken mod nx and
// ny.
__device__ __forceinline__ bool window_cell(int& gx, int& gy, int nx,
                                            int ny) {
  if constexpr (tpulbm::kPeriodicY) {
    gx %= nx;
    if (gx < 0) gx += nx;
    gy %= ny;
    if (gy < 0) gy += ny;
    return true;
  } else if constexpr (tpulbm::kPeriodicX) {
    gx %= nx;
    if (gx < 0) gx += nx;
    return gy >= 0 && gy < ny;
  } else {
    return !(gx < 0 || gx >= nx || gy < 0 || gy >= ny);
  }
}

template <int N, bool kCorners>
__global__ void __launch_bounds__(kThreads)
    d2q9_blocked_kernel(const float* __restrict__ f, float* __restrict__ out,
                        const uint8_t* __restrict__ solid, int nx, int ny,
                        int x_shift, int y_shift, StepConsts k,
                        tpulbm::Shard sh, tpulbm::ForceTable force,
                        tpulbm::Links links) {
  using W = Window<N>;
  constexpr int TX = W::kTX;
  constexpr int TY = W::kTY;
  extern __shared__ float smem[];
  float* post = smem;  // [kQ][TY][TX]
  float* prof = smem + kQ * W::kCells;  // [kQ][TX or TY] (kForce)
  uint8_t* mask =
      reinterpret_cast<uint8_t*>(smem + kQ * W::kCells + W::kProf);

  const int tid = threadIdx.x;
  // global coordinates of window (0, 0)
  int x0, y0;
  if constexpr (tpulbm::kRings) {
    x0 = sh.x0 + blockIdx.x * kBX - N - (tpulbm::kColShift ? x_shift : 0);
    y0 = sh.y0 + sh.r0 + blockIdx.y * kBY - N - y_shift;
  } else {
    x0 = blockIdx.x * kBX - N - (tpulbm::kColShift ? x_shift : 0);
    y0 = blockIdx.y * kBY - N - y_shift;
  }
  const size_t plane = static_cast<size_t>(nx) * ny;
  const int flen = force.axis == 0 ? TX : TY;
  // the force profile's entry of the window cell (lx, ly), population 0
  auto prof_at = [&](int lx, int ly) {
    return prof + (force.axis == 0 ? lx : ly);
  };
  // the link table's entry of the window cell at global (gx, gy) whose
  // mask byte is m (kBouzidi), or null where the cell has no cut link: the
  // obstacle domain's coordinates need no wrap, the slab's x wraps where
  // the block holds every column (find()), and elsewhere the caller has
  // wrapped it (window_cell)
  auto link_at = [&](uint8_t m, int gx, int gy) -> const float* {
    if (!tpulbm::kBouzidi || !(m & tpulbm::kLinkBit)) return nullptr;
    if constexpr (tpulbm::kRings) {
      if (tpulbm::kPeriodicX && sh.hx == 0) gx = ((gx % nx) + nx) % nx;
      return links.q + sh.padded(gx - sh.x0, gy - sh.y0);
    } else {
      return links.q + static_cast<size_t>(gy) * nx + gx;
    }
  };
  if constexpr (tpulbm::kForce) {
    force.stage(prof, flen, force.axis == 0 ? x0 : y0,
                force.axis == 0 ? nx : ny, tid, kThreads);
    __syncthreads();
  }

  // Load the window's in-domain cells once and collide them.
  for (int c = tid; c < W::kCells; c += kThreads) {
    const int ly = c / TX;
    const int lx = c - ly * TX;
    int gx = x0 + lx;
    int gy = y0 + ly;
    float v[kQ];
    if constexpr (tpulbm::kRings) {
      int bx, by;
      if (!sh.find(gx, gy, nx, ny, bx, by)) {
        mask[c] = kNotHeld;
        continue;
      }
      mask[c] = tpulbm::kHasObstacle ? sh.mask_byte(bx, by) : 0;
      size_t stride;
      const float* src = sh.locate(bx, by, stride);
#pragma unroll
      for (int i = 0; i < kQ; ++i) v[i] = src[i * stride];
    } else {
      if (!window_cell(gx, gy, nx, ny)) continue;
      const size_t cell = static_cast<size_t>(gy) * nx + gx;
      if constexpr (tpulbm::kHasObstacle) mask[c] = solid[cell];
#pragma unroll
      for (int i = 0; i < kQ; ++i) v[i] = f[i * plane + cell];
    }
    tpulbm::collide_cell(v, k,
                         tpulbm::kBounceBack && tpulbm::is_solid(mask[c]),
                         prof_at(lx, ly), flen);
#pragma unroll
    for (int i = 0; i < kQ; ++i) post[i * W::kCells + c] = v[i];
  }
  __syncthreads();

  // Substeps 1 .. N-1: the cells at depth >= s into the window, stepped
  // and collided in registers, then written back in place.
#pragma unroll
  for (int s = 1; s < N; ++s) {
    const int w = TX - 2 * s;
    const int cells = w * (TY - 2 * s);
    float g[W::kPerThread][kQ];
    int at[W::kPerThread];  // window index of each held cell, -1 if none
#pragma unroll
    for (int j = 0; j < W::kPerThread; ++j) {
      const int c = tid + j * kThreads;
      at[j] = -1;
      if (c >= cells) continue;
      const int ly = s + c / w;
      const int lx = s + c % w;
      int gx = x0 + lx;
      int gy = y0 + ly;
      if constexpr (tpulbm::kRings) {
        // a held cell's x and y need no wrap here: in the channel and the
        // box, the domains that wrap, no rule reads them (the force
        // profile's entry was staged at the owner's coordinate)
        if (mask[ly * TX + lx] == kNotHeld) continue;
      } else {
        if (!window_cell(gx, gy, nx, ny)) continue;
      }
      const int lc = ly * TX + lx;
      at[j] = lc;
      auto post_at = [&](int i, int dx, int dy) {
        return post[i * W::kCells + lc + dy * TX + dx];
      };
      auto solid_at = [&](int dx, int dy) {
        return tpulbm::is_solid(mask[lc + dy * TX + dx]);
      };
      const uint8_t m = tpulbm::kHasObstacle ? mask[lc] : 0;
      const bool is_solid = tpulbm::is_solid(m);
      // the rewrite reads this cell's post-collision values of this
      // substep from the buffer, before the barrier that overwrites it
      tpulbm::pull_d2q9(g[j], gx, gy, nx, ny, k, post_at);
      tpulbm::apply_boundaries<kCorners>(g[j], is_solid, gx, gy, nx, ny, k,
                                         post_at, solid_at,
                                         link_at(m, gx, gy), links);
      tpulbm::collide_cell(g[j], k, tpulbm::kBounceBack && is_solid,
                           prof_at(lx, ly), flen);
    }
    __syncthreads();  // every pull of this substep has read the old values
#pragma unroll
    for (int j = 0; j < W::kPerThread; ++j) {
      if (at[j] < 0) continue;
#pragma unroll
      for (int i = 0; i < kQ; ++i) post[i * W::kCells + at[j]] = g[j][i];
    }
    __syncthreads();
  }

  // Substep N: the tile alone, stored to device memory.
  for (int c = tid; c < kBX * kBY; c += kThreads) {
    const int ly = N + c / kBX;
    const int lx = N + c % kBX;
    const int gx = x0 + lx;
    const int gy = y0 + ly;
    if constexpr (tpulbm::kRings) {
      if (!sh.writes(gx - sh.x0, gy - sh.y0)) continue;
    } else {
      if ((tpulbm::kColShift && gx < 0) || gx >= nx || gy < 0 || gy >= ny)
        continue;
    }
    const int lc = ly * TX + lx;
    auto post_at = [&](int i, int dx, int dy) {
      return post[i * W::kCells + lc + dy * TX + dx];
    };
    auto solid_at = [&](int dx, int dy) {
      return tpulbm::is_solid(mask[lc + dy * TX + dx]);
    };
    float g[kQ];
    const uint8_t m = tpulbm::kHasObstacle ? mask[lc] : 0;
    tpulbm::pull_d2q9(g, gx, gy, nx, ny, k, post_at);
    tpulbm::apply_boundaries<kCorners>(g, tpulbm::is_solid(m), gx, gy, nx, ny,
                                       k, post_at, solid_at,
                                       link_at(m, gx, gy), links);
    if constexpr (tpulbm::kRings) {
      const size_t cell =
          static_cast<size_t>(gy - sh.y0) * sh.nxl + (gx - sh.x0);
      const size_t block = static_cast<size_t>(sh.nxl) * sh.nyl;
#pragma unroll
      for (int i = 0; i < kQ; ++i) out[i * block + cell] = g[i];
    } else {
      const size_t cell = static_cast<size_t>(gy) * nx + gx;
#pragma unroll
      for (int i = 0; i < kQ; ++i) out[i * plane + cell] = g[i];
    }
  }
}

template <int N, bool kCorners>
cudaError_t launch(const float* f, float* out, const uint8_t* solid, int nx,
                   int ny, int tiles_x, int tiles_y, int x_shift, int y_shift,
                   const StepConsts& k, const tpulbm::Shard& sh,
                   const tpulbm::ForceTable& force,
                   const tpulbm::Links& links, cudaStream_t stream) {
  constexpr size_t smem = Window<N>::kSmemBytes;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        d2q9_blocked_kernel<N, kCorners>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((tiles_x + x_shift + kBX - 1) / kBX,
                  (tiles_y + y_shift + kBY - 1) / kBY);
  d2q9_blocked_kernel<N, kCorners><<<grid, kThreads, smem, stream>>>(
      f, out, solid, nx, ny, x_shift, y_shift, k, sh, force, links);
  return cudaGetLastError();
}

// n_sub steps over the tiles_x x tiles_y cells the launch writes, the
// tiling shifted as tpulbm::tile_row_shift and tile_col_shift say for them.
cudaError_t launch(const float* f, float* out, const uint8_t* solid, int nx,
                   int ny, int tiles_x, int tiles_y, int n_sub, bool corners,
                   const StepConsts& k, const tpulbm::Shard& sh,
                   const tpulbm::ForceTable& force,
                   const tpulbm::Links& links, cudaStream_t stream) {
  const int y_shift = tpulbm::tile_row_shift(
      tiles_y, kBY, corners || tpulbm::kDomain == tpulbm::kCavity);
  const int x_shift = tpulbm::tile_col_shift(tiles_x, kBX);
#define TPULBM_LAUNCH(N)                                                   \
  (corners && tpulbm::kCornerRule                                          \
       ? launch<N, tpulbm::kCornerRule>(f, out, solid, nx, ny, tiles_x,    \
                                        tiles_y, x_shift, y_shift, k, sh,  \
                                        force, links, stream)              \
       : launch<N, false>(f, out, solid, nx, ny, tiles_x, tiles_y, x_shift, \
                          y_shift, k, sh, force, links, stream))
  switch (n_sub) {
#if TPULBM_DEEP
    case 5: return TPULBM_LAUNCH(5);
    case 6: return TPULBM_LAUNCH(6);
    case 7: return TPULBM_LAUNCH(7);
    case 8: return TPULBM_LAUNCH(8);
#else
    case 2: return TPULBM_LAUNCH(2);
    case 3: return TPULBM_LAUNCH(3);
    case 4: return TPULBM_LAUNCH(4);
#endif
    default: return cudaErrorInvalidValue;
  }
#undef TPULBM_LAUNCH
}

}  // namespace

// Plain C interface, loaded with ctypes (tpulbm_torch/ops/step_cuda.py).
// Each launcher launches n_sub steps on `stream` and returns
// cudaGetLastError() (a refused launch never runs and a later synchronize
// would not report it); it neither synchronizes nor allocates. The clean
// corners belong to the obstacle domain; elsewhere the launcher takes
// clean_corners = 0. force_axis and force_table: the force profile
// (tpulbm::ForceTable), read by the kForce build only; links and
// link_planes: the Bouzidi link table, 9 or 18 planes (tpulbm::Links),
// read by the kBouzidi build only (elsewhere null and 0).
#if !TPULBM_RINGS
extern "C" int tpulbm_d2q9_step_blocked(const float* f, float* out,
                                        const uint8_t* solid, int nx, int ny,
                                        int n_sub, float inv_tau, float u_in,
                                        float one_minus_u_in,
                                        const float* eq_in, const float* w,
                                        int clean_corners, const float* mode,
                                        const float* src, float lid7,
                                        float lid8, int force_axis,
                                        const float* force_table,
                                        const float* links, int link_planes,
                                        int device, void* stream) {
  if (!tpulbm::links_fit(links, link_planes, kQ)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const StepConsts k = tpulbm::make_consts(inv_tau, u_in, one_minus_u_in,
                                           eq_in, w, mode, src, lid7, lid8);
  err = launch(f, out, solid, nx, ny, nx, ny, n_sub, clean_corners != 0, k,
               tpulbm::Shard{}, tpulbm::ForceTable{force_table, force_axis},
               tpulbm::Links{links, static_cast<size_t>(nx) * ny,
                             link_planes == 2 * kQ},
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
#else
// n_sub steps of the shard (nxl x nyl at global x0, y0 of the nx x ny
// grid) from f and its rings (depth n_sub; hx 0 or n_sub, as tpulbm::Shard
// describes them) into rows [r0, r1) of out; the other rows of out are left
// as they are. mask is the shard's solid mask padded by n_sub cells, and
// links its cut of the link table padded the same way.
extern "C" int tpulbm_d2q9_step_blocked_rings(
    const float* f, float* out, const uint8_t* mask, const float* rb,
    const float* rt, const float* rl, const float* rr, int nx, int ny,
    int nxl, int nyl, int x0, int y0, int hx, int r0, int r1, int n_sub,
    float inv_tau, float u_in, float one_minus_u_in, const float* eq_in,
    const float* w, int clean_corners, const float* mode, const float* src,
    float lid7, float lid8, int force_axis, const float* force_table,
    const float* links, int link_planes, int device, void* stream) {
  if (!tpulbm::links_fit(links, link_planes, kQ)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r0 < 0 || r1 > nyl || r0 >= r1) return cudaErrorInvalidValue;
  const StepConsts k = tpulbm::make_consts(inv_tau, u_in, one_minus_u_in,
                                           eq_in, w, mode, src, lid7, lid8);
  const tpulbm::Shard sh{f, rb, rt, rl, rr, mask, nxl, nyl,
                         x0, y0, hx, n_sub, r0, r1};
  err = launch(f, out, nullptr, nx, ny, nxl, r1 - r0, n_sub,
               clean_corners != 0, k, sh,
               tpulbm::ForceTable{force_table, force_axis},
               tpulbm::Links{links,
                             static_cast<size_t>(nyl + 2 * n_sub) *
                                 (nxl + 2 * n_sub),
                             link_planes == 2 * kQ},
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
#endif

// Dynamic shared memory one block of depth n_sub takes, in bytes (-1 for
// a depth the library does not hold).
extern "C" int tpulbm_d2q9_blocked_smem_bytes(int n_sub) {
  switch (n_sub) {
#if TPULBM_DEEP
    case 5: return static_cast<int>(Window<5>::kSmemBytes);
    case 6: return static_cast<int>(Window<6>::kSmemBytes);
    case 7: return static_cast<int>(Window<7>::kSmemBytes);
    case 8: return static_cast<int>(Window<8>::kSmemBytes);
#else
    case 2: return static_cast<int>(Window<2>::kSmemBytes);
    case 3: return static_cast<int>(Window<3>::kSmemBytes);
    case 4: return static_cast<int>(Window<4>::kSmemBytes);
#endif
    default: return -1;
  }
}

// The floats of the library's mode coefficients, which the caller's array
// must hold (its mode: collision_modes.cuh's tpulbm_collision_mode).
extern "C" int tpulbm_mode_floats() { return tpulbm::kModeFloats; }

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
