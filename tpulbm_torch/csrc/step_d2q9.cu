// One fused D2Q9 timestep on an NVIDIA Hopper GPU (sm_90a), float32:
// collide (+ body-force source) -> pull-stream -> ghost sanitize -> the
// domain's boundary sequence. The obstacle domain (the cylinder): y walls
// -> Zou-He inlet -> Zou-He outlet -> clean Zou-He corners (optional) ->
// obstacle (pin or bounce-back). The channel: periodic x, y walls. The
// cavity: bottom wall -> moving lid -> side walls -> corner closure. The
// box: periodic x and y, no walls.
//
// Replaces tpulbm/ops/step_pallas.py::make_local_step_pallas (the fused
// 1-step Pallas TPU kernel) with its src, force_fn, periodic_x, periodic
// y, walls_x, lid_u and bounce_back modes, under each of its collisions
// (BGK, TRT, MRT, regularized, KBC, Smagorinsky, power law) and with
// either corner rule: one library per collision, domain, source, force
// profile and obstacle rule (collision_modes.cuh, d2q9_common.cuh). Its
// plain version is tpulbm_torch/ops/step_torch.py.
//
// Layout: f is SoA (9, ny, nx) float32 with x fastest, one plane per
// population. One thread owns one cell, x fastest, so each plane is read
// and written with coalesced accesses. Any nx and ny run: the ragged
// blocks at the right and top edges are masked, no padding is needed.
//
// What bounds it: device-memory traffic for BGK. A step has to read and
// write the 9 populations of every cell once, 72 B per cell (plus 1 B of
// solid mask), against about 115 floating-point operations per cell under
// BGK and up to a few hundred under KBC or the power law's Newton solve.
// The kernel is written to touch each population once in device memory: a
// block loads its tile and a one-cell halo, collides every loaded cell once
// in registers, keeps the post-collision values in shared memory for the
// pull, and applies every boundary condition in registers before the single
// store. The halo cells are re-read by the neighbouring blocks (mostly from
// L2) and collided there again.
//
// Every boundary condition but two reads only the post-stream values of
// its own cell, so the TPU kernel's slab ring, lane padding and VMEM sizing
// have no counterpart here. The exceptions are the clean corners' inlet
// rule, which needs the density of the node one row inward after its own
// pull and inlet, and the cavity's corners, which need that of the
// diagonally inward node after its pull: the corner thread recomputes that
// pull from the shared tile, which holds the two rows (and columns) it
// reaches when the tiling starts one row lower (one column further left)
// wherever a top (right) corner would sit on a tile's first row (column)
// (tpulbm::tile_row_shift, tile_col_shift). In the channel the tile's halo
// columns at x = -1 and x = nx are loaded from x = nx-1 and x = 0, so the
// pull wraps with no test of its own; in the box the halo rows at y = -1
// and y = ny too, from y = ny-1 and y = 0.
//
// The force profile (-DTPULBM_FORCE=1, Kolmogorov's cos(ky) along y or a
// force along x): a block stages its tile's and halo's entries of the
// (9, n) table once in shared memory (tpulbm::ForceTable), at the
// coordinate of the cell that owns each, and every collision adds them.
// The table is n x 36 B, read from L2 by every block: no force field
// travels through device memory.
//
// The collision, the pull's ghost rule and the boundary sequence live in
// d2q9_common.cuh, shared with the N-step kernel (step_d2q9_blocked.cu).
//
// Built with -DTPULBM_RINGS=1 the kernel steps one shard of a mesh
// (tpulbm_d2q9_step_rings): the block and the one-cell rings its
// neighbours sent (tpulbm::Shard), into a range of the block's rows. That
// build replaces make_local_step_pallas with its ring inputs (rb, rt, the
// mask rings, the physical-edge flags), make_local_step_pallas_ranged (the
// row range) and make_local_step_tiled at depth 1 (the x rings). The tile
// keeps global coordinates, so every rule acts only at the domain's own
// edges, and a tile cell outside the block is loaded from its ring; the
// bits are those of the one-device build. The rings add 2 (nxl + 2 hx +
// hx nyl) x 36 B a launch to the 73 B a cell.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d2q9_common.cuh"

namespace {

using tpulbm::kQ;
using tpulbm::StepConsts;

constexpr int kBX = 32;  // block width (cells along x): one warp per row
constexpr int kBY = 8;   // block height (rows)
constexpr int kTX = kBX + 2;
constexpr int kTY = kBY + 2;

template <bool kCorners>
__global__ void __launch_bounds__(kBX * kBY)
    d2q9_step_kernel(const float* __restrict__ f, float* __restrict__ out,
                     const uint8_t* __restrict__ solid, int nx, int ny,
                     int x_shift, int y_shift, StepConsts k,
                     tpulbm::Shard sh, tpulbm::ForceTable force) {
  __shared__ float post[kQ][kTY][kTX];  // post-collision tile + halo
  // the force profile's entries of the tile's columns or rows (kForce)
  __shared__ float prof[tpulbm::kForce ? kQ * kTX : 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  int x0, y0;  // global coordinates of the tile's first cell
  if constexpr (tpulbm::kRings) {
    x0 = sh.x0 + blockIdx.x * kBX - (tpulbm::kColShift ? x_shift : 0);
    y0 = sh.y0 + sh.r0 + blockIdx.y * kBY - y_shift;
  } else {
    x0 = blockIdx.x * kBX - (tpulbm::kColShift ? x_shift : 0);
    y0 = blockIdx.y * kBY - y_shift;
  }
  const size_t plane = static_cast<size_t>(nx) * ny;
  const int flen = force.axis == 0 ? kTX : kTY;
  if constexpr (tpulbm::kForce) {
    force.stage(prof, flen, (force.axis == 0 ? x0 : y0) - 1,
                force.axis == 0 ? nx : ny, ty * kBX + tx, kBX * kBY);
    __syncthreads();
  }

  // Load and collide the tile and its in-domain halo (in the channel the
  // halo columns x = -1 and x = nx wrap, in the box the rows y = -1 and
  // y = ny too). Halo cells outside the domain are never read below: the
  // ghost rules replace them.
  for (int t = ty * kBX + tx; t < kTX * kTY; t += kBX * kBY) {
    const int ly = t / kTX;
    const int lx = t - ly * kTX;
    int gx = x0 + lx - 1;
    int gy = y0 + ly - 1;
    float v[kQ];
    bool skip;  // solid under the bounce-back obstacle: no collision
    if constexpr (tpulbm::kRings) {
      int bx, by;
      if (!sh.find(gx, gy, nx, ny, bx, by)) continue;
      size_t stride;
      const float* src = sh.locate(bx, by, stride);
#pragma unroll
      for (int i = 0; i < kQ; ++i) v[i] = src[i * stride];
      skip = tpulbm::kBounceBack && sh.solid(bx, by);
    } else {
      if constexpr (tpulbm::kPeriodicY) {
        if (gx < -1 || gx > nx || gy < -1 || gy > ny) continue;
        gx = gx < 0 ? nx - 1 : gx >= nx ? 0 : gx;
        gy = gy < 0 ? ny - 1 : gy >= ny ? 0 : gy;
      } else if constexpr (tpulbm::kPeriodicX) {
        if (gx < -1 || gx > nx || gy < 0 || gy >= ny) continue;
        gx = gx < 0 ? nx - 1 : gx >= nx ? 0 : gx;
      } else {
        if (gx < 0 || gx >= nx || gy < 0 || gy >= ny) continue;
      }
      const size_t cell = static_cast<size_t>(gy) * nx + gx;
#pragma unroll
      for (int i = 0; i < kQ; ++i) v[i] = f[i * plane + cell];
      skip = tpulbm::kBounceBack && solid[cell] != 0;
    }
    tpulbm::collide_cell(v, k, skip, prof + (force.axis == 0 ? lx : ly),
                         flen);
#pragma unroll
    for (int i = 0; i < kQ; ++i) post[i][ly][lx] = v[i];
  }
  __syncthreads();

  const int x = x0 + tx;
  const int y = y0 + ty;
  // post-collision value of population i at (x+dx, y+dy)
  auto post_at = [&](int i, int dx, int dy) {
    return post[i][ty + 1 + dy][tx + 1 + dx];
  };
  float g[kQ];
  if constexpr (tpulbm::kRings) {
    const int bx = x - sh.x0;
    const int by = y - sh.y0;
    if (!sh.writes(bx, by)) return;
    auto solid_at = [&](int dx, int dy) { return sh.solid(bx + dx, by + dy); };
    tpulbm::pull_d2q9(g, x, y, nx, ny, k, post_at);
    tpulbm::apply_boundaries<kCorners>(
        g, tpulbm::kHasObstacle && sh.solid(bx, by), x, y, nx, ny, k, post_at,
        solid_at);
    const size_t cell = static_cast<size_t>(by) * sh.nxl + bx;
    const size_t block = static_cast<size_t>(sh.nxl) * sh.nyl;
#pragma unroll
    for (int i = 0; i < kQ; ++i) out[i * block + cell] = g[i];
  } else {
    if ((tpulbm::kColShift && x < 0) || x >= nx || y < 0 || y >= ny) return;
    auto solid_at = [&](int dx, int dy) {
      return solid[static_cast<size_t>(y + dy) * nx + x + dx] != 0;
    };
    tpulbm::pull_d2q9(g, x, y, nx, ny, k, post_at);
    const size_t cell = static_cast<size_t>(y) * nx + x;
    tpulbm::apply_boundaries<kCorners>(
        g, tpulbm::kHasObstacle && solid[cell] != 0, x, y, nx, ny, k,
        post_at, solid_at);
#pragma unroll
    for (int i = 0; i < kQ; ++i) out[i * plane + cell] = g[i];
  }
}

template <bool kCorners>
cudaError_t launch(const float* f, float* out, const uint8_t* solid, int nx,
                   int ny, int tiles_x, int tiles_y, int x_shift, int y_shift,
                   const StepConsts& k, const tpulbm::Shard& sh,
                   const tpulbm::ForceTable& force, cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((tiles_x + x_shift + kBX - 1) / kBX,
                  (tiles_y + y_shift + kBY - 1) / kBY);
  d2q9_step_kernel<kCorners><<<grid, block, 0, stream>>>(
      f, out, solid, nx, ny, x_shift, y_shift, k, sh, force);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes (tpulbm_torch/ops/step_cuda.py).
// Each launcher launches one step on `stream` and returns
// cudaGetLastError(): it neither synchronizes nor allocates.
// The clean corners belong to the obstacle domain; elsewhere the launcher
// takes clean_corners = 0. force_table is the force profile's (9, n) device
// table along force_axis (tpulbm::ForceTable), read by the kForce build
// only (elsewhere null).
#if !TPULBM_RINGS
extern "C" int tpulbm_d2q9_step(const float* f, float* out,
                                const uint8_t* solid, int nx, int ny,
                                float inv_tau, float u_in,
                                float one_minus_u_in, const float* eq_in,
                                const float* w, int clean_corners,
                                const float* mode, const float* src,
                                float lid7, float lid8, int force_axis,
                                const float* force_table, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const StepConsts k = tpulbm::make_consts(inv_tau, u_in, one_minus_u_in,
                                           eq_in, w, mode, src, lid7, lid8);
  const int y_shift = tpulbm::tile_row_shift(
      ny, kBY, clean_corners != 0 || tpulbm::kDomain == tpulbm::kCavity);
  const int x_shift = tpulbm::tile_col_shift(nx, kBX);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const tpulbm::Shard none{};
  const tpulbm::ForceTable force{force_table, force_axis};
  err = clean_corners
            ? launch<true>(f, out, solid, nx, ny, nx, ny, x_shift, y_shift, k,
                           none, force, s)
            : launch<false>(f, out, solid, nx, ny, nx, ny, x_shift, y_shift,
                            k, none, force, s);
  return static_cast<int>(err);
}
#else
// One step of the shard (nxl x nyl at global x0, y0 of the nx x ny grid)
// from f and its rings (depth 1; hx 0 or 1, as tpulbm::Shard describes
// them) into rows [r0, r1) of out; the other rows of out are left as they
// are. mask is the shard's solid mask padded by one cell.
extern "C" int tpulbm_d2q9_step_rings(
    const float* f, float* out, const uint8_t* mask, const float* rb,
    const float* rt, const float* rl, const float* rr, int nx, int ny,
    int nxl, int nyl, int x0, int y0, int hx, int r0, int r1, float inv_tau,
    float u_in, float one_minus_u_in, const float* eq_in, const float* w,
    int clean_corners, const float* mode, const float* src, float lid7,
    float lid8, int force_axis, const float* force_table, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r0 < 0 || r1 > nyl || r0 >= r1) return cudaErrorInvalidValue;
  const StepConsts k = tpulbm::make_consts(inv_tau, u_in, one_minus_u_in,
                                           eq_in, w, mode, src, lid7, lid8);
  const tpulbm::Shard sh{f, rb, rt, rl, rr, mask, nxl, nyl,
                         x0, y0, hx, 1, r0, r1};
  // the tiling's shifts, counted in the rows and columns this launch
  // writes: a top corner must not sit on a tile's first row (a right one
  // on its first column), wherever the block lies in the grid
  const int y_shift = tpulbm::tile_row_shift(
      r1 - r0, kBY, clean_corners != 0 || tpulbm::kDomain == tpulbm::kCavity);
  const int x_shift = tpulbm::tile_col_shift(nxl, kBX);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const tpulbm::ForceTable force{force_table, force_axis};
  err = clean_corners
            ? launch<true>(f, out, nullptr, nx, ny, nxl, r1 - r0, x_shift,
                           y_shift, k, sh, force, s)
            : launch<false>(f, out, nullptr, nx, ny, nxl, r1 - r0, x_shift,
                            y_shift, k, sh, force, s);
  return static_cast<int>(err);
}
#endif

// The floats of the library's mode coefficients, which the caller's array
// must hold (its mode: collision_modes.cuh's tpulbm_collision_mode).
extern "C" int tpulbm_mode_floats() { return tpulbm::kModeFloats; }

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
