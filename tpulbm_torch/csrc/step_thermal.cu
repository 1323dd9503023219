// One fused thermal (double-population) timestep on an NVIDIA Hopper GPU
// (sm_90a), float32: D2Q9 flow + D2Q5 temperature, Boussinesq coupling.
// Collide (BGK f + buoyancy source, BGK g toward the advection-diffusion
// equilibrium) -> pull-stream -> x walls (cavity) -> bottom wall -> top
// wall. Rayleigh-Bénard (periodic x) and the side-heated cavity (x walls).
//
// Replaces tpulbm/ops/step_thermal_pallas.py::make_local_step_thermal_pallas
// (:147, the fused 1-step thermal Pallas TPU kernel) on one full-width
// device, for BGK and, built with -DTPULBM_COLLISION=5, its Smagorinsky
// LES branch (_collide_thermal_rows :100-124: the flow planes relax at the
// per-cell rate, then the buoyancy source; g as under BGK). Both compute
// one step of
// tpulbm/ops/step_thermal.py::make_step_thermal; so does this kernel, cell
// by cell. Its plain version is tpulbm_torch/ops/step_thermal.py.
//
// Layout: the state is SoA (14, ny, nx) float32 with x fastest: the 9 f
// planes, then the 5 g planes. One thread owns one cell, x fastest, so each
// plane is read and written with coalesced accesses. Any nx and ny run: the
// ragged blocks at the right and top edges are masked, no lane padding is
// needed (the Pallas kernel pads x-walled grids to 128 lanes).
//
// What bounds it: device-memory traffic. A step reads and writes the 14
// populations of every cell once, 112 B per cell, no mask, against about
// 250 floating-point operations per cell. At 2048x512 that is 117.4 MB a
// step, 0.0351 ms at 3.35 TB/s. So, as in step_d2q9.cu, a block loads its
// 32x8 tile and a one-cell halo of all 14 planes, collides every loaded
// cell once, keeps the post-collision values in shared memory (19,040 B)
// for the pull, and applies every boundary in registers before the single
// store. Halo cells are re-read by the neighbouring blocks (mostly from L2)
// and collided there again.
//
// Streaming: the halo is loaded with wrapped coordinates, so a pull across
// an edge reads the periodic neighbour. Where a wall flag is set, a pull
// from below y = 0 (above y = ny-1) reads the frozen ghost constant of that
// wall instead (rest equilibrium for f, w_i T_wall for g), not collided;
// the x walls replace every pull across x. The flags is_bottom and is_top
// are the Pallas kernel's flags[0] and flags[1].
//
// Boundaries, in the Pallas kernel's order, each reading only this cell:
// with walls_x, every plane with c_x != 0 at an edge column takes the
// node's own post-collision opposite (adiabatic no-slip walls, f and g);
// then at a wall row, the inward f planes take the node's own
// post-collision opposite (full-way bounce-back) and the inward g plane
// takes (w_i + w_opp) T_wall - g_opp against the just-streamed opposite
// (anti-bounce-back Dirichlet).
//
// Rounding follows the plain version: directions are summed in order,
// u = m * (1/rho) as the Pallas kernel does, the constants that carry
// products of tpulbm's float64 constants (3 w_i, w_i T_wall,
// (w_i + w_opp) T_wall) are rounded once on the host, and the library is
// built with -fmad=false so no multiply and add share one rounding.
//
// Built with -DTPULBM_RINGS=1 the kernel steps one shard of a mesh
// (tpulbm_thermal_step_rings): the shard's block and the one-cell rings its
// neighbours sent (tpulbm::Shard, depth 1), the counterpart of the Pallas
// kernel's ring inputs rb/rt, its physical-edge flags and its x_halo
// columns rl/rr (step_thermal_pallas.py:147-175, 251-258). The tile keeps
// global coordinates: a window cell is loaded from the block or from the
// ring that holds it (Shard::locate; where the block spans every column,
// x wraps inside it), and the walls act at the global rows y = 0 and
// ny-1 and, with walls_x, the global columns x = 0 and nx-1 only, never
// at a shard's own edge (the Pallas kernel's flags[0:4]). The passive
// scalar's y wraps through its rings. So a shard's cells get the bits of
// the one-device build. The rings add 2 (nxl + 2 hx + hx nyl) x 56 B a
// launch to the 112 B a cell.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d2q9_common.cuh"

// The 14 planes of the stacked state: X(plane, cx, cy, opposite plane).
// Planes 0-8 are tpulbm.lattice.D2Q9 in its order, planes 9-13 are D2Q5.
// tests/test_torch_thermal.py parses this table and compares it with the
// lattices.
#define TPULBM_THERMAL_PLANES(X) \
  X(0, 0, 0, 0)                  \
  X(1, 1, 0, 3)                  \
  X(2, 0, 1, 4)                  \
  X(3, -1, 0, 1)                 \
  X(4, 0, -1, 2)                 \
  X(5, 1, 1, 7)                  \
  X(6, -1, 1, 8)                 \
  X(7, -1, -1, 5)                \
  X(8, 1, -1, 6)                 \
  X(9, 0, 0, 9)                  \
  X(10, 1, 0, 12)                \
  X(11, 0, 1, 13)                \
  X(12, -1, 0, 10)               \
  X(13, 0, -1, 11)

namespace {

constexpr int kQf = tpulbm::kQ;  // flow populations (D2Q9)
constexpr int kQg = 5;           // temperature populations (D2Q5)
constexpr int kQs = kQf + kQg;   // planes of the stacked state

constexpr int kBX = 32;  // block width (cells along x): one warp per row
constexpr int kBY = 8;   // block height (rows)
constexpr int kTX = kBX + 2;
constexpr int kTY = kBY + 2;

struct ThermalConsts {
  float inv_tau;            // 1 / tau
  float inv_tau_g;          // 1 / tau_g
  float buoyancy;           // beta g; 0 turns the source off
  float t_ref;              // (T_bottom + T_top) / 2
  float smag_tau0;          // Smagorinsky (the LES build): tau0, tau0²
  float smag_tau0_sq;
  float smag_coef;          // 18 Cs²
  float w[kQs];             // D2Q9 weights, then D2Q5 weights
  float w3[kQf];            // 3 w_i: the buoyancy source per unit force
  float ghost_bottom[kQs];  // frozen ghost value below y = 0, per plane
  float ghost_top[kQs];     // frozen ghost value above y = ny-1, per plane
  float wall_bottom[kQg];   // (w_i + w_opp) T_bottom, per g plane
  float wall_top[kQg];      // (w_i + w_opp) T_top, per g plane
  int baxis;                // buoyancy axis: 1 = y (Rayleigh-Bénard), 0 = x
  int is_bottom;            // the bottom row is a wall
  int is_top;               // the top row is a wall
  int walls_x;              // adiabatic no-slip walls at x = 0 and nx-1
};

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

static_assert(tpulbm::kMode == tpulbm::kBGK ||
                  tpulbm::kMode == tpulbm::kSmagorinsky,
              "the thermal kernel runs BGK or the Smagorinsky closure");

// Thermal collision of one cell's 14 populations, in place (tpulbm's
// _collide_thermal_rows).
__device__ __forceinline__ void collide_thermal(float* v,
                                                const ThermalConsts& k) {
  const tpulbm::Moments m = tpulbm::moments_d2q9(v);
  float T = v[kQf];
#pragma unroll
  for (int i = kQf + 1; i < kQs; ++i) T = T + v[i];
  if constexpr (tpulbm::kMode == tpulbm::kSmagorinsky) {
    tpulbm::relax_smagorinsky(v, m, k.w, k.smag_tau0, k.smag_tau0_sq,
                              k.smag_coef);
  } else {
    tpulbm::relax_bgk(v, m, k.inv_tau, k.w);
  }
  if (k.buoyancy != 0.0f) {
    // f_i += 3 w_i c_i,axis * buoyancy (T - t_ref), c_i,axis = +-1 or 0
    const float fy = k.buoyancy * (T - k.t_ref);
#define TPULBM_BUOYANCY(i, cx, cy, o)                        \
  if ((i) < kQf) {                                          \
    const int c = k.baxis == 0 ? (cx) : (cy);               \
    if (c > 0) v[i] = v[i] + k.w3[i] * fy;                  \
    if (c < 0) v[i] = v[i] + -k.w3[i] * fy;                 \
  }
    TPULBM_THERMAL_PLANES(TPULBM_BUOYANCY)
#undef TPULBM_BUOYANCY
  }
  // g: BGK toward w_i T (1 + 3 c_i.u), c.u as exact +-adds
  const float cu[kQg] = {0.0f, m.ux, m.uy, -m.ux, -m.uy};
  v[kQf] = v[kQf] - k.inv_tau_g * (v[kQf] - k.w[kQf] * T);
#pragma unroll
  for (int j = 1; j < kQg; ++j) {
    const int i = kQf + j;
    const float geq = k.w[i] * T * (1.0f + 3.0f * cu[j]);
    v[i] = v[i] - k.inv_tau_g * (v[i] - geq);
  }
}

__global__ void __launch_bounds__(kBX * kBY)
    thermal_step_kernel(const float* __restrict__ s, float* __restrict__ out,
                        int nx, int ny, ThermalConsts k, tpulbm::Shard sh) {
  __shared__ float post[kQs][kTY][kTX];  // post-collision tile + halo

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  // global coordinates of the tile's first cell
  const int x0 = (tpulbm::kRings ? sh.x0 : 0) + blockIdx.x * kBX;
  const int y0 = (tpulbm::kRings ? sh.y0 : 0) + blockIdx.y * kBY;
  const size_t plane = static_cast<size_t>(nx) * ny;

  // Load and collide the tile and its halo, at wrapped coordinates (a
  // shard: from the block or its rings; window cells beyond the rings feed
  // no cell of the block and are skipped).
  for (int t = ty * kBX + tx; t < kTX * kTY; t += kBX * kBY) {
    const int ly = t / kTX;
    const int lx = t - ly * kTX;
    float v[kQs];
    if constexpr (tpulbm::kRings) {
      int bx = x0 + lx - 1 - sh.x0;
      const int by = y0 + ly - 1 - sh.y0;
      if (by < -1 || by > sh.nyl) continue;
      if (sh.hx == 0) {
        bx = wrap(bx, sh.nxl);
      } else if (bx < -1 || bx > sh.nxl) {
        continue;
      }
      size_t stride;
      const float* src = sh.locate(bx, by, stride);
#pragma unroll
      for (int i = 0; i < kQs; ++i) v[i] = src[i * stride];
    } else {
      const int gx = wrap(x0 + lx - 1, nx);
      const int gy = wrap(y0 + ly - 1, ny);
      const size_t cell = static_cast<size_t>(gy) * nx + gx;
#pragma unroll
      for (int i = 0; i < kQs; ++i) v[i] = s[i * plane + cell];
    }
    collide_thermal(v, k);
#pragma unroll
    for (int i = 0; i < kQs; ++i) post[i][ly][lx] = v[i];
  }
  __syncthreads();

  const int x = x0 + tx;
  const int y = y0 + ty;
  if constexpr (tpulbm::kRings) {
    if (x - sh.x0 >= sh.nxl || y - sh.y0 >= sh.nyl) return;
  } else {
    if (x >= nx || y >= ny) return;
  }

  // pull g_i(x, y) = post_i((x, y) - c_i), or the wall's ghost constant
  float g[kQs];
#define TPULBM_PULL(i, cx, cy, o)                   \
  if ((cy) > 0 && y == 0 && k.is_bottom) {          \
    g[i] = k.ghost_bottom[i];                       \
  } else if ((cy) < 0 && y == ny - 1 && k.is_top) { \
    g[i] = k.ghost_top[i];                          \
  } else {                                          \
    g[i] = post[i][ty + 1 - (cy)][tx + 1 - (cx)];   \
  }
  TPULBM_THERMAL_PLANES(TPULBM_PULL)
#undef TPULBM_PULL

  // the node's own post-collision value of plane i
  const auto own = [&](int i) { return post[i][ty + 1][tx + 1]; };
  if (k.walls_x) {
#define TPULBM_X_WALLS(i, cx, cy, o)       \
  if ((cx) > 0 && x == 0) g[i] = own(o);   \
  if ((cx) < 0 && x == nx - 1) g[i] = own(o);
    TPULBM_THERMAL_PLANES(TPULBM_X_WALLS)
#undef TPULBM_X_WALLS
  }
// index of plane i among the g planes (0 for an f plane, never used)
#define G(i) ((i) >= kQf ? (i) - kQf : 0)
  // y walls: f bounce-back from the node's own post-collision values;
  // g anti-bounce-back against the just-streamed opposite (D2Q5 has one
  // inward plane per wall, so its opposite is not rewritten before use)
  if (y == 0 && k.is_bottom) {
#define TPULBM_BOTTOM(i, cx, cy, o)                    \
  if ((cy) > 0 && (i) < kQf) g[i] = own(o);            \
  if ((cy) > 0 && (i) >= kQf) g[i] = k.wall_bottom[G(i)] - g[o];
    TPULBM_THERMAL_PLANES(TPULBM_BOTTOM)
#undef TPULBM_BOTTOM
  }
  if (y == ny - 1 && k.is_top) {
#define TPULBM_TOP(i, cx, cy, o)                       \
  if ((cy) < 0 && (i) < kQf) g[i] = own(o);            \
  if ((cy) < 0 && (i) >= kQf) g[i] = k.wall_top[G(i)] - g[o];
    TPULBM_THERMAL_PLANES(TPULBM_TOP)
#undef TPULBM_TOP
  }
#undef G

  if constexpr (tpulbm::kRings) {
    const size_t cell =
        static_cast<size_t>(y - sh.y0) * sh.nxl + (x - sh.x0);
    const size_t block = static_cast<size_t>(sh.nxl) * sh.nyl;
#pragma unroll
    for (int i = 0; i < kQs; ++i) out[i * block + cell] = g[i];
  } else {
    const size_t cell = static_cast<size_t>(y) * nx + x;
#pragma unroll
    for (int i = 0; i < kQs; ++i) out[i * plane + cell] = g[i];
  }
}

// The constants of a launch, from the launcher's arrays (as in
// ThermalConsts).
ThermalConsts make_consts(const float* scalars, const float* w,
                          const float* w3, const float* ghost_bottom,
                          const float* ghost_top, const float* wall_bottom,
                          const float* wall_top, int baxis, int is_bottom,
                          int is_top, int walls_x) {
  ThermalConsts k;
  k.inv_tau = scalars[0];
  k.inv_tau_g = scalars[1];
  k.buoyancy = scalars[2];
  k.t_ref = scalars[3];
  k.smag_tau0 = scalars[4];
  k.smag_tau0_sq = scalars[5];
  k.smag_coef = scalars[6];
  for (int i = 0; i < kQs; ++i) {
    k.w[i] = w[i];
    k.ghost_bottom[i] = ghost_bottom[i];
    k.ghost_top[i] = ghost_top[i];
  }
  for (int i = 0; i < kQf; ++i) k.w3[i] = w3[i];
  for (int j = 0; j < kQg; ++j) {
    k.wall_bottom[j] = wall_bottom[j];
    k.wall_top[j] = wall_top[j];
  }
  k.baxis = baxis;
  k.is_bottom = is_bottom;
  k.is_top = is_top;
  k.walls_x = walls_x;
  return k;
}

}  // namespace

// Plain C interface, loaded with ctypes (tpulbm_torch/ops/step_thermal_cuda.py).
// Each launcher launches one step on `stream` and returns
// cudaGetLastError(): it neither synchronizes nor allocates.
// scalars = {1/tau, 1/tau_g, buoyancy, t_ref, tau0, tau0², 18 Cs²} (the
// last three read by the LES build only); w (14), w3 (9),
// ghost_bottom (14), ghost_top (14), wall_bottom (5), wall_top (5) as in
// ThermalConsts.
#if !TPULBM_RINGS
// One step of the (14, ny, nx) state `s` into `out`.
extern "C" int tpulbm_thermal_step(const float* s, float* out, int nx, int ny,
                                   const float* scalars, const float* w,
                                   const float* w3, const float* ghost_bottom,
                                   const float* ghost_top,
                                   const float* wall_bottom,
                                   const float* wall_top, int baxis,
                                   int is_bottom, int is_top, int walls_x,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ThermalConsts k =
      make_consts(scalars, w, w3, ghost_bottom, ghost_top, wall_bottom,
                  wall_top, baxis, is_bottom, is_top, walls_x);
  const dim3 block(kBX, kBY);
  const dim3 grid((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY);
  const tpulbm::Shard none{};
  thermal_step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      s, out, nx, ny, k, none);
  return static_cast<int>(cudaGetLastError());
}
#else
// One step of the shard (nxl x nyl at global x0, y0 of the nx x ny grid)
// from its (14, nyl, nxl) block `s` and its one-cell rings (rb and rt
// (14, 1, nxl + 2 hx), rl and rr (14, nyl, hx); hx 1 where the mesh cuts
// x, 0 where the block spans every column) into `out`. walls_y: the
// global rows y = 0 and ny-1 are walls (the Pallas kernel's flags[0:2] on
// the edge shards), walls_x: the global columns x = 0 and nx-1 (flags[2:4]).
extern "C" int tpulbm_thermal_step_rings(
    const float* s, float* out, const float* rb, const float* rt,
    const float* rl, const float* rr, int nx, int ny, int nxl, int nyl,
    int x0, int y0, int hx, const float* scalars, const float* w,
    const float* w3, const float* ghost_bottom, const float* ghost_top,
    const float* wall_bottom, const float* wall_top, int baxis, int walls_y,
    int walls_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hx != 0 && hx != 1) return cudaErrorInvalidValue;
  const ThermalConsts k =
      make_consts(scalars, w, w3, ghost_bottom, ghost_top, wall_bottom,
                  wall_top, baxis, walls_y, walls_y, walls_x);
  const tpulbm::Shard sh{s, rb, rt, rl, rr, nullptr, nxl, nyl,
                         x0, y0, hx, 1, 0, nyl};
  const dim3 block(kBX, kBY);
  const dim3 grid((nxl + kBX - 1) / kBX, (nyl + kBY - 1) / kBY);
  thermal_step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      s, out, nx, ny, k, sh);
  return static_cast<int>(cudaGetLastError());
}
#endif

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
