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
// Layout: the state is SoA (9, ny, nx) float32 with x fastest. One thread
// owns one output cell, x fastest, so each plane is read and written with
// coalesced accesses. Any nx and ny run: ragged blocks at the right and top
// edges are masked, and x coordinates wrap, so grids narrower than a block
// (7x3) work too. The Pallas kernel's nx % 128 rule is a TPU layout rule.
//
// What bounds it: device-memory traffic. A step reads and writes the 9
// populations of every cell once, 72 B per cell, no mask, against about 150
// floating-point operations per cell (one expf). At 2048x512 that is 75.5 MB
// a step, 0.02254 ms at 3.35 TB/s. Unlike every other model the collision is
// not pointwise: a cell's force needs ψ of its 8 neighbours, and the pull
// needs the post-collision values of a 1-cell ring, so an output tile needs
// ψ on a 2-cell ring. A 32x8 block therefore loads its tile plus a 2-cell
// ring of all 9 planes once (36x12 cells; x wrapped, rows outside the
// domain never read), computes ρ and ψ of every loaded cell into shared
// memory, collides the tile plus a 1-cell ring in place (each cell reads
// only its own populations and its neighbours' ψ), and pulls from shared
// memory before the single store. Shared memory: 15,552 B of populations
// and 1,728 B of ψ. Ring cells are re-read by the neighbouring blocks
// (mostly from L2) and collided there again: 1.69 loads per output cell.
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
// the port's one-step tolerance, rtol 5e-6 / atol 1e-7, not bitwise (on an
// H100 80GB HBM3 at 700 W: 1.1e-8 from the initial droplet, at most 2.4e-7
// after 500 plain steps, 2048x512 to 7x3).
//
// Built with -DTPULBM_RINGS=1 the kernel steps one shard of a mesh
// (tpulbm_multiphase_step_rings): the shard's block and the pre-collision
// rings its neighbours sent, two cells deep (tpulbm::Shard, depth 2): rb
// and rt the rows below and above, rl and rr the columns beside it where
// the mesh cuts x (tpulbm's x_halo mode, :135-145: ψ's stencil consumes
// one ring column and the pull the other). The tile keeps global
// coordinates: a window cell in the domain is loaded from the block or the
// ring that holds it (Shard::locate; where the block spans every column, x
// wraps inside it), rows beyond a y wall hold the wall's ψ, and the walls
// act at the global rows y = 0 and ny-1 only. So a shard's cells get the
// bits of the one-device build. The rings add 2 (2 (nxl + 2 hx) + hx nyl)
// x 36 B a launch to the 72 B a cell.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "d2q9_common.cuh"

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
constexpr int kBX = 32;          // block width (cells along x): one warp a row
constexpr int kBY = 8;           // block height (rows)
constexpr int kRing = 2;         // ψ ring; populations are collided on 1
constexpr int kLX = kBX + 2 * kRing;
constexpr int kLY = kBY + 2 * kRing;

struct MultiphaseConsts {
  float inv_tau;   // 1 / tau
  float tau;       // 1 / (1 / tau), the plain step's velocity-shift factor
  float neg_g;     // -g
  float rho0;      // ψ's saturation density
  float wall_psi;  // ψ of the phantom wall fluid
  float w[kQ];     // lattice weights
};

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

__device__ __forceinline__ float psi_of(float rho, const MultiphaseConsts& k) {
  return k.rho0 * (1.0f - expf(-rho / k.rho0));
}

__global__ void __launch_bounds__(kBX * kBY)
    multiphase_step_kernel(const float* __restrict__ f,
                           float* __restrict__ out, int nx, int ny,
                           MultiphaseConsts k, tpulbm::Shard sh) {
  // populations of the tile and ring: pre-collision, then (on the tile and
  // its 1-cell ring) post-collision in place
  __shared__ float pop[kQ][kLY][kLX];
  __shared__ float psi[kLY][kLX];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kBX + tx;
  // global coordinates of the tile's first cell
  const int x0 = (tpulbm::kRings ? sh.x0 : 0) + blockIdx.x * kBX;
  const int y0 = (tpulbm::kRings ? sh.y0 : 0) + blockIdx.y * kBY;
  const size_t plane = static_cast<size_t>(nx) * ny;

  // Load the tile and its 2-cell ring; ψ of every loaded cell, the wall's
  // ψ on rows outside the domain (whose populations are never read). A
  // shard's window cells beyond its rings feed no cell of the block and
  // are skipped.
  for (int t = tid; t < kLX * kLY; t += kBX * kBY) {
    const int ly = t / kLX;
    const int lx = t - ly * kLX;
    const int gy = y0 + ly - kRing;
    if (gy < 0 || gy >= ny) {
      psi[ly][lx] = k.wall_psi;
      continue;
    }
    const float* src;
    size_t stride;
    if constexpr (tpulbm::kRings) {
      int bx = x0 + lx - kRing - sh.x0;
      const int by = gy - sh.y0;
      if (by < -kRing || by >= sh.nyl + kRing) continue;
      if (sh.hx == 0) {
        bx = wrap(bx, sh.nxl);
      } else if (bx < -kRing || bx >= sh.nxl + kRing) {
        continue;
      }
      src = sh.locate(bx, by, stride);
    } else {
      src = f + static_cast<size_t>(gy) * nx + wrap(x0 + lx - kRing, nx);
      stride = plane;
    }
    float rho = 0.0f;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const float v = src[i * stride];
      pop[i][ly][lx] = v;
      rho = i == 0 ? v : rho + v;
    }
    psi[ly][lx] = psi_of(rho, k);
  }
  __syncthreads();

  // Collide the tile and its 1-cell ring, rows inside the domain only.
  constexpr int kCX = kLX - 2;
  constexpr int kCY = kLY - 2;
  for (int t = tid; t < kCX * kCY; t += kBX * kBY) {
    const int ly = t / kCX + 1;
    const int lx = t - (ly - 1) * kCX + 1;
    const int gy = y0 + ly - kRing;
    if (gy < 0 || gy >= ny) continue;
    float v[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) v[i] = pop[i][ly][lx];
    float rho = v[0];
#pragma unroll
    for (int i = 1; i < kQ; ++i) rho = rho + v[i];
    const float mx = v[1] - v[3] + v[5] - v[6] - v[7] + v[8];
    const float my = v[2] - v[4] + v[5] + v[6] - v[7] - v[8];
    // Σ_i w_i c_i ψ(x + c_i), per component in tpulbm's i order; a term
    // with c = -1 is subtracted, which rounds as adding (-w_i) ψ does
    const auto nb = [&](int cx, int cy) { return psi[ly + cy][lx + cx]; };
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
    const float gpsi = k.neg_g * psi[ly][lx];
    const float fx = gpsi * sx;
    const float fy = gpsi * sy;
    // velocity shift: u = m/ρ + (τ F)/ρ, then BGK toward equilibrium(ρ, u)
    const tpulbm::Moments m = {rho, mx / rho + k.tau * fx / rho,
                               my / rho + k.tau * fy / rho};
    tpulbm::relax_bgk(v, m, k.inv_tau, k.w);
#pragma unroll
    for (int i = 0; i < kQ; ++i) pop[i][ly][lx] = v[i];
  }
  __syncthreads();

  const int x = x0 + tx;
  const int y = y0 + ty;
  if constexpr (tpulbm::kRings) {
    if (x - sh.x0 >= sh.nxl || y - sh.y0 >= sh.nyl) return;
  } else {
    if (x >= nx || y >= ny) return;
  }
  const int ly = ty + kRing;
  const int lx = tx + kRing;

  // pull out_i(x, y) = post_i((x, y) - c_i), x wrapped; at a wall row the
  // inward populations take the node's own post-collision opposite
  float g[kQ];
#define TPULBM_PULL(i, cx, cy, o)                             \
  if (((cy) > 0 && y == 0) || ((cy) < 0 && y == ny - 1)) {    \
    g[i] = pop[o][ly][lx];                                    \
  } else {                                                    \
    g[i] = pop[i][ly - (cy)][lx - (cx)];                      \
  }
  TPULBM_MP_DIRS(TPULBM_PULL)
#undef TPULBM_PULL

  if constexpr (tpulbm::kRings) {
    const size_t cell =
        static_cast<size_t>(y - sh.y0) * sh.nxl + (x - sh.x0);
    const size_t block = static_cast<size_t>(sh.nxl) * sh.nyl;
#pragma unroll
    for (int i = 0; i < kQ; ++i) out[i * block + cell] = g[i];
  } else {
    const size_t cell = static_cast<size_t>(y) * nx + x;
#pragma unroll
    for (int i = 0; i < kQ; ++i) out[i * plane + cell] = g[i];
  }
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
  const MultiphaseConsts k = make_consts(scalars, w);
  const dim3 block(kBX, kBY);
  const dim3 grid((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY);
  const tpulbm::Shard none{};
  multiphase_step_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(f, out, nx,
                                                                ny, k, none);
  return static_cast<int>(cudaGetLastError());
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
  const MultiphaseConsts k = make_consts(scalars, w);
  const tpulbm::Shard sh{f, rb, rt, rl, rr, nullptr, nxl, nyl,
                         x0, y0, hx, kRing, 0, nyl};
  const dim3 block(kBX, kBY);
  const dim3 grid((nxl + kBX - 1) / kBX, (nyl + kBY - 1) / kBY);
  multiphase_step_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(f, out, nx,
                                                                ny, k, sh);
  return static_cast<int>(cudaGetLastError());
}
#endif

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
