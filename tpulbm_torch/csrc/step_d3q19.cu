// One fused D3Q19 timestep on an NVIDIA Hopper GPU (sm_90a), float32:
// collide (+ body-force source) -> pull-stream -> ghost sanitize -> y
// walls -> z walls, then for the flow past a sphere in a duct (problem
// "cylinder3d", the obstacle domain) -> equilibrium inlet -> zero-gradient
// outlet -> obstacle (pin or bounce-back); the Poiseuille duct (problem
// "poiseuille" with nz > 0, the channel domain) has a periodic x instead.
//
// Replaces tpulbm/ops/step_pallas3d.py::make_local_step_pallas3d (:370, the
// full-plane 1-step Pallas TPU kernel) and ::make_local_step_pallas3d_tiled
// (:745) at n_sub=1 (its y-tiled 1-step form), with their src and
// bounce_back modes and the tiled builder's periodic x (the duct), under
// each collision of _collide_planes_core (BGK, TRT, MRT, regularized,
// Smagorinsky, power law): one library per collision, domain, source and
// obstacle rule (collision_modes.cuh). Both compute one step of
// tpulbm/ops/step_jax.py::make_step_rolled; so does this kernel, cell by
// cell. Its plain version is tpulbm_torch/ops/step_torch.py.
//
// Layout: f is SoA (19, nz, ny, nx) float32 with x fastest, one plane per
// population; the stored state is tpulbm's (post-BC, pre-collision), so
// diagnostics and checkpoints read it unchanged. Population-plane offsets
// are 64-bit: at 512x512x448, 19 x cells is above 2^31.
//
// What bounds it: device-memory traffic. A step reads and writes the 19
// populations of every cell once and reads a 1-byte mask, 153 B per cell,
// against about 260 floating-point operations per cell under BGK (MRT,
// the heaviest, about 1,000); at 256^3 that is 2.57 GB per step, 0.766 ms
// at 3.35 TB/s. So each population should cross device memory once each
// way.
//
// Design: a block owns a 32 x kBY (x, y) column of cells and marches
// along z over kZChunk planes. A ring of three collided planes (z-1, z,
// z+1), each with a one-cell x/y halo, lives in dynamic shared memory:
// every step of the march loads and collides one new plane (tile + halo,
// each cell once), then every thread pulls its 19 populations for plane z
// from the ring and applies the boundary sequence in registers before the
// single store. Halo cells are re-read by the neighbouring blocks (mostly
// from L2) and collided there again: (34 x (kBY+2)) / (32 x kBY) loads
// per cell in-plane and (kZChunk+2) / kZChunk along z.
//
// The zero-gradient outlet is not cell-local: a fluid cell at x = nx-1
// takes every population of x = nx-2 as it stands after the stream and the
// y and z walls, before the obstacle pin, even when nx-2 is solid (the
// walls skip solids). The outlet thread recomputes that cell's pull from
// the ring, which needs collided values of x = nx-3 .. nx-1. The x tiles
// are therefore aligned to the right edge (block 0 holds x = nx-32 ..
// nx-1), so nx-2 and its whole x neighbourhood lie inside the block that
// holds nx-1 and no extra halo column is needed; the ragged tile is the
// leftmost one, masked. In the duct the halo columns x = -1 and x = nx are
// loaded from x = nx-1 and x = 0, so the pull wraps with no test of its
// own.
//
// The collision, the pull and the boundary sequence live in
// d3q19_common.cuh, shared with the N-step kernel (step_d3q19_blocked.cu);
// both libraries are built with -fmad=false, so one launch of that kernel
// gives the same bits as N launches of this one.

#include <cuda_runtime.h>
#include <stdint.h>

// The Bouzidi obstacle (-DTPULBM_BOUZIDI=1, tpulbm's `bz` mode of
// step_pallas3d.py:844-857): a cell whose mask byte carries kLinkBit
// rewrites its cut links after its boundary sequence (apply_bouzidi in
// d3q19_common.cuh) from its entries of the link table, read at its own
// index, and its own post-collision values in the ring's plane z.

#include "d3q19_common.cuh"

namespace {

using tpulbm3d::Consts;
using tpulbm3d::kQ;

// Tile height and z-march length: the fastest of the tilings timed on an
// H100 at 256^3 (PERF.md). 32x4 keeps the ring at 46,512 B, so four blocks
// share an SM and overlap their load and pull phases.
constexpr int kBX = 32;                // tile width: one warp per row
constexpr int kBY = 4;                 // tile height
constexpr int kZChunk = 64;            // z-planes a block marches over
constexpr int kTX = kBX + 2;           // with the x halo
constexpr int kTY = kBY + 2;           // with the y halo
constexpr int kRingPlane = kQ * kTY * kTX;
constexpr int kRingBytes = 3 * kRingPlane * 4;

__device__ __forceinline__ int ring_index(int i, int ly, int lx) {
  return (i * kTY + ly) * kTX + lx;
}

__global__ void __launch_bounds__(kBX * kBY)
    d3q19_step_kernel(const float* __restrict__ f, float* __restrict__ out,
                      const uint8_t* __restrict__ solid, int nx, int ny,
                      int nz, const __grid_constant__ Consts k,
                      tpulbm::Links links) {
  extern __shared__ float ring[];  // 3 collided planes (tile + halo)

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kBX + tx;
  const int x0 = nx - kBX * (static_cast<int>(blockIdx.x) + 1);  // right-aligned
  const int y0 = static_cast<int>(blockIdx.y) * kBY;
  const int z0 = static_cast<int>(blockIdx.z) * kZChunk;
  const int z1 = z0 + kZChunk < nz ? z0 + kZChunk : nz;
  const size_t plane = static_cast<size_t>(nx) * ny;
  const size_t pop = plane * nz;  // cells per population plane

  // Load and collide plane z (tile and in-domain halo) into ring slot r.
  // Out-of-domain cells and planes are never read: the ghost rule
  // replaces them.
  auto load = [&](int z, float* r) {
    if (z < 0 || z >= nz) return;
    for (int t = tid; t < kTX * kTY; t += kBX * kBY) {
      const int ly = t / kTX;
      const int lx = t - ly * kTX;
      int gx = x0 + lx - 1;
      const int gy = y0 + ly - 1;
      if constexpr (tpulbm3d::kPeriodicX) {
        if (gx < -1 || gx > nx || gy < 0 || gy >= ny) continue;
        gx = gx < 0 ? nx - 1 : gx >= nx ? 0 : gx;
      } else {
        if (gx < 0 || gx >= nx || gy < 0 || gy >= ny) continue;
      }
      const size_t cell = static_cast<size_t>(z) * plane +
                          static_cast<size_t>(gy) * nx + gx;
      float v[kQ];
#pragma unroll
      for (int i = 0; i < kQ; ++i) v[i] = f[i * pop + cell];
      tpulbm3d::collide_cell(
          v, k, tpulbm3d::kBounceBack && tpulbm3d::is_solid(solid[cell]));
#pragma unroll
      for (int i = 0; i < kQ; ++i) r[ring_index(i, ly, lx)] = v[i];
    }
  };

  float* rm = ring;                    // plane z-1
  float* r0 = ring + kRingPlane;       // plane z
  float* rp = ring + 2 * kRingPlane;   // plane z+1
  load(z0 - 1, rm);
  load(z0, r0);

  const int x = x0 + tx;
  const int y = y0 + ty;
  const bool active = x >= 0 && y < ny;

  for (int z = z0; z < z1; ++z) {
    load(z + 1, rp);
    __syncthreads();
    if (active) {
      const size_t cell = static_cast<size_t>(z) * plane +
                          static_cast<size_t>(y) * nx + x;
      float g[kQ];
      tpulbm3d::step_cell(
          g, [&](int ox) { return tpulbm3d::is_solid(solid[cell + ox]); }, x,
          y, z, nx, ny, nz, k, [&](auto i, int ox, int oy, int oz) {
            const float* r = oz < 0 ? rm : oz > 0 ? rp : r0;
            return r[ring_index(decltype(i)::value, ty + 1 + oy,
                                tx + 1 + ox)];
          });
      if constexpr (tpulbm3d::kBouzidi) {
        if (solid[cell] & tpulbm::kLinkBit) {
          tpulbm3d::apply_bouzidi(g, links.q + cell, links.plane,
                                  links.moving != 0, [&](auto i) {
                                    return r0[ring_index(decltype(i)::value,
                                                         ty + 1, tx + 1)];
                                  });
        }
      }
#pragma unroll
      for (int i = 0; i < kQ; ++i) out[i * pop + cell] = g[i];
    }
    __syncthreads();  // the ring slot of z-1 is reloaded next
    float* t = rm;
    rm = r0;
    r0 = rp;
    rp = t;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes (tpulbm_torch/ops/step_cuda.py).
// Launches one step on `stream` and returns cudaGetLastError() (or the
// error of raising the kernel's shared-memory limit): it neither
// synchronizes nor allocates.
// links and link_planes: the Bouzidi link table, 19 or 38 planes
// (tpulbm::Links), read by the kBouzidi build only (elsewhere null and 0).
extern "C" int tpulbm_d3q19_step(const float* f, float* out,
                                 const uint8_t* solid, int nx, int ny, int nz,
                                 float inv_tau, const float* eq_in,
                                 const float* w, const float* mode,
                                 const float* src, const float* links,
                                 int link_planes, int device, void* stream) {
  if (!tpulbm::links_fit(links, link_planes, kQ)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(d3q19_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRingBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Consts k = tpulbm3d::make_consts(inv_tau, eq_in, w, mode, src);
  const dim3 block(kBX, kBY);
  const dim3 grid((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY,
                  (nz + kZChunk - 1) / kZChunk);
  d3q19_step_kernel<<<grid, block, kRingBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      f, out, solid, nx, ny, nz, k,
      tpulbm::Links{links, static_cast<size_t>(nx) * ny * nz,
                    link_planes == 2 * kQ});
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block of the kernel takes, in bytes.
extern "C" int tpulbm_d3q19_smem_bytes() { return kRingBytes; }

// The floats of the library's mode coefficients, which the caller's array
// must hold (its mode: collision_modes.cuh's tpulbm_collision_mode).
extern "C" int tpulbm_mode_floats() { return tpulbm3d::kModeFloats; }

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
