// One fused D3Q19 or D3Q27 timestep on an NVIDIA Hopper GPU (sm_90a),
// float32: collide (+ body-force source, + the force profile's source along
// z) -> pull-stream -> ghost sanitize -> y walls -> z walls, then for the
// flow past a sphere in a duct (problem "cylinder3d", the obstacle domain)
// -> equilibrium inlet -> zero-gradient outlet -> obstacle (pin or
// bounce-back); the Poiseuille duct (problem "poiseuille" with nz > 0, the
// channel domain) has a periodic x instead, and the fully periodic box
// (problems "taylor-green" and "kolmogorov" with nz > 0, the box domain)
// wraps x, y and z and has no ghost and no wall.
//
// Replaces tpulbm/ops/step_pallas3d.py::make_local_step_pallas3d (:370, the
// full-plane 1-step Pallas TPU kernel) and ::make_local_step_pallas3d_tiled
// (:745) at n_sub=1 (its y-tiled 1-step form), with their src and
// bounce_back modes, the tiled builder's periodic x (the duct), their
// fully periodic boxes (the wrapped z ring planes zb/zt, :380-404, :447)
// and force_fn (:81-139: here a table of the source per z), on either
// velocity set, under each collision of _collide_planes_core (BGK, TRT,
// MRT, regularized, Smagorinsky, power law; no MRT on D3Q27): one library
// per collision, domain, source, force profile, obstacle rule and lattice
// (collision_modes.cuh). Both compute one step of
// tpulbm/ops/step_jax.py::make_step_rolled; so does this kernel, cell by
// cell. Its plain version is tpulbm_torch/ops/step_torch.py.
//
// Layout: f is SoA (Q, nz, ny, nx) float32 with x fastest, one plane per
// population; the stored state is tpulbm's (post-BC, pre-collision), so
// diagnostics and checkpoints read it unchanged. Population-plane offsets
// are 64-bit: at 512x512x448, 19 x cells is above 2^31.
//
// What bounds it: device-memory traffic. A step reads and writes the 19
// populations of every cell once and reads a 1-byte mask, 153 B per cell,
// against about 260 floating-point operations per cell under BGK (MRT,
// the heaviest, about 1,000); at 256^3 that is 2.57 GB per step, 0.766 ms
// at 3.35 TB/s (D3Q27: 217 B, 1.09 ms). So each population should cross
// device memory once each way.
//
// Design: a block owns a 32 x kBY (x, y) column of cells and marches
// along z over kZChunk planes. A ring of three collided planes (z-1, z,
// z+1), each with a one-cell x/y halo, lives in dynamic shared memory:
// every step of the march loads and collides one new plane (tile + halo,
// each cell once), then every thread pulls its Q populations for plane z
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
// own; in the box the halo rows y = -1, y = ny and the planes z = -1,
// z = nz are loaded from y = ny-1, 0 and z = nz-1, 0 the same way (tpulbm's
// wrapped ring planes zb/zt), so the ring holds the wrapped neighbours and
// the pull reads them like any other.
//
// The force profile (-DTPULBM_FORCE=1, 3-D Kolmogorov's F_x(z)): `force` is
// the (Q, nz) table of its source S_i(z) = 3 w_i (c_i . F(z)) on the card;
// every cell of plane z, halo cells included, adds column z mod nz after
// its collision (collide_cell), so the N-step kernel, which adds the same
// column at every substep, gives the same bits.
//
// Built with -DTPULBM_RINGS=1 the kernel steps one shard of a mesh
// (tpulbm3d::Shard): make_local_step_pallas3d_tiled at n_sub=1 with its
// ring inputs rb/rt and, on a mesh that cuts x (x_halo), rl/rr. The tiles
// cover the shard's block, right-aligned to its last column, so the shard
// that holds x = nx-1 holds the outlet's neighbourhood; the tile and halo
// cells are loaded through find() and locate() from the block or its
// rings, and every cell keeps its global coordinates, so the shard's
// cells take the bits one device gives them. Its plain version is
// tpulbm_torch/ops/step_rings_torch.py.
//
// The collision, the pull and the boundary sequence live in
// d3q19_common.cuh, shared with the N-step kernel (step_d3q19_blocked.cu);
// both libraries are built with -fmad=false, so one launch of that kernel
// gives the same bits as N launches of this one.

#include <cuda_runtime.h>
#include <stdint.h>

// The Bouzidi obstacle (-DTPULBM_BOUZIDI=1, tpulbm's `bz` mode of
// step_pallas3d.py:844-857, on either velocity set): a cell whose mask
// byte carries kLinkBit rewrites its cut links after its boundary sequence
// (apply_bouzidi in d3q19_common.cuh) from its entries of the link table
// (Q planes, 2Q for a moving wall), read at its own index, and its own
// post-collision values in the ring's plane z.

#include "d3q19_common.cuh"

namespace {

using tpulbm3d::Consts;
using tpulbm3d::kQ;

// Tile height and z-march length: the fastest of the tilings timed on an
// H100 at 256^3 (PERF.md). 32x4 keeps the ring at 46,512 B (D3Q27:
// 66,096 B), so four blocks (D3Q27: three) share an SM and overlap their
// load and pull phases.
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
                      const uint8_t* __restrict__ solid,
                      const float* __restrict__ force, int nx, int ny,
                      int nz, const __grid_constant__ Consts k,
                      tpulbm::Links links,
                      const __grid_constant__ tpulbm3d::Shard sh) {
  extern __shared__ float ring[];  // 3 collided planes (tile + halo)

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kBX + tx;
  // the tile's global origin, right-aligned to the last column of the grid
  // (of the shard's block in a rings build)
  const int x0 = (tpulbm::kRings ? sh.x0 + sh.nxl : nx) -
                 kBX * (static_cast<int>(blockIdx.x) + 1);
  const int y0 = (tpulbm::kRings ? sh.y0 : 0) +
                 static_cast<int>(blockIdx.y) * kBY;
  const int z0 = static_cast<int>(blockIdx.z) * kZChunk;
  const int z1 = z0 + kZChunk < nz ? z0 + kZChunk : nz;
  const size_t plane = static_cast<size_t>(nx) * ny;
  const size_t pop = plane * nz;  // cells per population plane

  // Load and collide plane z (tile and in-domain halo) into ring slot r.
  // Out-of-domain cells and planes are never read: the ghost rule
  // replaces them; periodic axes load the wrapped cell instead.
  auto load = [&](int z, float* r) {
    if constexpr (tpulbm3d::kPeriodicZ) {
      z = z < 0 ? nz - 1 : z >= nz ? 0 : z;
    } else {
      if (z < 0 || z >= nz) return;
    }
    for (int t = tid; t < kTX * kTY; t += kBX * kBY) {
      const int ly = t / kTX;
      const int lx = t - ly * kTX;
      int gx = x0 + lx - 1;
      int gy = y0 + ly - 1;
      if constexpr (tpulbm::kRings) {
        int bx, by;
        if (!sh.find(gx, gy, nx, ny, bx, by)) continue;
        size_t stride;
        const float* src = sh.locate(bx, by, z, stride);
        float v[kQ];
#pragma unroll
        for (int i = 0; i < kQ; ++i) v[i] = src[i * stride];
        tpulbm3d::collide_cell(
            v, k,
            tpulbm3d::kBounceBack &&
                tpulbm3d::is_solid(sh.mask[sh.padded(bx, by, z)]),
            force + z, nz);
#pragma unroll
        for (int i = 0; i < kQ; ++i) r[ring_index(i, ly, lx)] = v[i];
        continue;
      }
      if constexpr (tpulbm3d::kPeriodicX) {
        if (gx < -1 || gx > nx) continue;
        gx = gx < 0 ? nx - 1 : gx >= nx ? 0 : gx;
      } else {
        if (gx < 0 || gx >= nx) continue;
      }
      if constexpr (tpulbm3d::kPeriodicY) {
        if (gy < -1 || gy > ny) continue;
        gy = gy < 0 ? ny - 1 : gy >= ny ? 0 : gy;
      } else {
        if (gy < 0 || gy >= ny) continue;
      }
      const size_t cell = static_cast<size_t>(z) * plane +
                          static_cast<size_t>(gy) * nx + gx;
      float v[kQ];
#pragma unroll
      for (int i = 0; i < kQ; ++i) v[i] = f[i * pop + cell];
      tpulbm3d::collide_cell(
          v, k, tpulbm3d::kBounceBack && tpulbm3d::is_solid(solid[cell]),
          force + z, nz);
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
  const bool active = tpulbm::kRings ? sh.writes(x - sh.x0, y - sh.y0)
                                     : x >= 0 && y < ny;

  for (int z = z0; z < z1; ++z) {
    load(z + 1, rp);
    __syncthreads();
    if (tpulbm::kRings && active) {
      const int bx = x - sh.x0;
      const int by = y - sh.y0;
      float g[kQ];
      tpulbm3d::step_cell(
          g,
          [&](int ox) {
            return tpulbm3d::is_solid(sh.mask[sh.padded(bx + ox, by, z)]);
          },
          x, y, z, nx, ny, nz, k, [&](auto i, int ox, int oy, int oz) {
            const float* r = oz < 0 ? rm : oz > 0 ? rp : r0;
            return r[ring_index(decltype(i)::value, ty + 1 + oy,
                                tx + 1 + ox)];
          });
      if constexpr (tpulbm3d::kBouzidi) {
        const size_t at = sh.padded(bx, by, z);
        if (sh.mask[at] & tpulbm::kLinkBit) {
          tpulbm3d::apply_bouzidi(g, links.q + at, links.plane,
                                  links.moving != 0, [&](auto i) {
                                    return r0[ring_index(decltype(i)::value,
                                                         ty + 1, tx + 1)];
                                  });
        }
      }
      const size_t cell = sh.cell(bx, by, z);
      const size_t block = static_cast<size_t>(sh.nz) * sh.nyl * sh.nxl;
#pragma unroll
      for (int i = 0; i < kQ; ++i) out[i * block + cell] = g[i];
    } else if (!tpulbm::kRings && active) {
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
// Each launcher launches one step on `stream` and returns
// cudaGetLastError() (or the error of raising the kernel's shared-memory
// limit): it neither synchronizes nor allocates.
// links and link_planes: the Bouzidi link table, 19 or 38 planes
// (tpulbm::Links), read by the kBouzidi build only (elsewhere null and 0).
// force: the force profile's (Q, nz) table on the card, read by the kForce
// build only (elsewhere null). The host arrays eq_in, w and src hold Q
// floats.
#if !TPULBM_RINGS
extern "C" int tpulbm_d3q19_step(const float* f, float* out,
                                 const uint8_t* solid, int nx, int ny, int nz,
                                 float inv_tau, const float* eq_in,
                                 const float* w, const float* mode,
                                 const float* src, const float* force,
                                 const float* links, int link_planes,
                                 int device, void* stream) {
  if (!tpulbm::links_fit(links, link_planes, kQ)) return cudaErrorInvalidValue;
  if ((force != nullptr) != tpulbm::kForce) return cudaErrorInvalidValue;
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
      f, out, solid, force, nx, ny, nz, k,
      tpulbm::Links{links, static_cast<size_t>(nx) * ny * nz,
                    link_planes == 2 * kQ},
      tpulbm3d::Shard{});
  return static_cast<int>(cudaGetLastError());
}
#else
// One step of the shard (nxl x nyl at global x0, y0 of the nx x ny grid,
// every one of the nz planes) from f and its rings (depth 1; hx 0 or 1, as
// tpulbm3d::Shard describes them) into out. mask is the shard's kernel mask
// padded by one row and column, and links its cut of the link table padded
// the same way.
extern "C" int tpulbm_d3q19_step_rings(
    const float* f, float* out, const uint8_t* mask, const float* rb,
    const float* rt, const float* rl, const float* rr, int nx, int ny,
    int nz, int nxl, int nyl, int x0, int y0, int hx, float inv_tau,
    const float* eq_in, const float* w, const float* mode, const float* src,
    const float* force, const float* links, int link_planes, int device,
    void* stream) {
  if (!tpulbm::links_fit(links, link_planes, kQ)) return cudaErrorInvalidValue;
  if ((force != nullptr) != tpulbm::kForce) return cudaErrorInvalidValue;
  if (nxl < 1 || nyl < 1 || (hx != 0 && hx != 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(d3q19_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRingBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Consts k = tpulbm3d::make_consts(inv_tau, eq_in, w, mode, src);
  const tpulbm3d::Shard sh{f, rb, rt, rl, rr, mask, nxl, nyl, nz,
                           x0, y0, hx, 1};
  const dim3 block(kBX, kBY);
  const dim3 grid((nxl + kBX - 1) / kBX, (nyl + kBY - 1) / kBY,
                  (nz + kZChunk - 1) / kZChunk);
  d3q19_step_kernel<<<grid, block, kRingBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      f, out, nullptr, force, nx, ny, nz, k,
      tpulbm::Links{links, static_cast<size_t>(nz) * (nyl + 2) * (nxl + 2),
                    link_planes == 2 * kQ},
      sh);
  return static_cast<int>(cudaGetLastError());
}
#endif

// The dynamic shared memory a block of the kernel takes, in bytes.
extern "C" int tpulbm_d3q19_smem_bytes() { return kRingBytes; }

// The floats of the library's mode coefficients, which the caller's array
// must hold (its mode: collision_modes.cuh's tpulbm_collision_mode).
extern "C" int tpulbm_mode_floats() { return tpulbm3d::kModeFloats; }

// The populations of the library's velocity set (19 or 27).
extern "C" int tpulbm_lattice_q() { return kQ; }

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
