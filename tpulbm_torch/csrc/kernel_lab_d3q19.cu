// The D3Q19 phase lab on an NVIDIA Hopper GPU (sm_90a), float32: one step
// of a mask-free D3Q19 duct with the phases of the 1-step kernel's z-march
// (step_d3q19.cu) switched on and off, so that timing the five variants
// splits a step's time into memory traffic, collide, stream and boundary
// conditions. A diagnostic: no run of the port launches it.
//
// Replaces scripts/kernel_lab.py::make_lab_kernel (:56, its pallas_call
// :223), tpulbm's Pallas lab over the y-tiled slab pipeline, and computes
// what it computes: over a state padded by H = 8 rows above and below in
// y, (19, nz, ny + 2H, nx), it writes the rows [H, H + ny) only, from
//   dma:     the input (a copy);
//   collide: BGK at tau = 0.6 (d3q19_common.cuh's collide_cell);
//   stream:  the pull from (z - cz, y - cy, (x - cx) mod nx), the frozen
//            inlet equilibrium (rho 1, u = (0.05, 0, 0)) where z - cz
//            leaves [0, nz); y - cy reads the pad rows H - 1 and H + ny;
//   bcs:     tpulbm's strip ops in its order: per population the x-edge
//            sanitize and the y-wall copy at global rows 0 and ny - 1
//            (reading the opposite population as the loop has left it),
//            then the z walls at z = 0 and nz - 1, then the equilibrium
//            inlet at x = 0 and the zero-gradient outlet x = nx - 1 <-
//            nx - 2;
//   full:    collide, stream and bcs in that order.
// Its plain version is tpulbm_torch/utils/kernel_lab.py::plain_lab.
//
// Design: step_d3q19.cu's geometry. A block owns a 32 x 4 (x, y) column of
// output cells, right-aligned so that the block holding x = nx - 1 holds
// x = nx - 3 .. nx - 1, and marches z over 64 planes; every march step
// loads one plane over the tile (with the variants that stream, plus a
// one-cell halo, x wrapped, into a ring of three planes z - 1, z, z + 1),
// collides it in place where the variant collides, and after a barrier each
// thread gathers its cell's 19 populations from the ring, applies the
// boundary ops in registers and stores them once. The x-edge sanitize of
// the strip ops only writes cells that the inlet and the outlet then
// overwrite whole (x = 0 with the equilibrium, x = nx - 1 with x = nx - 2,
// where no sanitize applies), so the kernel leaves it out and the outlet
// cell recomputes x = nx - 2's populations: the bits are the same. A z edge
// reads no ring slot: the equilibrium takes its place.
//
// What bounds it: device-memory traffic, 152 B per cell (19 f32 read and
// written once): 0.761 ms at 256^3 over 3.35 TB/s. The variants' times
// against that bound and against each other say what each phase costs in
// the production kernel's geometry; the halo loads of the variants that
// stream (34 x 6 cells for 32 x 4, 66 planes for 64) are part of them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d3q19_common.cuh"

namespace {

using tpulbm3d::Consts;
using tpulbm3d::kQ;

static_assert(kQ == 19, "the lab steps D3Q19");

constexpr int kPad = 8;      // H: pad rows above and below in y
constexpr int kBX = 32;      // tile width: one warp per row
constexpr int kBY = 4;       // tile height (the JSON lines' "ty")
constexpr int kZChunk = 64;  // z-planes a block marches over

// The variants, in kernel_lab.py's VARIANTS order.
enum Variant : int {
  kDma = 0,
  kCollide = 1,
  kStream = 2,
  kBcs = 3,
  kFull = 4
};

template <bool kDoStream>
struct Ring {
  static constexpr int kHalo = kDoStream ? 1 : 0;
  static constexpr int kTX = kBX + 2 * kHalo;
  static constexpr int kTY = kBY + 2 * kHalo;
  static constexpr int kSlots = kDoStream ? 3 : 1;
  static constexpr int kPlane = kQ * kTY * kTX;
  static constexpr size_t kBytes = sizeof(float) * kSlots * kPlane;
  __device__ static int at(int i, int ly, int lx) {
    return (i * kTY + ly) * kTX + lx;
  }
};

template <bool kDoCollide, bool kDoStream, bool kDoBcs>
__global__ void __launch_bounds__(kBX * kBY)
    lab_kernel(const float* __restrict__ f, float* __restrict__ out, int nx,
               int ny, int nz, const __grid_constant__ Consts k) {
  using R = Ring<kDoStream>;
  extern __shared__ float ring[];

  const int tx = threadIdx.x % kBX;
  const int ty = threadIdx.x / kBX;
  const int x0 = nx - kBX * (static_cast<int>(blockIdx.x) + 1);
  const int y0 = static_cast<int>(blockIdx.y) * kBY;
  const int z0 = static_cast<int>(blockIdx.z) * kZChunk;
  const int z1 = z0 + kZChunk < nz ? z0 + kZChunk : nz;
  const int rows = ny + 2 * kPad;
  const size_t plane = static_cast<size_t>(rows) * nx;
  const size_t pop = plane * nz;

  // Load plane z over the tile (and halo), collided where the variant
  // collides, into ring slot r. x wraps; y reaches the pad rows.
  auto load = [&](int z, float* r) {
    for (int t = threadIdx.x; t < R::kTX * R::kTY; t += kBX * kBY) {
      const int ly = t / R::kTX;
      const int lx = t - ly * R::kTX;
      int gx = x0 + lx - R::kHalo;
      const int gy = y0 + ly - R::kHalo;
      if (gy > ny || (R::kHalo == 0 && (gy >= ny || gx < 0))) continue;
      gx %= nx;
      if (gx < 0) gx += nx;
      const size_t cell = static_cast<size_t>(z) * plane +
                          static_cast<size_t>(gy + kPad) * nx + gx;
      float v[kQ];
#pragma unroll
      for (int i = 0; i < kQ; ++i) v[i] = f[i * pop + cell];
      if constexpr (kDoCollide) tpulbm3d::collide_cell(v, k, false);
#pragma unroll
      for (int i = 0; i < kQ; ++i) r[R::at(i, ly, lx)] = v[i];
    }
  };

  float* rm = ring;  // plane z-1 (kDoStream)
  float* r0 = ring + (kDoStream ? R::kPlane : 0);  // plane z
  float* rp = ring + 2 * R::kPlane;  // plane z+1 (kDoStream)
  if constexpr (kDoStream) {
    if (z0 > 0) load(z0 - 1, rm);
    load(z0, r0);
  }

  const int x = x0 + tx;
  const int y = y0 + ty;
  const bool active = x >= 0 && y < ny;
  // the outlet cell takes x = nx - 2's populations: gather them
  const int dx = kDoBcs && x == nx - 1 ? -1 : 0;

  for (int z = z0; z < z1; ++z) {
    if constexpr (kDoStream) {
      if (z + 1 < nz) load(z + 1, rp);
    } else {
      load(z, r0);
    }
    __syncthreads();
    if (active) {
      float g[kQ];
      if (kDoBcs && x == 0) {
#pragma unroll
        for (int i = 0; i < kQ; ++i) g[i] = k.eq_in[i];
      } else {
        const int lx = tx + R::kHalo + dx;
        const int ly = ty + R::kHalo;
#define TPULBM_GATHER(i, cx, cy, cz, o)                                    \
  if constexpr (kDoStream) {                                               \
    if ((cz) != 0 && (z - (cz) < 0 || z - (cz) >= nz)) {                   \
      g[i] = k.eq_in[i];                                                   \
    } else {                                                               \
      const float* r = (cz) > 0 ? rm : (cz) < 0 ? rp : r0;                 \
      g[i] = r[R::at(i, ly - (cy), lx - (cx))];                            \
    }                                                                      \
  } else {                                                                 \
    g[i] = r0[R::at(i, ly, lx)];                                           \
  }
        TPULBM_D3Q19(TPULBM_GATHER)
#undef TPULBM_GATHER
        if constexpr (kDoBcs) {
          // the y walls, population by population, each copy reading the
          // opposite population as the loop has left it; then the z walls
#define TPULBM_YWALL(i, cx, cy, cz, o)           \
  if (((cy) > 0 && y == 0) || ((cy) < 0 && y == ny - 1)) g[i] = g[o];
          TPULBM_D3Q19(TPULBM_YWALL)
#undef TPULBM_YWALL
#define TPULBM_ZWALL0(i, cx, cy, cz, o) \
  if ((cz) > 0) g[i] = g[o];
#define TPULBM_ZWALL1(i, cx, cy, cz, o) \
  if ((cz) < 0) g[i] = g[o];
          if (z == 0) { TPULBM_D3Q19(TPULBM_ZWALL0) }
          if (z == nz - 1) { TPULBM_D3Q19(TPULBM_ZWALL1) }
#undef TPULBM_ZWALL0
#undef TPULBM_ZWALL1
        }
      }
      const size_t cell = static_cast<size_t>(z) * plane +
                          static_cast<size_t>(y + kPad) * nx + x;
#pragma unroll
      for (int i = 0; i < kQ; ++i) out[i * pop + cell] = g[i];
    }
    __syncthreads();  // the ring slot read here is reloaded next
    if constexpr (kDoStream) {
      float* t = rm;
      rm = r0;
      r0 = rp;
      rp = t;
    }
  }
}

template <bool kDoCollide, bool kDoStream, bool kDoBcs>
cudaError_t launch(const float* f, float* out, int nx, int ny, int nz,
                   const Consts& k, cudaStream_t stream) {
  constexpr size_t smem = Ring<kDoStream>::kBytes;
  static_assert(smem <= 48 * 1024, "the lab's ring fits 48 KB");
  const dim3 grid((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY,
                  (nz + kZChunk - 1) / kZChunk);
  lab_kernel<kDoCollide, kDoStream, kDoBcs><<<grid, kBX * kBY, smem,
                                              stream>>>(f, out, nx, ny, nz,
                                                        k);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes (tpulbm_torch/utils/kernel_lab.py).
// One lab step of `variant` (0 dma, 1 collide, 2 stream, 3 bcs, 4 full) of
// the padded (19, nz, ny + 16, nx) f into the rows [8, 8 + ny) of out, on
// `stream`; eq_in is the inlet equilibrium, w the weights. Returns
// cudaGetLastError(); neither synchronizes nor allocates.
extern "C" int tpulbm_kernel_lab_d3q19(const float* f, float* out, int nx,
                                       int ny, int nz, int variant,
                                       float inv_tau, const float* eq_in,
                                       const float* w, int device,
                                       void* stream) {
  if (nx < 3 || ny < 1 || nz < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float no_mode[tpulbm3d::kModeFloats] = {};
  const Consts k = tpulbm3d::make_consts(inv_tau, eq_in, w, no_mode);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kDma: err = launch<false, false, false>(f, out, nx, ny, nz, k, s);
      break;
    case kCollide: err = launch<true, false, false>(f, out, nx, ny, nz, k, s);
      break;
    case kStream: err = launch<false, true, false>(f, out, nx, ny, nz, k, s);
      break;
    case kBcs: err = launch<false, false, true>(f, out, nx, ny, nz, k, s);
      break;
    case kFull: err = launch<true, true, true>(f, out, nx, ny, nz, k, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The pad rows (H) and the output tile's height, as the wrapper reads
// them.
extern "C" int tpulbm_kernel_lab_pad() { return kPad; }
extern "C" int tpulbm_kernel_lab_tile_y() { return kBY; }

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
