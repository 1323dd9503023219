// One fused D3Q19 timestep on an NVIDIA Hopper GPU (sm_90a), float32:
// BGK collide -> pull-stream -> ghost sanitize -> y walls -> z walls ->
// equilibrium inlet -> zero-gradient outlet -> obstacle pin. The flow past
// a sphere in a duct (problem "cylinder3d").
//
// Replaces tpulbm/ops/step_pallas3d.py::make_local_step_pallas3d (:370, the
// full-plane 1-step Pallas TPU kernel) and ::make_local_step_pallas3d_tiled
// (:745) at n_sub=1 (its y-tiled 1-step form), for the BGK collision and
// the equilibrium obstacle. Both compute one step of
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
// against about 300 floating-point operations per cell; at 256^3 that is
// 2.57 GB per step, 0.766 ms at 3.35 TB/s. So each population should cross
// device memory once each way.
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
// leftmost one, masked.
//
// Rounding follows the plain version: directions are summed in order,
// u = m * (1/rho) as tpulbm's _collide_planes_core does, and the library
// is built with -fmad=false so no multiply and add share one rounding.

#include <cuda_runtime.h>
#include <stdint.h>

// The D3Q19 velocity set in tpulbm.lattice.D3Q19's order:
// X(index, cx, cy, cz, opposite). tests/test_torch_3d.py parses this table
// and compares it with the lattice.
#define TPULBM_D3Q19(X) \
  X(0, 0, 0, 0, 0)      \
  X(1, 1, 0, 0, 2)      \
  X(2, -1, 0, 0, 1)     \
  X(3, 0, 1, 0, 4)      \
  X(4, 0, -1, 0, 3)     \
  X(5, 0, 0, 1, 6)      \
  X(6, 0, 0, -1, 5)     \
  X(7, 1, 1, 0, 8)      \
  X(8, -1, -1, 0, 7)    \
  X(9, 1, -1, 0, 10)    \
  X(10, -1, 1, 0, 9)    \
  X(11, 1, 0, 1, 12)    \
  X(12, -1, 0, -1, 11)  \
  X(13, 1, 0, -1, 14)   \
  X(14, -1, 0, 1, 13)   \
  X(15, 0, 1, 1, 16)    \
  X(16, 0, -1, -1, 15)  \
  X(17, 0, 1, -1, 18)   \
  X(18, 0, -1, 1, 17)

namespace {

constexpr int kQ = 19;
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

struct Consts {
  float inv_tau;    // 1 / tau
  float eq_in[kQ];  // frozen ghost and inlet equilibrium(rho=1, u=(U,0,0))
  float w[kQ];      // lattice weights: the rest equilibrium of solids
};

// +v, -v or nothing, by the sign of a velocity component (a literal)
#define TPULBM_SIGNED_ADD(acc, c, v) \
  if ((c) > 0) {                     \
    acc = acc + (v);                 \
  } else if ((c) < 0) {              \
    acc = acc - (v);                 \
  }

// BGK relaxation of one cell's 19 populations, in place.
__device__ __forceinline__ void collide_bgk(float* f, const Consts& k) {
  float rho = f[0];
#pragma unroll
  for (int i = 1; i < kQ; ++i) rho = rho + f[i];
  float mx = 0.0f, my = 0.0f, mz = 0.0f;
#define TPULBM_MOMENT(i, cx, cy, cz, o) \
  TPULBM_SIGNED_ADD(mx, cx, f[i])       \
  TPULBM_SIGNED_ADD(my, cy, f[i])       \
  TPULBM_SIGNED_ADD(mz, cz, f[i])
  TPULBM_D3Q19(TPULBM_MOMENT)
#undef TPULBM_MOMENT
  const float inv_rho = 1.0f / rho;
  const float ux = mx * inv_rho;
  const float uy = my * inv_rho;
  const float uz = mz * inv_rho;
  const float base = 1.0f - 1.5f * (ux * ux + uy * uy + uz * uz);
  f[0] = f[0] - k.inv_tau * (f[0] - k.w[0] * rho * base);
#define TPULBM_RELAX(i, cx, cy, cz, o)                               \
  if ((i) > 0) {                                                     \
    float cu = 0.0f;                                                 \
    TPULBM_SIGNED_ADD(cu, cx, ux)                                    \
    TPULBM_SIGNED_ADD(cu, cy, uy)                                    \
    TPULBM_SIGNED_ADD(cu, cz, uz)                                    \
    const float feq =                                                \
        k.w[i] * rho * (base + 3.0f * cu + 4.5f * cu * cu);          \
    f[i] = f[i] - k.inv_tau * (f[i] - feq);                          \
  }
  TPULBM_D3Q19(TPULBM_RELAX)
#undef TPULBM_RELAX
}

__device__ __forceinline__ int ring_index(int i, int ly, int lx) {
  return (i * kTY + ly) * kTX + lx;
}

// Pull g_i(x, y, z) = f_post_i((x, y, z) - c_i) for the cell at tile column
// tx (x), tile row ty (y), with the reference's ghost rule: a source across
// a y or z edge gives the frozen equilibrium, one across only an x edge
// gives zero, an in-domain source its collided value from the ring (planes
// z-1, z, z+1 at rm, r0, rp).
__device__ __forceinline__ void pull_d3q19(float* g, int x, int y, int z,
                                           int tx, int ty, int nx, int ny,
                                           int nz, const Consts& k,
                                           const float* rm, const float* r0,
                                           const float* rp) {
#define TPULBM_PULL(i, cx, cy, cz, o)                                      \
  {                                                                        \
    const int sx = x - (cx), sy = y - (cy), sz = z - (cz);                 \
    if (sy < 0 || sy >= ny || sz < 0 || sz >= nz) {                        \
      g[i] = k.eq_in[i];                                                   \
    } else if (sx < 0 || sx >= nx) {                                       \
      g[i] = 0.0f;                                                         \
    } else {                                                               \
      const float* r = (cz) > 0 ? rm : (cz) < 0 ? rp : r0;                 \
      g[i] = r[ring_index(i, ty + 1 - (cy), tx + 1 - (cx))];               \
    }                                                                      \
  }
  TPULBM_D3Q19(TPULBM_PULL)
#undef TPULBM_PULL
}

// The part of the boundary sequence that precedes the outlet, on the
// post-stream populations of a fluid cell at (x, y, z), in place:
// bounce-back y walls (bottom, then top), z walls (bottom, then top), each
// reading what the one before wrote, then the equilibrium inlet at x = 0.
__device__ __forceinline__ void walls_and_inlet(float* g, int x, int y, int z,
                                                int ny, int nz,
                                                const Consts& k) {
#define TPULBM_WALL(i, cx, cy, cz, o, comp, sign) \
  if ((comp) == (sign)) g[i] = g[o];
#define TPULBM_WALL_Y0(i, cx, cy, cz, o) TPULBM_WALL(i, cx, cy, cz, o, cy, 1)
#define TPULBM_WALL_Y1(i, cx, cy, cz, o) TPULBM_WALL(i, cx, cy, cz, o, cy, -1)
#define TPULBM_WALL_Z0(i, cx, cy, cz, o) TPULBM_WALL(i, cx, cy, cz, o, cz, 1)
#define TPULBM_WALL_Z1(i, cx, cy, cz, o) TPULBM_WALL(i, cx, cy, cz, o, cz, -1)
  if (y == 0) { TPULBM_D3Q19(TPULBM_WALL_Y0) }
  if (y == ny - 1) { TPULBM_D3Q19(TPULBM_WALL_Y1) }
  if (z == 0) { TPULBM_D3Q19(TPULBM_WALL_Z0) }
  if (z == nz - 1) { TPULBM_D3Q19(TPULBM_WALL_Z1) }
#undef TPULBM_WALL_Y0
#undef TPULBM_WALL_Y1
#undef TPULBM_WALL_Z0
#undef TPULBM_WALL_Z1
#undef TPULBM_WALL
  if (x == 0) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) g[i] = k.eq_in[i];
  }
}

__global__ void __launch_bounds__(kBX * kBY)
    d3q19_step_kernel(const float* __restrict__ f, float* __restrict__ out,
                      const uint8_t* __restrict__ solid, int nx, int ny,
                      int nz, Consts k) {
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
      const int gx = x0 + lx - 1;
      const int gy = y0 + ly - 1;
      if (gx < 0 || gx >= nx || gy < 0 || gy >= ny) continue;
      const size_t cell = static_cast<size_t>(z) * plane +
                          static_cast<size_t>(gy) * nx + gx;
      float v[kQ];
#pragma unroll
      for (int i = 0; i < kQ; ++i) v[i] = f[i * pop + cell];
      collide_bgk(v, k);
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
  // the outlet copies from x-1 (from x itself when nx == 1, as a roll does)
  const int dx = (x == nx - 1 && nx > 1) ? 1 : 0;

  for (int z = z0; z < z1; ++z) {
    load(z + 1, rp);
    __syncthreads();
    if (active) {
      const size_t cell = static_cast<size_t>(z) * plane +
                          static_cast<size_t>(y) * nx + x;
      float g[kQ];
      if (solid[cell]) {
        // equilibrium obstacle: solid cells are pinned to rest equilibrium
#pragma unroll
        for (int i = 0; i < kQ; ++i) g[i] = k.w[i];
      } else {
        // the outlet cell's populations are its x-1 neighbour's, as they
        // stand before the outlet; every other cell's are its own
        const int xs = x - dx;
        pull_d3q19(g, xs, y, z, tx - dx, ty, nx, ny, nz, k, rm, r0, rp);
        if (dx == 0 || !solid[cell - dx]) {
          walls_and_inlet(g, xs, y, z, ny, nz, k);
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
extern "C" int tpulbm_d3q19_step(const float* f, float* out,
                                 const uint8_t* solid, int nx, int ny, int nz,
                                 float inv_tau, const float* eq_in,
                                 const float* w, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(d3q19_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRingBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  Consts k;
  k.inv_tau = inv_tau;
  for (int i = 0; i < kQ; ++i) {
    k.eq_in[i] = eq_in[i];
    k.w[i] = w[i];
  }
  const dim3 block(kBX, kBY);
  const dim3 grid((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY,
                  (nz + kZChunk - 1) / kZChunk);
  d3q19_step_kernel<<<grid, block, kRingBytes,
                      static_cast<cudaStream_t>(stream)>>>(f, out, solid, nx,
                                                           ny, nz, k);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block of the kernel takes, in bytes.
extern "C" int tpulbm_d3q19_smem_bytes() { return kRingBytes; }

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
