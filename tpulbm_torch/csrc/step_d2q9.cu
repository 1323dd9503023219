// One fused D2Q9 timestep on an NVIDIA Hopper GPU (sm_90a), float32:
// BGK collide -> pull-stream -> ghost sanitize -> y walls -> Zou-He inlet
// -> Zou-He outlet -> obstacle pin.
//
// Replaces tpulbm/ops/step_pallas.py::make_local_step_pallas (the fused
// 1-step Pallas TPU kernel), for the BGK collision and the equilibrium
// obstacle. Its plain version is tpulbm_torch/ops/step_torch.py.
//
// Layout: f is SoA (9, ny, nx) float32 with x fastest, one plane per
// population. One thread owns one cell, x fastest, so each plane is read
// and written with coalesced accesses. Any nx and ny run: the ragged
// blocks at the right and top edges are masked, no padding is needed.
//
// What bounds it: device-memory traffic. A step has to read and write the
// 9 populations of every cell once, 72 B per cell (plus 1 B of solid mask),
// against about 200 floating-point operations per cell. That is far below
// the card's ratio of compute to bandwidth, so the kernel is written to
// touch each population once in device memory: a block loads its tile and
// a one-cell halo, collides every loaded cell once in registers, keeps the
// post-collision values in shared memory for the pull, and applies every
// boundary condition in registers before the single store. The halo cells
// are re-read by the neighbouring blocks (mostly from L2) and collided
// there again; that recomputation is cheap next to a second pass through
// device memory.
//
// Every boundary condition of this configuration is cell-local: it reads
// only the post-stream values of its own cell. So the TPU kernel's slab
// ring, lane padding and VMEM sizing have no counterpart here.
//
// Rounding follows the plain version: the expression order below is the
// reference's, and the library is built with -fmad=false so no multiply
// and add are fused into one rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 9;
constexpr int kBX = 32;  // block width (cells along x): one warp per row
constexpr int kBY = 8;   // block height (rows)
constexpr int kTX = kBX + 2;
constexpr int kTY = kBY + 2;

struct StepConsts {
  float inv_tau;         // 1 / tau
  float u_in;            // inlet velocity
  float one_minus_u_in;  // 1 - u_in, rounded once on the host
  float eq_in[kQ];       // frozen ghost equilibrium(rho=1, u=(u_in, 0))
  float w[kQ];           // lattice weights: the rest equilibrium of solids
};

// BGK relaxation of one cell's 9 populations, in place.
__device__ __forceinline__ void collide_bgk(float* f, const StepConsts& k) {
  float rho = f[0];
#pragma unroll
  for (int i = 1; i < kQ; ++i) rho = rho + f[i];
  const float mx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8];
  const float my = f[2] - f[4] + f[5] + f[6] - f[7] - f[8];
  const float inv_rho = 1.0f / rho;
  const float ux = mx * inv_rho;
  const float uy = my * inv_rho;
  const float base = 1.0f - 1.5f * (ux * ux + uy * uy);
  // c_i . u for i = 1..8, as exact +-adds
  const float cu[kQ] = {0.0f, ux, uy, -ux, -uy,
                        ux + uy, -ux + uy, -ux + -uy, ux + -uy};
  f[0] = f[0] - k.inv_tau * (f[0] - k.w[0] * rho * base);
#pragma unroll
  for (int i = 1; i < kQ; ++i) {
    const float feq =
        k.w[i] * rho * (base + 3.0f * cu[i] + 4.5f * cu[i] * cu[i]);
    f[i] = f[i] - k.inv_tau * (f[i] - feq);
  }
}

__global__ void __launch_bounds__(kBX * kBY)
    d2q9_step_kernel(const float* __restrict__ f, float* __restrict__ out,
                     const uint8_t* __restrict__ solid, int nx, int ny,
                     StepConsts k) {
  __shared__ float post[kQ][kTY][kTX];  // post-collision tile + halo

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  const size_t plane = static_cast<size_t>(nx) * ny;

  // Load and collide the tile and its in-domain halo. Halo cells outside
  // the domain are never read below: the ghost rules replace them.
  for (int t = ty * kBX + tx; t < kTX * kTY; t += kBX * kBY) {
    const int ly = t / kTX;
    const int lx = t - ly * kTX;
    const int gx = x0 + lx - 1;
    const int gy = y0 + ly - 1;
    if (gx < 0 || gx >= nx || gy < 0 || gy >= ny) continue;
    const size_t cell = static_cast<size_t>(gy) * nx + gx;
    float v[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) v[i] = f[i * plane + cell];
    collide_bgk(v, k);
#pragma unroll
    for (int i = 0; i < kQ; ++i) post[i][ly][lx] = v[i];
  }
  __syncthreads();

  const int x = x0 + tx;
  const int y = y0 + ty;
  if (x >= nx || y >= ny) return;

  // Pull f_i(x) = f_post_i(x - c_i) with the reference's ghost semantics:
  // across a y edge (corners included) the frozen equilibrium, across an
  // x edge zero.
  auto pull = [&](int i, int cx, int cy) -> float {
    const int sy = y - cy;
    const int sx = x - cx;
    if (sy < 0 || sy >= ny) return k.eq_in[i];
    if (sx < 0 || sx >= nx) return 0.0f;
    return post[i][ty + 1 - cy][tx + 1 - cx];
  };
  float g[kQ];
  g[0] = pull(0, 0, 0);
  g[1] = pull(1, 1, 0);
  g[2] = pull(2, 0, 1);
  g[3] = pull(3, -1, 0);
  g[4] = pull(4, 0, -1);
  g[5] = pull(5, 1, 1);
  g[6] = pull(6, -1, 1);
  g[7] = pull(7, -1, -1);
  g[8] = pull(8, 1, -1);

  const size_t cell = static_cast<size_t>(y) * nx + x;
  if (solid[cell]) {
    // equilibrium obstacle: solid cells are pinned to rest equilibrium
#pragma unroll
    for (int i = 0; i < kQ; ++i) g[i] = k.w[i];
  } else {
    // bounce-back walls, bottom then top
    if (y == 0) {
      g[2] = g[4];
      g[5] = g[7];
      g[6] = g[8];
    }
    if (y == ny - 1) {
      g[4] = g[2];
      g[7] = g[5];
      g[8] = g[6];
    }
    // Zou-He velocity inlet at x = 0
    if (x == 0) {
      const float rho_bc =
          (g[0] + g[2] + g[4] + 2.0f * (g[3] + g[6] + g[7])) /
          k.one_minus_u_in;
      const float ru = rho_bc * k.u_in;
      const float ht = 0.5f * (g[2] - g[4]);
      g[1] = g[3] + (2.0f / 3.0f) * ru;
      g[5] = g[7] - ht + (1.0f / 6.0f) * ru;
      g[8] = g[6] + ht + (1.0f / 6.0f) * ru;
    }
    // Zou-He pressure outlet (rho = 1) at x = nx - 1
    if (x == nx - 1) {
      const float u_out =
          -1.0f + (g[0] + g[2] + g[4] + 2.0f * (g[1] + g[5] + g[8]));
      const float ht = 0.5f * (g[2] - g[4]);
      g[3] = g[1] - (2.0f / 3.0f) * u_out;
      g[6] = g[8] - ht - (1.0f / 6.0f) * u_out;
      g[7] = g[5] + ht - (1.0f / 6.0f) * u_out;
    }
  }
#pragma unroll
  for (int i = 0; i < kQ; ++i) out[i * plane + cell] = g[i];
}

}  // namespace

// Plain C interface, loaded with ctypes (tpulbm_torch/ops/step_cuda.py).
// Launches one step on `stream` and returns cudaGetLastError(): it neither
// synchronizes nor allocates.
extern "C" int tpulbm_d2q9_step(const float* f, float* out,
                                const uint8_t* solid, int nx, int ny,
                                float inv_tau, float u_in,
                                float one_minus_u_in, const float* eq_in,
                                const float* w, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  StepConsts k;
  k.inv_tau = inv_tau;
  k.u_in = u_in;
  k.one_minus_u_in = one_minus_u_in;
  for (int i = 0; i < kQ; ++i) {
    k.eq_in[i] = eq_in[i];
    k.w[i] = w[i];
  }
  const dim3 block(kBX, kBY);
  const dim3 grid((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY);
  d2q9_step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      f, out, solid, nx, ny, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
