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
// The collision, the pull's ghost rule and the boundary sequence live in
// d2q9_common.cuh, shared with the N-step kernel (step_d2q9_blocked.cu).

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
    tpulbm::collide_bgk(v, k);
#pragma unroll
    for (int i = 0; i < kQ; ++i) post[i][ly][lx] = v[i];
  }
  __syncthreads();

  const int x = x0 + tx;
  const int y = y0 + ty;
  if (x >= nx || y >= ny) return;

  float g[kQ];
  tpulbm::pull_d2q9(g, x, y, nx, ny, k, [&](int i, int cx, int cy) {
    return post[i][ty + 1 - cy][tx + 1 - cx];
  });
  const size_t cell = static_cast<size_t>(y) * nx + x;
  tpulbm::apply_boundaries(g, solid[cell] != 0, x, y, nx, ny, k);
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
  const StepConsts k =
      tpulbm::make_consts(inv_tau, u_in, one_minus_u_in, eq_in, w);
  const dim3 block(kBX, kBY);
  const dim3 grid((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY);
  d2q9_step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      f, out, solid, nx, ny, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
