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
// step: 0.0228 ms a launch at 2048x512 over 3.35 TB/s, 0.00571 ms a step
// at N=4. Against it stand the work a block repeats at the edges of what
// it owns and the barriers that order its stages.
//
// Design: the D2Q9 row march of d2q9_march.cuh at depth N (its comment
// has the strips, segments, stages, rings, asynchronous copies, corners,
// Bouzidi links, force profile and ring builds); step_d2q9.cu runs the
// same march at N = 1. At N = 4, kW0 = 96, kR = 1 the rings and the mask's
// rows take 70,656 B: two blocks of 480 threads an SM (ptxas's 64
// registers bind first).
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
// neighbours' corners).
//
// Knobs (utils/tile_sweep.py --lattice d2q9 builds the source with other
// values): -DTPULBM_WIDTH (kW0), -DTPULBM_ROWS (kR), -DTPULBM_SEGMENT (rows
// a segment, 0: the launcher's choice), -DTPULBM_MIN_BLOCKS (blocks an
// SM asked of ptxas, 0: none) and -DTPULBM_AHEAD (batches the copies run
// ahead); the libraries the port loads use the defaults below.

#ifndef TPULBM_WIDTH
#define TPULBM_WIDTH 96
#endif
#ifndef TPULBM_ROWS
#define TPULBM_ROWS 1
#endif
#ifndef TPULBM_SEGMENT
#define TPULBM_SEGMENT 0
#endif
// ptxas is asked for two blocks an SM where MRT's registers would leave
// one (its default build); elsewhere for nothing
#ifndef TPULBM_MIN_BLOCKS
#if TPULBM_COLLISION == 2 && !TPULBM_DEEP
#define TPULBM_MIN_BLOCKS 2
#else
#define TPULBM_MIN_BLOCKS 0
#endif
#endif
#ifndef TPULBM_AHEAD
#define TPULBM_AHEAD 1
#endif
#ifndef TPULBM_LINK_AHEAD
#define TPULBM_LINK_AHEAD 0
#endif

#include <type_traits>

#include "d2q9_march.cuh"

namespace {

// n_sub steps over the cols x rows cells from row rows_lo the launch
// writes (one device: the grid; a shard: its block's columns and the rows
// [r0, r1)).
cudaError_t launch(const float* f, float* out, const uint8_t* solid, int nx,
                   int ny, int cols, int rows_lo, int rows, int n_sub,
                   bool corners, const StepConsts& k, const tpulbm::Shard& sh,
                   const tpulbm::ForceTable& force,
                   const tpulbm::Links& links, int device,
                   cudaStream_t stream) {
#define TPULBM_LAUNCH(N)                                                   \
  launch_depth<N>(f, out, solid, nx, ny, cols, rows_lo, rows, corners, k, \
                  sh, force, links, device, stream)
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

// q(Depth<N>{}) for a depth n_sub the library holds, else -1.
template <int N>
using Depth = std::integral_constant<int, N>;
template <class Q>
int for_depth(int n_sub, Q q) {
  switch (n_sub) {
#if TPULBM_DEEP
    case 5: return q(Depth<5>{});
    case 6: return q(Depth<6>{});
    case 7: return q(Depth<7>{});
    case 8: return q(Depth<8>{});
#else
    case 2: return q(Depth<2>{});
    case 3: return q(Depth<3>{});
    case 4: return q(Depth<4>{});
#endif
    default: return -1;
  }
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
  err = launch(f, out, solid, nx, ny, nx, 0, ny, n_sub, clean_corners != 0,
               k, tpulbm::Shard{}, tpulbm::ForceTable{force_table, force_axis},
               tpulbm::Links{links, static_cast<size_t>(nx) * ny,
                             link_planes == 2 * kQ},
               device, static_cast<cudaStream_t>(stream));
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
  err = launch(f, out, nullptr, nx, ny, nxl, r0, r1 - r0, n_sub,
               clean_corners != 0, k, sh,
               tpulbm::ForceTable{force_table, force_axis},
               tpulbm::Links{links,
                             static_cast<size_t>(nyl + 2 * n_sub) *
                                 (nxl + 2 * n_sub),
                             link_planes == 2 * kQ},
               device, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
#endif

// Dynamic shared memory one block of depth n_sub takes, with the clean
// corners (corners = 1) or without, in bytes (-1 for a depth the library
// does not hold).
extern "C" int tpulbm_d2q9_blocked_smem_bytes(int n_sub, int corners) {
  return for_depth(n_sub, [&](auto n) {
    return smem_bytes<decltype(n)::value>(corners != 0);
  });
}

// The launch shape: stage 0's widened row (the strip of depth n_sub is
// n_sub columns narrower a side), the rows of a batch, the threads of a
// block; and the strips x segments a launch of depth n_sub over cols x
// rows cells on `device` takes (strips * 65536 + segments; -1 for a depth
// the library does not hold).
extern "C" int tpulbm_d2q9_blocked_width() { return kW0; }
extern "C" int tpulbm_d2q9_blocked_rows() { return kR; }
extern "C" int tpulbm_d2q9_blocked_threads(int n_sub) {
  return for_depth(n_sub, [](auto n) { return threads<decltype(n)::value>(); });
}
extern "C" int tpulbm_d2q9_blocked_grid(int n_sub, int cols, int rows,
                                        int corners, int device) {
  return for_depth(n_sub, [&](auto n) {
    return grid<decltype(n)::value>(cols, rows, corners != 0, device);
  });
}

// The floats of the library's mode coefficients, which the caller's array
// must hold (its mode: collision_modes.cuh's tpulbm_collision_mode).
extern "C" int tpulbm_mode_floats() { return tpulbm::kModeFloats; }

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
