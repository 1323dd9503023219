// One fused D2Q9 timestep on an NVIDIA Hopper GPU (sm_90a), float32:
// collide (+ body-force source) -> pull-stream -> ghost sanitize -> the
// domain's boundary sequence. The obstacle domain (the cylinder): y walls
// -> Zou-He inlet -> Zou-He outlet -> clean Zou-He corners (optional) ->
// obstacle (pin or bounce-back). The channel: periodic x, y walls; the
// slab (-DTPULBM_SLAB=1): periodic x, the frozen-equilibrium ghosts at the
// y edges and the walls solid rows of the mask under the obstacle rule
// (pin, bounce-back or Bouzidi). The cavity: bottom wall -> moving lid ->
// side walls -> corner closure. The box: periodic x and y, no walls.
//
// Replaces tpulbm/ops/step_pallas.py::make_local_step_pallas (the fused
// 1-step Pallas TPU kernel) with its src, force_fn, periodic_x, periodic
// y, walls_x, lid_u, bounce_back and bz modes and its walls_y off with a
// solid mask (the slab), under each of its collisions
// (BGK, TRT, MRT, regularized, KBC, Smagorinsky, power law) and with
// either corner rule: one library per collision, domain, source, force
// profile and obstacle rule (collision_modes.cuh, d2q9_common.cuh). Its
// plain version is tpulbm_torch/ops/step_torch.py.
//
// What bounds it: device-memory traffic for BGK. A step has to read and
// write the 9 populations of every cell once, 72 B per cell (plus 1 B of
// solid mask): 0.0228 ms at 2048x512 over 3.35 TB/s, against about 115
// floating-point operations per cell under BGK and up to a few hundred
// under KBC or the power law's Newton solve.
//
// Design: the D2Q9 row march of d2q9_march.cuh at depth 1, the design the
// N-step kernel (step_d2q9_blocked.cu) runs at N = 2-8. A block owns a
// strip of kW0 - 2 output columns and marches up a segment of rows: stage
// 0's threads collide a widened row (the strip and a column a side) in
// place in a ring of rows in shared memory while stage 1's threads pull
// the row two batches behind it, apply the boundary sequence and store it,
// and feed stage 0 by asynchronous copies kAhead batches ahead; one
// barrier a march step. Against the 32x8 tiles this replaced (34x10 cells
// loaded and collided for 32x8 outputs: 1.33 a cell), a segment of S rows
// loads and collides (kW0 / (kW0 - 2)) (S + 2) / S cells a cell, and the
// launcher sizes the segments to fill the card once: 16.5 rows at
// 2048x512, but 3-4 on a shard of 128-256 rows, where the march is slower
// than the tiles were (PERF.md §6). A row's source is found once
// (tpulbm::RowSource), in the rings build too. The clean corners' inlet
// rule and the cavity's corners read two rows inward: their segments keep
// two rows, and the cavity's strips shift a column where the last would
// hold one (tpulbm::tile_col_shift).
//
// The Bouzidi obstacle (-DTPULBM_BOUZIDI=1, tpulbm's `bz` mode: its
// _bz_rewrite, step_pallas.py:769-792): every term of the cut-link rewrite
// sits at the boundary cell (its own post-collision values, in stage 0's
// ring, and its pulled values), so after the edge rules a cell whose mask
// byte carries kLinkBit reads its entries of the link table from device
// memory at its own index, a march step ahead into registers, and rewrites
// its cut links (apply_bouzidi in d2q9_common.cuh); the TPU kernel's
// q-table slab DMA has no counterpart.
// A step reads the table only at those cells: 32 B each (64 B spinning),
// a few hundred cells around a cylinder.
//
// The force profile (-DTPULBM_FORCE=1, Kolmogorov's cos(ky) along y or a
// force along x): a block stages its widened columns' entries of the
// (9, n) table once in shared memory, or each row's with its populations
// (tpulbm::ForceTable), and every collision adds them.
//
// Bits: the collision, the pull's ghost rule and the boundary sequence
// live in d2q9_common.cuh, shared with the N-step kernel, and both
// libraries are built with -fmad=false, so one N-step launch gives the
// bits of N launches of this kernel.
//
// Built with -DTPULBM_RINGS=1 the kernel steps one shard of a mesh
// (tpulbm_d2q9_step_rings): the block and the one-cell rings its
// neighbours sent (tpulbm::Shard), into a range of the block's rows. That
// build replaces make_local_step_pallas with its ring inputs (rb, rt, the
// mask rings, the physical-edge flags), make_local_step_pallas_ranged (the
// row range) and make_local_step_tiled at depth 1 (the x rings). Cells keep
// global coordinates, so every rule acts only at the domain's own edges;
// the bits are those of the one-device build. The rings add 2 (nxl + 2 hx
// + hx nyl) x 36 B a launch to the 73 B a cell.
//
// Knobs (utils/tile_sweep.py --lattice d2q9 --one-step builds the source
// with other values): -DTPULBM_WIDTH (kW0), -DTPULBM_ROWS (rows a batch),
// -DTPULBM_SEGMENT (rows a segment, 0: the launcher's choice),
// -DTPULBM_MIN_BLOCKS (blocks an SM asked of ptxas, 0: none),
// -DTPULBM_AHEAD (batches the copies run ahead: a march step at N = 1 is
// short, and one batch's copies in flight bound it) and
// -DTPULBM_LINK_AHEAD (1: a Bouzidi cell's link entries loaded into
// registers a march step before it is stepped); the libraries the port
// loads use the defaults below.

#ifndef TPULBM_WIDTH
#define TPULBM_WIDTH 128
#endif
#ifndef TPULBM_ROWS
#define TPULBM_ROWS 1
#endif
#ifndef TPULBM_SEGMENT
#define TPULBM_SEGMENT 0
#endif
#ifndef TPULBM_MIN_BLOCKS
#define TPULBM_MIN_BLOCKS 0
#endif
#ifndef TPULBM_AHEAD
#define TPULBM_AHEAD 2
#endif
#ifndef TPULBM_LINK_AHEAD
#define TPULBM_LINK_AHEAD 1
#endif

#include "d2q9_march.cuh"

// Plain C interface, loaded with ctypes (tpulbm_torch/ops/step_cuda.py).
// Each launcher launches one step on `stream` and returns
// cudaGetLastError(): it neither synchronizes nor allocates.
// The clean corners belong to the obstacle domain; elsewhere the launcher
// takes clean_corners = 0. force_table is the force profile's (9, n) device
// table along force_axis (tpulbm::ForceTable), read by the kForce build
// only (elsewhere null). links and link_planes: the Bouzidi link table
// (tpulbm::Links) and its planes, 9 (a still wall) or 18 (a moving one),
// read by the kBouzidi build only (elsewhere null and 0).
#if !TPULBM_RINGS
extern "C" int tpulbm_d2q9_step(const float* f, float* out,
                                const uint8_t* solid, int nx, int ny,
                                float inv_tau, float u_in,
                                float one_minus_u_in, const float* eq_in,
                                const float* w, int clean_corners,
                                const float* mode, const float* src,
                                float lid7, float lid8, int force_axis,
                                const float* force_table, const float* links,
                                int link_planes, int device, void* stream) {
  if (!tpulbm::links_fit(links, link_planes, kQ)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const StepConsts k = tpulbm::make_consts(inv_tau, u_in, one_minus_u_in,
                                           eq_in, w, mode, src, lid7, lid8);
  err = launch_depth<1>(
      f, out, solid, nx, ny, nx, 0, ny, clean_corners != 0, k,
      tpulbm::Shard{}, tpulbm::ForceTable{force_table, force_axis},
      tpulbm::Links{links, static_cast<size_t>(nx) * ny,
                    link_planes == 2 * kQ},
      device, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
#else
// One step of the shard (nxl x nyl at global x0, y0 of the nx x ny grid)
// from f and its rings (depth 1; hx 0 or 1, as tpulbm::Shard describes
// them) into rows [r0, r1) of out; the other rows of out are left as they
// are. mask is the shard's solid mask padded by one cell, and links its
// cut of the link table padded the same way.
extern "C" int tpulbm_d2q9_step_rings(
    const float* f, float* out, const uint8_t* mask, const float* rb,
    const float* rt, const float* rl, const float* rr, int nx, int ny,
    int nxl, int nyl, int x0, int y0, int hx, int r0, int r1, float inv_tau,
    float u_in, float one_minus_u_in, const float* eq_in, const float* w,
    int clean_corners, const float* mode, const float* src, float lid7,
    float lid8, int force_axis, const float* force_table, const float* links,
    int link_planes, int device, void* stream) {
  if (!tpulbm::links_fit(links, link_planes, kQ)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r0 < 0 || r1 > nyl || r0 >= r1) return cudaErrorInvalidValue;
  const StepConsts k = tpulbm::make_consts(inv_tau, u_in, one_minus_u_in,
                                           eq_in, w, mode, src, lid7, lid8);
  const tpulbm::Shard sh{f, rb, rt, rl, rr, mask, nxl, nyl,
                         x0, y0, hx, 1, r0, r1};
  err = launch_depth<1>(
      f, out, nullptr, nx, ny, nxl, r0, r1 - r0, clean_corners != 0, k, sh,
      tpulbm::ForceTable{force_table, force_axis},
      tpulbm::Links{links, static_cast<size_t>(nyl + 2) * (nxl + 2),
                    link_planes == 2 * kQ},
      device, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
#endif

// The launch shape: the dynamic shared memory of a block with the clean
// corners (corners = 1) or without, in bytes; the widened row (the strip
// is a column narrower a side), the rows of a batch, the threads of a
// block; and the strips x segments of a launch over cols x rows cells on
// `device` (strips * 65536 + segments).
extern "C" int tpulbm_d2q9_smem_bytes(int corners) {
  return smem_bytes<1>(corners != 0);
}
extern "C" int tpulbm_d2q9_width() { return kW0; }
extern "C" int tpulbm_d2q9_rows() { return kR; }
extern "C" int tpulbm_d2q9_threads() { return threads<1>(); }
extern "C" int tpulbm_d2q9_grid(int cols, int rows, int corners,
                                int device) {
  return grid<1>(cols, rows, corners != 0, device);
}

// The floats of the library's mode coefficients, which the caller's array
// must hold (its mode: collision_modes.cuh's tpulbm_collision_mode).
extern "C" int tpulbm_mode_floats() { return tpulbm::kModeFloats; }

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
