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
// device memory once each way, the card should hold enough blocks to keep
// that traffic in flight, and no block should wait for its own loads.
//
// Design: a z-march. A block owns a 32 x kBY (x, y) tile of cells and
// marches along z over `march` output planes, a length the launcher picks
// from the grid and the blocks the card keeps resident (march_for): the
// longest march of at most kMaxMarch = 16 planes that gives the launch
// kWaves waves of blocks, and at least kMinMarch = 8 planes (a march of m
// planes collides (m + 2) / m planes a plane it writes: 1.125 at 16). A
// plane of the block is its window: the tile and a one-cell x/y halo,
// (32 + 2) x (kBY + 2) cells, each collided once per block (34 x 10 / 256
// = 1.33 collisions a cell in-plane at 32 x 8). Each thread owns the same
// window cells at every plane of the march, and march step c:
//   1. takes its cells' raw populations of plane c, which arrived by
//      asynchronous copies (cp.async, 4 B a population and cell) in its
//      own slots of the stage buffer, collides them and stores them in the
//      ring; right after, it issues the copies of plane c + 1 into the same
//      slots, which it alone reads: no barrier orders its copies, only its
//      own wait (__pipeline_wait_prior) at step c + 1. The copies run
//      during the rest of step c: the pull and the barriers;
//   2. pulls plane p = c - kLag from the ring, applies the boundary
//      sequence in registers and stores it, one thread a tile cell;
//   3. meets the block barrier.
// At kLag = 1 (D3Q19) a second barrier between 1 and 2 makes the plane
// just collided visible to the pull; at kLag = 2 (D3Q27) the pull trails
// the collisions by two planes and one barrier a plane orders both. The
// ring keeps each population only while a pull still reads it, by its z
// class cz + 1 (the pull of p reads class 0 from plane p + 1, class 1 from
// p, class 2 from p - 1): class c takes c + kLag slots of a plane each, and
// under Bouzidi class 0 one more (the link cell reads its own class-0
// values of p after plane p + kLag took their slot otherwise): D3Q19 5 +
// 9 x 2 + 5 x 3 = 38 floats a cell at kLag = 1 (5 more under Bouzidi),
// D3Q27 9 x (2 + 3 + 4) = 81 at kLag = 2 (9 more). Beside the ring: the
// stage buffer, Q floats a window cell, and kLag + 1 planes of mask bytes.
// At 32 x 8 D3Q19 takes 78,200 B (two blocks of 256 threads an SM, 92 KB of
// the SM's memory left to L1), D3Q27 147,900 B (one block).
// The window's cells go to threads row by row over the 32 tile columns,
// then the two halo columns, so a warp's copies of one population read one
// 128-byte line where x0 is aligned.
// What the shape was chosen by (utils/tile_sweep.py --one-step on an H100,
// PERF.md §6): the 4-byte copies hold L1 lines while in flight, and
// a build whose shared memory leaves 28 KB of L1 ran 1.75 ms at 256^3
// against 1.25 with 92 KB (D3Q19 at kLag = 2 against 1); 16-byte copies
// past L1 (cp.async.cg) into the ring, which need a barrier between copy
// and collision, ran 1.37; marches of 16 planes (1.16 ms, 15.5 waves of
// blocks) beat the 86 planes that two waves alone give (1.25).
//
// The zero-gradient outlet is not cell-local: a fluid cell at x = nx-1
// takes every population of x = nx-2 as it stands after the stream and the
// y and z walls, before the obstacle pin, even when nx-2 is solid (the
// walls skip solids). The outlet thread recomputes that cell's pull from
// the ring, which needs collided values of x = nx-3 .. nx-1. The x tiles
// are therefore aligned to the right edge (block 0 holds x = nx-32 ..
// nx-1), so nx-2 and its whole x neighbourhood lie inside the block that
// holds nx-1 and no extra halo column is needed; the ragged tile is the
// leftmost one, masked. Out-of-domain cells and planes are never read:
// the ghost rule replaces them. In the duct the halo columns x = -1 and
// x = nx are loaded from x = nx-1 and x = 0, so the pull wraps with no test
// of its own; in the box the halo rows y = -1, y = ny and the planes
// z = -1, z = nz are loaded from y = ny-1, 0 and z = nz-1, 0 the same way
// (tpulbm's wrapped ring planes zb/zt), at every march's ends too: the
// march's plane index stays unwrapped for the ring's slots and is taken
// mod nz for the source.
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
// that holds x = nx-1 holds the outlet's neighbourhood. A window cell's
// source is found once for the whole march (Shard::row, column,
// row_source: the block, a ring row or a ring column, and the stride from
// plane to plane), not per plane; every cell keeps its global coordinates,
// so the shard's cells take the bits one device gives them, and the cells
// the launch does not hold are never stepped. Its plain version is
// tpulbm_torch/ops/step_rings_torch.py.
//
// The Bouzidi obstacle (-DTPULBM_BOUZIDI=1, tpulbm's `bz` mode of
// step_pallas3d.py:844-857, on either velocity set): a cell whose mask
// byte carries kLinkBit rewrites its cut links after its boundary sequence
// (apply_bouzidi in d3q19_common.cuh) from its entries of the link table
// (Q planes, 2Q for a moving wall), read at its own index (the padded
// shard index in a ring build), and its own post-collision values of plane
// p in the ring. A step ahead, the thread that pulls a link cell asks for
// its entries of the next plane in L1 (prefetch.global.L1).
//
// Knobs (utils/tile_sweep.py --one-step builds the source with other
// values): -DTPULBM_TILE_Y (kBY), -DTPULBM_THREADS, -DTPULBM_ZCHUNK (the
// march's length, 0 for the launcher's choice), -DTPULBM_LAG; the libraries
// the port loads use the defaults below. Asking ptxas for two blocks an SM
// (__launch_bounds__'s second argument 2) changed no build's time by more
// than 0.3% (MRT, TRT, the power law, the box), so no build asks.
//
// The collision, the pull and the boundary sequence live in
// d3q19_common.cuh, shared with the N-step kernel (step_d3q19_blocked.cu);
// both libraries are built with -fmad=false, so one launch of that kernel
// gives the same bits as N launches of this one.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "d3q19_common.cuh"
#include "hopper_async.cuh"  // prefetch_l1

#ifndef TPULBM_TILE_Y
#define TPULBM_TILE_Y 8
#endif
#ifndef TPULBM_THREADS
#define TPULBM_THREADS (32 * TPULBM_TILE_Y)
#endif
#ifndef TPULBM_ZCHUNK
#define TPULBM_ZCHUNK 0
#endif
#ifndef TPULBM_LAG
#define TPULBM_LAG (TPULBM_Q == 27 ? 2 : 1)
#endif

namespace {

using tpulbm3d::Consts;
using tpulbm3d::kQ;

constexpr int kBX = 32;                 // tile width: one warp per row
constexpr int kBY = TPULBM_TILE_Y;      // tile height
constexpr int kThreads = TPULBM_THREADS;
constexpr int kZChunk = TPULBM_ZCHUNK;  // the march's length, 0: launcher's
constexpr int kLag = TPULBM_LAG;        // planes the pull trails the collision
constexpr int kWaves = 2;               // waves of blocks a launch aims for
constexpr int kMinMarch = 8;            // the shortest march it picks
constexpr int kMaxMarch = 16;           // and the longest
constexpr int kWX = kBX + 2;            // the window: tile and halo
constexpr int kWY = kBY + 2;
constexpr int kWin = kWX * kWY;
constexpr int kVisits = (kWin + kThreads - 1) / kThreads;
constexpr int kTileCells = kBX * kBY;
static_assert(kBY >= 1, "a tile of one row at least");
static_assert(kThreads % 32 == 0 && kThreads <= 1024,
              "whole warps, at most 1024 threads");
static_assert(kLag == 1 || kLag == 2, "the pull trails by one or two planes");
static_assert(kZChunk >= 0, "a march of kZChunk planes, or 0");

// cz of population i, from the table

__host__ __device__ constexpr int cz_of(int i) {
#define TPULBM_CZ_CASE(i_, cx, cy, cz, o) \
  if (i == (i_)) return (cz);
  TPULBM_LAT3D(TPULBM_CZ_CASE)
#undef TPULBM_CZ_CASE
  return 0;
}

// The ring keeps class c = cz + 1 in class_slots(c) slots of class_size(c)
// planes each (a plane: one population over the window), the slot of
// z-plane q being (q + kSlotBias) % class_slots(c): q >= -1 at every plane
// a march reads, and 12 is a multiple of every count of slots.
constexpr int kSlotBias = 12;
__host__ __device__ constexpr int class_size(int c) {
  int n = 0;
  for (int i = 0; i < kQ; ++i) n += cz_of(i) + 1 == c ? 1 : 0;
  return n;
}
__host__ __device__ constexpr int class_slots(int c) {
  return c + kLag + (tpulbm3d::kBouzidi && c == 0 ? 1 : 0);
}
__host__ __device__ constexpr int class_base(int c) {
  return c == 0   ? 0
         : c == 1 ? class_slots(0) * class_size(0)
                  : class_slots(0) * class_size(0) +
                        class_slots(1) * class_size(1);
}
constexpr int kRingFloats = class_base(2) + class_slots(2) * class_size(2);
static_assert(kQ != 19 || tpulbm3d::kBouzidi ||
                  kRingFloats == (kLag == 1 ? 38 : 57),
              "5 + 9 x 2 + 5 x 3 floats a cell (5 x 2 + 9 x 3 + 5 x 4)");
static_assert(kQ != 27 || tpulbm3d::kBouzidi ||
                  kRingFloats == (kLag == 2 ? 81 : 54),
              "9 x (2 + 3 + 4) floats a cell on D3Q27 (9 x (1 + 2 + 3))");
static_assert(kSlotBias % class_slots(0) == 0 &&
                  kSlotBias % class_slots(1) == 0 &&
                  kSlotBias % class_slots(2) == 0,
              "the bias is a multiple of every count of slots");

// i's position among the populations of its class
__host__ __device__ constexpr int rank_in_class(int i) {
  int n = 0;
  for (int j = 0; j < i; ++j) n += cz_of(j) == cz_of(i) ? 1 : 0;
  return n;
}
// the mask bytes of the planes from c - kLag (pulled) to c (collided)
constexpr int kMaskSlots = kLag + 1;
constexpr size_t kRingBytes = sizeof(float) * kRingFloats * kWin;
constexpr size_t kStageBytes = sizeof(float) * kQ * kWin;
constexpr size_t kSmemBytes = kRingBytes + kStageBytes + kMaskSlots * kWin;
static_assert(kSmemBytes <= 232448, "a block takes at most 227 KB");

// The float offsets of the class-0, class-1 and class-2 slots that hold
// z-plane q.
struct Slots {
  int c0, c1, c2;
};
__device__ __forceinline__ Slots slots_of(int q) {
  return {((q + kSlotBias) % class_slots(0)) * class_size(0) * kWin,
          class_base(1) * kWin +
              ((q + kSlotBias) % class_slots(1)) * class_size(1) * kWin,
          class_base(2) * kWin +
              ((q + kSlotBias) % class_slots(2)) * class_size(2) * kWin};
}

// The slots a pull of plane p reads: class 0 of plane p+1, class 1 of p,
// class 2 of p-1.
__device__ __forceinline__ Slots pull_slots(int p) {
  return {slots_of(p + 1).c0, slots_of(p).c1, slots_of(p - 1).c2};
}

// The float offset of population I of the z-plane whose slots are s.
template <int I>
__device__ __forceinline__ int ring_at(const Slots& s) {
  constexpr int c = cz_of(I) + 1;
  return rank_in_class(I) * kWin + (c == 0 ? s.c0 : c == 1 ? s.c1 : s.c2);
}

// Window cell w's place in the window (lx, ly; the tile's cell (0, 0) at
// (1, 1)): the 32 tile columns row by row, then the two halo columns.
__device__ __forceinline__ void window_xy(int w, int& lx, int& ly) {
  if (w < kBX * kWY) {
    ly = w / kBX;
    lx = w - ly * kBX + 1;
  } else {
    const int h = w - kBX * kWY;
    ly = h >> 1;
    lx = (h & 1) ? kWX - 1 : 0;
  }
}

// Where a window cell's populations lie in device memory: population i of
// plane z at src + z * zs + i * pop, its mask byte at mask + z * (the
// mask's plane); src null where the cell is not stepped.
struct Column {
  const float* src;
  const uint8_t* mask;
  unsigned pop, zs;
};

// The column of the window cell at global (gx, gy): one device, a cell of
// the domain or in the duct and the box one of its wrapped halo cells; a
// shard, a cell the block or its rings hold.
__device__ __forceinline__ Column column_of(int gx, int gy, int nx, int ny,
                                            int nz, const float* f,
                                            const uint8_t* solid,
                                            const tpulbm3d::Shard& sh) {
  Column c{nullptr, nullptr, 0, 0};
  if constexpr (tpulbm::kRings) {
    int bx, by;
    if (!sh.row(gy, ny, by) || !sh.column(gx, nx, bx)) return c;
    c.src = sh.row_source(by).at(bx, c.pop, c.zs);
    c.mask = sh.mask + sh.padded(bx, by, 0);
    return c;
  }
  if constexpr (tpulbm3d::kPeriodicX) {
    if (gx < -1 || gx > nx) return c;
    gx = gx < 0 ? nx - 1 : gx >= nx ? 0 : gx;
  } else {
    if (gx < 0 || gx >= nx) return c;
  }
  if constexpr (tpulbm3d::kPeriodicY) {
    if (gy < -1 || gy > ny) return c;
    gy = gy < 0 ? ny - 1 : gy >= ny ? 0 : gy;
  } else {
    if (gy < 0 || gy >= ny) return c;
  }
  const size_t cell = static_cast<size_t>(gy) * nx + gx;
  c.src = f + cell;
  c.zs = static_cast<unsigned>(nx) * ny;
  c.pop = c.zs * static_cast<unsigned>(nz);
  if constexpr (tpulbm3d::kHasObstacle) c.mask = solid + cell;
  return c;
}

// Whether the march collides plane q: a plane of the domain, or any in the
// box; and the plane of the domain it holds (q mod nz in the box).
__device__ __forceinline__ bool loads_plane(int q, int nz) {
  return tpulbm3d::kPeriodicZ || (q >= 0 && q < nz);
}
__device__ __forceinline__ int plane_of(int q, int nz) {
  if constexpr (tpulbm3d::kPeriodicZ) {
    q %= nz;
    if (q < 0) q += nz;
  }
  return q;
}

// (kThreads, 1): ptxas may take up to 255 registers a thread. Without the
// second argument it took 80 for the BGK build (109 with it); the builds
// timed against the previous 1-step kernel (PERF.md §6) are those with it.
__global__ void __launch_bounds__(kThreads, 1)
    d3q19_step_kernel(const float* __restrict__ f, float* __restrict__ out,
                      const uint8_t* __restrict__ solid,
                      const float* __restrict__ force, int nx, int ny,
                      int nz, int march, const __grid_constant__ Consts k,
                      tpulbm::Links links,
                      const __grid_constant__ tpulbm3d::Shard sh) {
  // the ring, the stage buffer (Q floats a window cell), the mask planes
  extern __shared__ float smem[];
  float* ring = smem;
  float* stage = smem + kRingFloats * kWin;
  uint8_t* masks = reinterpret_cast<uint8_t*>(stage + kQ * kWin);
  const int tid = threadIdx.x;
  // the tile's global origin, right-aligned to the last column of the grid
  // (of the shard's block in a rings build)
  const int x0 = (tpulbm::kRings ? sh.x0 + sh.nxl : nx) -
                 kBX * (static_cast<int>(blockIdx.x) + 1);
  const int y0 = (tpulbm::kRings ? sh.y0 : 0) +
                 static_cast<int>(blockIdx.y) * kBY;
  const int z0 = static_cast<int>(blockIdx.z) * march;
  const int z1 = z0 + march < nz ? z0 + march : nz;
  const size_t mask_plane =
      tpulbm::kRings ? static_cast<size_t>(sh.nyl + 2) * (sh.nxl + 2)
                     : static_cast<size_t>(nx) * ny;

  // the thread's window cells, their sources found once for the march
  Column col[kVisits];
#pragma unroll
  for (int j = 0; j < kVisits; ++j) {
    const int w = tid + j * kThreads;
    col[j] = Column{nullptr, nullptr, 0, 0};
    if (w < kWin) {
      int lx, ly;
      window_xy(w, lx, ly);
      col[j] = column_of(x0 - 1 + lx, y0 - 1 + ly, nx, ny, nz, f, solid, sh);
    }
  }
  // Copies of plane q of window cell j (the j-th of this thread) into its
  // slots of the stage buffer, and its mask byte into pending[j].
  uint8_t pending[kVisits];
  auto feed = [&](int j, int q) {
    const int w = tid + j * kThreads;
    const size_t zq = static_cast<size_t>(plane_of(q, nz));
    const float* src = col[j].src + zq * col[j].zs;
    if constexpr (tpulbm3d::kHasObstacle) {
      pending[j] = col[j].mask[zq * mask_plane];
    }
#define TPULBM_COPY(i, cx, cy, cz, o)                                \
  __pipeline_memcpy_async(stage + (i) * kWin + w,                    \
                          src + static_cast<size_t>(i) * col[j].pop, \
                          sizeof(float));
    TPULBM_LAT3D(TPULBM_COPY)
#undef TPULBM_COPY
  };
  if (loads_plane(z0 - 1, nz)) {
#pragma unroll
    for (int j = 0; j < kVisits; ++j) {
      if (col[j].src != nullptr) feed(j, z0 - 1);
    }
    __pipeline_commit();
  }
  // march step c: collide plane c (z0 - 1 .. z1), pull plane c - kLag
  // (z0 .. z1 - 1)
  for (int c = z0 - 1; c < z1 + kLag; ++c) {
    const bool collides = c <= z1 && loads_plane(c, nz);
    const bool feeds = c + 1 <= z1 && loads_plane(c + 1, nz);
    if (collides) __pipeline_wait_prior(0);  // this thread's copies of c
    const Slots wr = slots_of(c);
    const int cz = plane_of(c, nz);
    uint8_t* mask_c = masks + ((c + kSlotBias) % kMaskSlots) * kWin;
#pragma unroll
    for (int j = 0; j < kVisits; ++j) {
      const int w = tid + j * kThreads;
      if (col[j].src == nullptr) continue;
      if (collides) {
        int lx, ly;
        window_xy(w, lx, ly);
        const int at = ly * kWX + lx;
        float v[kQ];
#pragma unroll
        for (int i = 0; i < kQ; ++i) v[i] = stage[i * kWin + w];
        if constexpr (tpulbm3d::kHasObstacle) mask_c[at] = pending[j];
        tpulbm3d::collide_cell(
            v, k, tpulbm3d::kBounceBack && tpulbm3d::is_solid(pending[j]),
            force + cz, nz);
#define TPULBM_STORE(i, cx, cy, cz_, o) ring[ring_at<i>(wr) + at] = v[i];
        TPULBM_LAT3D(TPULBM_STORE)
#undef TPULBM_STORE
      }
      // after the collision has read them: the slots take plane c + 1
      if (feeds) feed(j, c + 1);
    }
    if (feeds) __pipeline_commit();
    if constexpr (kLag == 1) __syncthreads();  // plane c for the pull
    const int p = c - kLag;
    if (p >= z0) {
      const Slots rd = pull_slots(p);
      const Slots own = slots_of(p);
      const uint8_t* mask_p = masks + ((p + kSlotBias) % kMaskSlots) * kWin;
      const uint8_t* mask_n =
          masks + ((p + 1 + kSlotBias) % kMaskSlots) * kWin;
      const size_t plane = static_cast<size_t>(nx) * ny;
      for (int t = tid; t < kTileCells; t += kThreads) {
        const int ty = t / kBX;
        const int tx = t - ty * kBX;
        const int x = x0 + tx;
        const int y = y0 + ty;
        if (!(tpulbm::kRings ? sh.writes(x - sh.x0, y - sh.y0)
                             : x >= 0 && y < ny)) {
          continue;
        }
        const int at = (ty + 1) * kWX + tx + 1;
        float g[kQ];
        tpulbm3d::step_cell(
            g, [&](int ox) { return tpulbm3d::is_solid(mask_p[at + ox]); },
            x, y, p, nx, ny, nz, k, [&](auto i, int ox, int oy, int oz) {
              return ring[ring_at<decltype(i)::value>(rd) + at + oy * kWX +
                          ox];
            });
        const size_t cell = tpulbm::kRings
                                ? sh.cell(x - sh.x0, y - sh.y0, p)
                                : static_cast<size_t>(p) * plane +
                                      static_cast<size_t>(y) * nx + x;
        if constexpr (tpulbm3d::kBouzidi) {
          const size_t link =
              tpulbm::kRings ? sh.padded(x - sh.x0, y - sh.y0, p) : cell;
          if (mask_p[at] & tpulbm::kLinkBit) {
            tpulbm3d::apply_bouzidi(
                g, links.q + link, links.plane, links.moving != 0,
                [&](auto i) {
                  return ring[ring_at<decltype(i)::value>(own) + at];
                });
          }
          // the next plane's entries of this cell, into L1 a step ahead
          if (p + 1 < z1 && (mask_n[at] & tpulbm::kLinkBit)) {
            const size_t next =
                link + (tpulbm::kRings ? mask_plane : plane);
            const int planes = links.moving != 0 ? 2 * kQ : kQ;
            for (int j = 1; j < planes; ++j) {
              if (j != kQ) {
                tpulbm_async::prefetch_l1(links.q + next + j * links.plane);
              }
            }
          }
        }
        const size_t pop = tpulbm::kRings
                               ? static_cast<size_t>(nz) * sh.nyl * sh.nxl
                               : plane * nz;
#pragma unroll
        for (int i = 0; i < kQ; ++i) out[i * pop + cell] = g[i];
      }
    }
    __syncthreads();  // the ring slots of plane c + 1 are written next
  }
}

// The blocks of the kernel `device` keeps resident at once, once per
// device (the kernel's shared-memory limit raised first).
cudaError_t prepare(int device, int& resident) {
  static int cache[64];
  const bool cached = device >= 0 && device < 64;
  if (cached && cache[device] > 0) {
    resident = cache[device];
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      d3q19_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  int sms = 0, per = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, d3q19_step_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  resident = sms * per > 0 ? sms * per : 1;
  if (cached) cache[device] = resident;
  return cudaSuccess;
}

// The march's length for a launch over cols x rows tiles' cells and nz
// planes: kZChunk where set; else the longest march of at most kMaxMarch
// planes that still gives the launch kWaves waves of the card's resident
// blocks, and at least kMinMarch planes (all of them where nz is shorter).
int march_for(int cols, int rows, int nz, int resident) {
  if (kZChunk > 0) return kZChunk;
  const long long tiles = static_cast<long long>((cols + kBX - 1) / kBX) *
                          ((rows + kBY - 1) / kBY);
  const long long want = static_cast<long long>(kWaves) * resident;
  const long long segments = (want + tiles - 1) / tiles;
  long long m = (nz + segments - 1) / segments;
  if (m > kMaxMarch) m = kMaxMarch;
  const int least = nz < kMinMarch ? nz : kMinMarch;
  if (m < least) m = least;
  return static_cast<int>(m > 0 ? m : 1);
}

cudaError_t launch(const float* f, float* out, const uint8_t* solid,
                   const float* force, int nx, int ny, int nz, int cols,
                   int rows, const Consts& k, const tpulbm::Links& links,
                   const tpulbm3d::Shard& sh, int device,
                   cudaStream_t stream) {
  int resident = 0;
  const cudaError_t err = prepare(device, resident);
  if (err != cudaSuccess) return err;
  const int march = march_for(cols, rows, nz, resident);
  const dim3 grid((cols + kBX - 1) / kBX, (rows + kBY - 1) / kBY,
                  (nz + march - 1) / march);
  d3q19_step_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      f, out, solid, force, nx, ny, nz, march, k, links, sh);
  return cudaGetLastError();
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
  const Consts k = tpulbm3d::make_consts(inv_tau, eq_in, w, mode, src);
  err = launch(f, out, solid, force, nx, ny, nz, nx, ny, k,
               tpulbm::Links{links, static_cast<size_t>(nx) * ny * nz,
                             link_planes == 2 * kQ},
               tpulbm3d::Shard{}, device, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
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
  const Consts k = tpulbm3d::make_consts(inv_tau, eq_in, w, mode, src);
  const tpulbm3d::Shard sh{f, rb, rt, rl, rr, mask, nxl, nyl, nz,
                           x0, y0, hx, 1};
  err = launch(f, out, nullptr, force, nx, ny, nz, nxl, nyl, k,
               tpulbm::Links{links,
                             static_cast<size_t>(nz) * (nyl + 2) * (nxl + 2),
                             link_planes == 2 * kQ},
               sh, device, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
#endif

// The dynamic shared memory a block of the kernel takes, in bytes.
extern "C" int tpulbm_d3q19_smem_bytes() {
  return static_cast<int>(kSmemBytes);
}

// The launch shape: the tile (x * 256 + y), the threads of a block, the
// planes the pull trails the collision; the blocks `device` keeps resident
// and the march's length for a launch over cols x rows cells (the grid, or
// a shard's block) and nz planes (-1 if the runtime refuses a query).
extern "C" int tpulbm_d3q19_tile() { return kBX * 256 + kBY; }
extern "C" int tpulbm_d3q19_threads() { return kThreads; }
extern "C" int tpulbm_d3q19_lag() { return kLag; }
extern "C" int tpulbm_d3q19_resident(int device) {
  int resident = 0;
  if (cudaSetDevice(device) != cudaSuccess ||
      prepare(device, resident) != cudaSuccess) {
    return -1;
  }
  return resident;
}
extern "C" int tpulbm_d3q19_grid(int cols, int rows, int nz, int device) {
  const int resident = tpulbm_d3q19_resident(device);
  return resident < 0 ? -1 : march_for(cols, rows, nz, resident);
}

// The floats of the library's mode coefficients, which the caller's array
// must hold (its mode: collision_modes.cuh's tpulbm_collision_mode).
extern "C" int tpulbm_mode_floats() { return tpulbm3d::kModeFloats; }

// The populations of the library's velocity set (19 or 27).
extern "C" int tpulbm_lattice_q() { return kQ; }

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
