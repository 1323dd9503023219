// N fused D3Q19 or D3Q27 timesteps per launch (temporal blocking) on an
// NVIDIA Hopper GPU (sm_90a), float32, N = 2 or 3. Each substep is the
// 1-step kernel's sequence (step_d3q19.cu): collide (+ source, + the force
// profile's source along z) -> pull-stream with the ghost rule -> y walls
// -> z walls, then for the sphere in a duct -> equilibrium inlet ->
// zero-gradient outlet -> obstacle (pin or bounce-back); the Poiseuille
// duct has a periodic x instead, the fully periodic box wraps every axis
// and has no ghost and no wall.
//
// Replaces tpulbm/ops/step_pallas3d.py::make_local_step_pallas3d_tiled
// (:745) at n_sub = 2 and 3, the y-tiled z-plane cascade that tpulbm's
// one-device 3-D dispatch runs by default (parallel/sharded_step.py:175-198),
// with its src, bounce_back and periodic-x modes, its fully periodic boxes
// (the extended sweep over wrapped planes, :802-830, :1003, :1018) and
// force_fn, on either velocity set, under each collision of its
// _collide_planes_core (one library per collision, domain, source, force
// profile, obstacle rule and lattice, as step_d3q19.cu). Its plain version
// is N applications of tpulbm_torch/ops/step_torch.py's step.
//
// What bounds it: a launch moves the 153 B per cell of one step through
// device memory (read and write 19 f32, read the 1-byte mask) and advances
// N steps, so device-memory traffic falls to 153/N B per cell and step:
// 0.383 ms (N=2) and 0.255 ms (N=3) per step at 256^3 over 3.35 TB/s
// (D3Q27: 217/N B, 0.543 and 0.362 ms).
// Against it stand shared memory and redundant work: every substep but the
// last collides a tile widened by the substeps still to come.
//
// Design: the 1-step kernel's z-march, N stages deep, over a thread-block
// cluster. A block owns a kTileX x kTileY (x, y) column and marches z over
// kZChunk output planes; kClusterX x kClusterY blocks form a cluster, whose
// blocks march in step. Stage k < N holds the state after k substeps,
// collided, in a ring of planes. March step m loads and collides plane m
// (stage 0), then stage k computes plane m - k from stage k-1's ring (pull,
// boundary sequence, collide) and stage N pulls plane m - N from stage
// N-1's ring, runs the boundary sequence in registers and stores it. A
// block barrier follows each of the stages 0 .. N-1. Cells outside the
// domain are never computed or read: the ghost rule replaces them at every
// substep, so x validity and the z ghost planes need no extra storage. The
// mask is kept for the last N+2 z-planes over stage 0's cells, so no stage
// after the first reads device memory for it.
//
// The cluster (trapezoid validity). Stage k of a lone block would cover its
// tile widened by N - k cells on every side: the cells a pull at stage k+1
// needs. In a cluster, a block widens its tile only on the sides that face
// out of the cluster; on a side that faces a block of the cluster it
// computes only its own cells, and the one-cell frame its pulls need there
// comes from that neighbour: the neighbour stores each cell of stage k that
// lies in the frame into the block's ring (distributed shared memory,
// st.async), and each such store completes 4 bytes of the block's
// transaction barrier of stage k (mbarrier, hopper_async.cuh), which the
// block armed with the frame's bytes and waits on after its own block
// barrier. A frame receives every one of its cells at every stage, those
// outside the domain as zeros (no pull reads them), so its bytes do not
// depend on the domain. A neighbour may store into a frame slot only after
// the block has read that slot's last plane: one cluster barrier a march
// step, without memory ordering (barrier.cluster.arrive.relaxed at the end
// of the step, the wait before the next step's first store), orders that;
// a barrier that orders memory at every stage, as cooperative_groups'
// cluster sync does, waits for the stage's stores to device memory too and
// cost 0.27 ms a step at N=3 (PERF.md §6). The redundant collisions
// fall from those of a lone tile to those of the cluster's tile: D3Q19 at
// N=3, a lone 32 x 8, (38x14 + 36x12 + 34x10) / (3 x 256) = 1.70 collisions
// a cell and step; a 1 x 2 cluster of 32 x 8 (a 32 x 16 tile) (38x11 +
// 36x10 + 34x9) / (3 x 256) = 1.41. Grids are padded to whole clusters: a
// padded block holds cells outside the domain (or, where an axis wraps,
// wrapped cells), computes what tile_cell lets it, writes no output and
// joins every barrier.
//
// Stage 0 is fed a plane ahead. Once stage 1 of march step m has read
// them (its block barrier), plane m+1's slots in stage 0's ring are free
// (its pull reads planes m-2 .. m of classes 2 .. 0); every thread then
// issues asynchronous copies (cp.async, __pipeline_memcpy_async, 4 B: a row
// of the stage-0 region starts wherever the tile's widening puts it) of
// plane m+1's populations over its stage-0 cells into those slots, and
// loads their mask bytes into registers; stages 2 .. N of step m run while
// they arrive, and stage 0 of step m+1 waits for its own copies
// (__pipeline_wait_prior) and a block barrier, then collides each cell in
// place. The source address is the cell the march plane holds: x taken mod
// nx in the duct, x and y in the box, and the plane mod nz in the box
// (plane_of); in the ring build the cell's address in the block or its
// rings (Shard::find, locate), one copy a population: the rings' layouts
// differ from the block's, so there is no bulk copy of a row.
//
// Threads. A block has kThreads threads whatever its tile; every stage walks
// its cells kThreads at a time, one cell a thread at a time, so a thread
// holds one cell's populations (MRT's rank-10 correction and the power law's
// rate on top), not several. 512 threads leave a thread 128 registers.
//
// Shared memory is the design problem. A ring keeps each population only
// as long as a pull still needs it: those with cz = -1 are pulled from
// plane z+1 in the march step that writes them (one plane), cz = 0 from
// plane z one step later (two planes), cz = +1 from plane z-1 two steps
// later (three planes): 5 + 2*9 + 3*5 = 38 floats a cell instead of 3*19
// (D3Q27, whose classes hold 9 populations each: 9 + 2*9 + 3*9 = 54
// instead of 3*27). Beside the rings lie the mask planes and the
// transaction barriers. The tile is 32 x kBY, or where that would not fit a
// block's 232,448 B the largest 32 x kBY / 2^j that does (shallow_tile_y):
// in the 1 x 2 cluster D3Q19 takes 32 x 16 at N=2 (199,600 B; Bouzidi
// 225,520 B) and 32 x 8 at N=3 (183,304 B; Bouzidi 207,144 B), D3Q27 32 x 8
// at N=2 (160,432 B; Bouzidi 186,928 B) and 32 x 4 at N=3 (165,520 B;
// Bouzidi 192,880 B): one block an SM. The shape is the fastest of
// utils/tile_sweep.py's on an H100 at 256^3 (PERF.md §6: sphere-256
// under BGK, MRT and on D3Q27): 1 x 2 clusters of 512 threads beat lone
// blocks under BGK and MRT (on D3Q27 they lose 3% at N=3); wider clusters
// (2 x 1, 2 x 2, 2 x 4, 1 x 4) lose to both: their transaction barriers and
// distributed stores cost more than the collisions they save.
//
// The deep build (N = 4-8) runs the same march with a lone block (no
// cluster) and stage 0 loading device memory straight into registers, one
// cell at a time. Stage k's ring over the tile widened by N-k no longer fits one
// block's shared memory at 32 x 8, so each depth takes the largest tile that
// fits (deep_tile: the largest area, then the widest, of widths 4-32 and
// heights 1-8; per lattice and Bouzidi): D3Q19 32x4, 16x4, 8x8, 8x4, 4x2 at
// N = 4-8 (Bouzidi 16x8, 16x4, 16x2, 8x2, 4x2), D3Q27 32x2, 8x8, 8x4, 4x2 at
// N = 4-7 (Bouzidi 16x4, 8x4, 8x2, 4x1). At N=8 D3Q27 fits no tile, not even
// 4x1 (260,928 B). That depth keeps its stage rings in a scratch buffer in
// device memory that the caller allocates, one slice per resident block,
// and its blocks walk the tiles (8 x 8) in a persistent loop; the z-march,
// the barriers and the bits are those of the shared-memory builds, and the
// mask stays in shared memory. Redundant work grows with N: at N=8 a D3Q19
// 4x2 tile's stages collide 164 cells for each of its 8 (20x a step's
// cells), the 8x8 scratch tile's 39.
//
// The zero-gradient outlet reads x = nx-2 (step_cell in d3q19_common.cuh),
// which needs x = nx-3 .. nx-1 of the ring at every stage. The x tiles are
// right-aligned as in the 1-step kernel, and the block that holds nx-1 is the
// rightmost of its cluster, so it holds that neighbourhood at every stage;
// the ragged tile is the leftmost one, masked. Population-plane offsets are
// 64-bit. In the duct the tiles' x-halo wraps: a cell at x < 0 or x >= nx
// holds cell x mod nx, loaded from there and stepped like every other cell
// (the duct's rules do not depend on x), so the trapezoid of valid cells is
// that of an interior cluster.
// In the box the y-halo wraps the same way, and the z march is tpulbm's
// extended sweep: stage k computes the planes [z0 - (N-k), z1 + (N-k)) with
// no clamp at the domain's z edges, a plane p outside [0, nz) being plane
// p mod nz, loaded from there (the N planes before and after the block's
// chunk: tpulbm's 2N refetched planes). The ring slots follow the
// unwrapped index p, so the sweep holds for an nz smaller than the
// 64-plane chunk, down to nz = 1.
//
// The force profile (-DTPULBM_FORCE=1): each substep adds the source column
// of the table at the plane of the cell that owns it (p mod nz), as the
// 1-step kernel does, so one launch gives the bits of N launches.
//
// The Bouzidi obstacle (-DTPULBM_BOUZIDI=1): every stage rewrites the cut
// links of its cells whose mask byte carries kLinkBit (apply_bouzidi), from
// the link table at the cell's global index and the cell's own
// post-collision values of that substep in the previous stage's ring.
// Those of class 0 (cz = -1) are pulled from the plane above a march step
// before the cell itself is computed, so under kBouzidi class 0 keeps two
// slots (43 floats a cell instead of 38; on D3Q27 63 instead of 54).
//
// Built with -DTPULBM_RINGS=1 the kernel steps one shard of a mesh
// (tpulbm3d::Shard): make_local_step_pallas3d_tiled at n_sub 2, 3 with its
// ring inputs, N rows deep, and on a mesh that cuts x its N columns deep
// x rings (x_halo). The output tiles cover the shard's block, right-aligned
// to its last column; every stage's cells take their populations from the
// block or the rings (find(), locate()), so no cell wraps inside the block
// on a cut axis: the duct's wrapped x columns and the box's wrapped rows
// come from the rings. A stage computes only the window cells the block
// and its rings hold; the trapezoid keeps the rest out of every cell the
// launch writes. Under kBouzidi (on a mesh that keeps x whole, as tpulbm's
// dispatch runs it) the cut links read the shard's padded link table.
//
// Knobs (utils/tile_sweep.py builds the source with other values):
// -DTPULBM_TILE_Y (kBY), -DTPULBM_CLUSTER_X, -DTPULBM_CLUSTER_Y,
// -DTPULBM_THREADS, -DTPULBM_ZCHUNK; the libraries the port loads use the
// defaults below.
//
// Bits. Collision, pull and boundary code come from d3q19_common.cuh,
// shared with step_d3q19.cu, and both libraries are built with -fmad=false:
// one launch gives the same bits as N launches of the 1-step kernel.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "d3q19_common.cuh"
#include "hopper_async.cuh"

#ifndef TPULBM_TILE_Y
#define TPULBM_TILE_Y 16
#endif
#ifndef TPULBM_CLUSTER_X
#define TPULBM_CLUSTER_X 1
#endif
#ifndef TPULBM_CLUSTER_Y
#define TPULBM_CLUSTER_Y 2
#endif
#ifndef TPULBM_THREADS
#define TPULBM_THREADS 512
#endif
#ifndef TPULBM_ZCHUNK
#define TPULBM_ZCHUNK 64
#endif

namespace {

namespace cg = cooperative_groups;
using tpulbm3d::Consts;
using tpulbm3d::kQ;

constexpr int kBX = 32;                // tile width: one warp per row
constexpr int kBY = TPULBM_TILE_Y;     // tile height, halved where needed
constexpr int kClusterX = TPULBM_CLUSTER_X;  // blocks of a cluster in x
constexpr int kClusterY = TPULBM_CLUSTER_Y;  // and in y
constexpr int kThreadsN = TPULBM_THREADS;    // threads of a block
constexpr int kZChunk = TPULBM_ZCHUNK;  // output z-planes a block marches
constexpr size_t kMaxBlockSmem = 232448;  // what a block may take on sm_90
constexpr int kDeepThreads = 256;  // threads of a deep build's block
constexpr int kScratchTile = 8;    // the scratch build's tile: 8 x 8
// added to a z-plane before its ring slot is taken (slots_of): q >= -4 at
// N <= 3, q >= -9 at N <= 8
constexpr int kSlotBias = tpulbm::kDeep ? 12 : 6;
static_assert(kClusterX >= 1 && kClusterY >= 1 &&
                  kClusterX * kClusterY <= 16,
              "a cluster holds at most 16 blocks");
static_assert(kThreadsN % 32 == 0 && kThreadsN <= 1024,
              "whole warps, at most 1024 threads");

// cz of population i, from the table
__host__ __device__ constexpr int cz_of(int i) {
#define TPULBM_CZ_CASE(i_, cx, cy, cz, o) \
  if (i == (i_)) return (cz);
  TPULBM_LAT3D(TPULBM_CZ_CASE)
#undef TPULBM_CZ_CASE
  return 0;
}

// A ring keeps population class c = cz + 1 in class_slots(c) slots of
// class_size(c) planes each (a plane: one population over the ring's
// cells): class 0 (pulled from z+1) one slot, class 1 (from z) two, class 2
// (from z-1) three, the slot of z-plane q being (q + kSlotBias) %
// class_slots(c), the bias a multiple of 6 that keeps q + kSlotBias >= 0
// for every plane a march reads (the box's extended sweep starts N planes
// below its chunk, and a pull reads one plane further).
// The Bouzidi rewrite also reads a cell's own post-collision populations,
// those of class 0 included, a plane after they were pulled: under
// kBouzidi class 0 keeps two slots. class_size counts the set's
// populations with cz = c - 1: 5, 9, 5 on D3Q19, 9, 9, 9 on D3Q27.
__host__ __device__ constexpr int class_size(int c) {
  int n = 0;
  for (int i = 0; i < kQ; ++i) n += cz_of(i) + 1 == c ? 1 : 0;
  return n;
}
__host__ __device__ constexpr int class_slots(int c) {
  return c + 1 + (tpulbm3d::kBouzidi && c == 0 ? 1 : 0);
}
__host__ __device__ constexpr int class_base(int c) {
  return c == 0   ? 0
         : c == 1 ? class_slots(0) * class_size(0)
                  : class_slots(0) * class_size(0) +
                        class_slots(1) * class_size(1);
}
constexpr int kRingFloats = class_slots(0) * class_size(0) +
                            class_slots(1) * class_size(1) +
                            class_slots(2) * class_size(2);

// i's position among the populations of its class
__host__ __device__ constexpr int rank_in_class(int i) {
  int n = 0;
  for (int j = 0; j < i; ++j) n += cz_of(j) == cz_of(i) ? 1 : 0;
  return n;
}

// Population I's class and its plane in slot 0, as constants.
template <int I>
struct RingPop {
  static constexpr int kClass = cz_of(I) + 1;
  static constexpr int kFirst = class_base(kClass) + rank_in_class(I);
};

// Every population of a z-plane on its own ring plane, inside the ring.
constexpr bool ring_planes_distinct() {
  for (int q = 0; q < 6; ++q) {
    for (int a = 0; a < kQ; ++a) {
      const int c = cz_of(a) + 1;
      const int pa = class_base(c) + rank_in_class(a) +
                     (q % class_slots(c)) * class_size(c);
      if (pa < 0 || pa >= kRingFloats) return false;
      for (int b = 0; b < a; ++b) {
        const int cb = cz_of(b) + 1;
        if (pa == class_base(cb) + rank_in_class(b) +
                      (q % class_slots(cb)) * class_size(cb)) {
          return false;
        }
      }
    }
  }
  return true;
}
static_assert(kQ != 19 || tpulbm3d::kBouzidi || kRingFloats == 38,
              "5 + 2 * 9 + 3 * 5 floats a cell");
static_assert(kQ != 19 || !tpulbm3d::kBouzidi || kRingFloats == 43,
              "2 * 5 + 2 * 9 + 3 * 5 floats a cell under kBouzidi");
static_assert(kQ != 27 || tpulbm3d::kBouzidi || kRingFloats == 54,
              "9 + 2 * 9 + 3 * 9 floats a cell on D3Q27");
static_assert(kQ != 27 || !tpulbm3d::kBouzidi || kRingFloats == 63,
              "2 * 9 + 2 * 9 + 3 * 9 floats a cell on D3Q27 under kBouzidi");
static_assert(ring_planes_distinct(), "ring planes overlap");

// The offsets, in floats, of the class-0, class-1 and class-2 slots that
// hold z-plane q (q >= -kSlotBias) in a ring of C cells.
struct Slots {
  int c0, c1, c2;
};
template <int C>
__device__ __forceinline__ Slots slots_of(int q) {
  return {((q + kSlotBias) % class_slots(0)) * class_size(0) * C,
          ((q + kSlotBias) % class_slots(1)) * class_size(1) * C,
          ((q + kSlotBias) % class_slots(2)) * class_size(2) * C};
}

// The slots a pull of plane p reads: class 0 of plane p+1, class 1 of p,
// class 2 of p-1.
template <int C>
__device__ __forceinline__ Slots pull_slots(int p) {
  return {slots_of<C>(p + 1).c0, slots_of<C>(p).c1, slots_of<C>(p - 1).c2};
}

// The float offset of population I of the z-plane whose slots are s.
template <int I, int C>
__device__ __forceinline__ int ring_at(const Slots& s) {
  constexpr int c = RingPop<I>::kClass;
  return RingPop<I>::kFirst * C + (c == 0 ? s.c0 : c == 1 ? s.c1 : s.c2);
}

// How far stage k's cells reach past the tile along an axis of `blocks`
// blocks of the cluster, d = N - k substeps from the end: d on both sides
// of a lone block, d on the one outer side of a block of two or more (none
// on the sides that face the cluster's other blocks).
__host__ __device__ constexpr int reach(int blocks, int d) {
  return blocks == 1 ? 2 * d : d;
}

// The geometry of a block of an x by y tile at depth n in a cx by cy
// cluster, every size the largest over the cluster's blocks:
// stage k computes pwidth x pheight cells, its ring adds the one-cell frame
// on the sides that face the cluster (width x height); stage 0's cells hold
// the mask planes.
struct Geometry {
  int n, x, y, cx, cy;
  __host__ __device__ constexpr int pwidth(int k) const {
    return x + reach(cx, n - k);
  }
  __host__ __device__ constexpr int pheight(int k) const {
    return y + reach(cy, n - k);
  }
  __host__ __device__ constexpr int width(int k) const {
    return pwidth(k) + (cx > 1 ? 1 : 0);
  }
  __host__ __device__ constexpr int height(int k) const {
    return pheight(k) + (cy > 1 ? 1 : 0);
  }
  __host__ __device__ constexpr size_t ring_cells() const {
    size_t c = 0;
    for (int k = 0; k < n; ++k) c += static_cast<size_t>(width(k)) * height(k);
    return c;
  }
  // the bytes of the rings (none where they lie in the scratch buffer)
  // and of the N + 2 mask planes; in a cluster of two or more blocks then
  // N transaction barriers of 8 B, 8-aligned
  __host__ __device__ constexpr size_t barrier_offset(bool scratch) const {
    const size_t cells0 = static_cast<size_t>(pwidth(0)) * pheight(0);
    return ((scratch ? 0 : sizeof(float) * kRingFloats * ring_cells()) +
            (n + 2) * cells0 + 7) / 8 * 8;
  }
  __host__ __device__ constexpr size_t smem(bool scratch) const {
    const size_t cells0 = static_cast<size_t>(pwidth(0)) * pheight(0);
    return cx * cy > 1 ? barrier_offset(scratch) + 8 * n
                       : (scratch ? 0 : sizeof(float) * kRingFloats *
                                            ring_cells()) +
                             (n + 2) * cells0;
  }
};

// A tile's width and height.
struct TileShape {
  int x, y;
};

// The deep build's tile at depth n: of widths 32, 16, 8, 4 and heights 8,
// 4, 2, 1, the largest area whose rings and mask fit a lone block's shared
// memory, the widest of those; {0, 0} where none fits.
__host__ __device__ constexpr TileShape deep_tile(int n) {
  for (int area = 256; area >= 4; area /= 2) {
    for (int x = 32; x >= 4; x /= 2) {
      const int y = area / x;
      if (y >= 1 && y <= 8 &&
          Geometry{n, x, y, 1, 1}.smem(false) <= kMaxBlockSmem) {
        return {x, y};
      }
    }
  }
  return {0, 0};
}
static_assert(kQ != 19 || tpulbm3d::kBouzidi ||
                  (deep_tile(4).x == 32 && deep_tile(4).y == 4 &&
                   deep_tile(8).x == 4 && deep_tile(8).y == 2),
              "D3Q19's deep tiles");
static_assert(kQ != 27 || (deep_tile(8).x == 0 && deep_tile(7).x == 4),
              "D3Q27 at N=8 fits no tile");

// The default build's tile height at depth n: kBY, or the largest kBY / 2^j
// whose rings and mask fit a block in the cluster (0 where none does).
__host__ __device__ constexpr int shallow_tile_y(int n) {
  for (int y = kBY; y >= 1; y /= 2) {
    if (Geometry{n, kBX, y, kClusterX, kClusterY}.smem(false) <=
        kMaxBlockSmem) {
      return y;
    }
  }
  return 0;
}

template <int N>
struct Tile {
  static_assert(N >= 2, "one step per launch is step_d3q19.cu");
  static constexpr bool kDeep = tpulbm::kDeep;
  // the deep depth's rings in device memory: no tile fits shared memory
  static constexpr bool kScratch = kDeep && deep_tile(N).x == 0;
  // the cluster (one block in the deep build) and the output tile
  static constexpr int kCX = kDeep ? 1 : kClusterX;
  static constexpr int kCY = kDeep ? 1 : kClusterY;
  static constexpr bool kCluster = kCX * kCY > 1;
  static constexpr int kTileX = !kDeep   ? kBX
                                : kScratch ? kScratchTile
                                           : deep_tile(N).x;
  static constexpr int kTileY = !kDeep   ? shallow_tile_y(N)
                                : kScratch ? kScratchTile
                                           : deep_tile(N).y;
  static_assert(kTileY > 0, "no tile fits a block's shared memory");
  static constexpr int kTileCells = kTileX * kTileY;
  static constexpr int kThreads = kDeep ? kDeepThreads : kThreadsN;
  // stage 0 collides the plane the copies put into its ring a plane ahead
  static constexpr bool kStaged = !kDeep;
  static constexpr Geometry kGeo{N, kTileX, kTileY, kCX, kCY};
  __host__ __device__ static constexpr int pwidth(int k) {
    return kGeo.pwidth(k);
  }
  __host__ __device__ static constexpr int pcells(int k) {
    return kGeo.pwidth(k) * kGeo.pheight(k);
  }
  __host__ __device__ static constexpr int width(int k) {
    return kGeo.width(k);
  }
  __host__ __device__ static constexpr int cells(int k) {
    return kGeo.width(k) * kGeo.height(k);
  }
  __host__ __device__ static constexpr int ring_offset(int k) {
    return k == 0 ? 0 : ring_offset(k - 1) + kRingFloats * cells(k - 1);
  }
  // stage 0's cells a thread visits (the staged build keeps their mask
  // bytes in registers from the copies' issue to the next stage 0)
  static constexpr int kVisits0 = (pcells(0) + kThreads - 1) / kThreads;
  // after the rings: the masks of z-planes m-N-1 .. m over stage 0's cells
  // (stage N reads plane m-N while stage 0 of the next march step, after
  // no barrier, writes plane m+1)
  static constexpr int kMaskSlots = N + 2;
  static constexpr int kMaskOffset = ring_offset(N);
  // the rings in shared memory before the mask, or (kScratch) in a slice
  // of ring_offset(N) floats of the scratch buffer, the mask alone in
  // shared memory
  // in a cluster, the transaction barriers of stages 0 .. N-1 (bytes)
  static constexpr size_t kBarrierOffset = kGeo.barrier_offset(kScratch);
  static constexpr size_t kSmemBytes = kGeo.smem(kScratch);
  static_assert(kSmemBytes == (kCluster ? kBarrierOffset + 8 * N
                                        : (kScratch ? 0
                                                    : sizeof(float) *
                                                          kMaskOffset) +
                                              kMaskSlots * pcells(0)),
                "the layout adds up");
  static_assert(kSmemBytes <= kMaxBlockSmem, "rings exceed a block's 227 KB");
};

// Store one cell's collided populations at cell `at` of a ring of C cells,
// in the slots s of their z-plane.
template <int C>
__device__ __forceinline__ void store_ring(float* ring, const Slots& s, int at,
                                           const float* v) {
#define TPULBM_STORE(i, cx, cy, cz, o) ring[ring_at<i, C>(s) + at] = v[i];
  TPULBM_LAT3D(TPULBM_STORE)
#undef TPULBM_STORE
}

// Whether a cell at global (x, y) is stepped: a cell of the domain, or in
// the duct any cell of a domain row, x then taken mod nx (the cell it
// holds), or in the box any cell, x taken mod nx and y mod ny.
__device__ __forceinline__ bool tile_cell(int& x, int& y, int nx, int ny) {
  if constexpr (tpulbm3d::kPeriodicX) {
    x %= nx;
    if (x < 0) x += nx;
  }
  if constexpr (tpulbm3d::kPeriodicY) {
    y %= ny;
    if (y < 0) y += ny;
  }
  return (tpulbm3d::kPeriodicX || (x >= 0 && x < nx)) &&
         (tpulbm3d::kPeriodicY || (y >= 0 && y < ny));
}

// The plane of the domain that z-plane p of the march holds: p itself, or
// in the box p mod nz (the extended sweep's planes outside [0, nz)).
__device__ __forceinline__ int plane_of(int p, int nz) {
  if constexpr (tpulbm3d::kPeriodicZ) {
    p %= nz;
    if (p < 0) p += nz;
  }
  return p;
}

// What every stage of a block shares, beside the constants (read where
// they lie, in the kernel's parameters).
struct March {
  int nx, ny, nz;
  int x0, y0, z0, z1;  // the output tile's origin, its z-planes [z0, z1)
  int px, py;          // the block's column and row in its cluster
  // 1 where the block's left, right, bottom, top side faces out of the
  // cluster (every side of a lone block), else 0
  int ol, orr, ob, ot;
  const float* force;  // the force profile's (Q, nz) table (kForce)
};

// What ends stage K of a march step: a block barrier (the stage's cells
// in the block's ring), and in a cluster the wait for the neighbours'
// stores into the frame, counted by the stage's transaction barrier, whose
// phase parity the block keeps in `phases` (a bit a stage).
template <int N, int K>
__device__ __forceinline__ void end_stage(uint64_t* bars, uint32_t& phases) {
  __syncthreads();
  if constexpr (Tile<N>::kCluster) {
    tpulbm_async::wait_phase(bars + K, (phases >> K) & 1u);
    phases ^= 1u << K;
  }
}

// In a cluster, the first thread arms stage K's transaction barrier for the
// frame's bytes: the cells of the block's ring of stage K that are not its
// own, every population, each stored there by the neighbour that computes
// it.
template <int N, int K>
__device__ __forceinline__ void arm_frame(uint64_t* bars, const March& g) {
  using T = Tile<N>;
  if constexpr (T::kCluster) {
    if (threadIdx.x == 0) {
      const int aw = T::kTileX + (g.ol + g.orr) * (N - K);
      const int ah = T::kTileY + (g.ob + g.ot) * (N - K);
      const int frame =
          (aw + 2 - g.ol - g.orr) * (ah + 2 - g.ob - g.ot) - aw * ah;
      tpulbm_async::arm_bytes(
          bars + K, static_cast<uint32_t>(frame * kQ * sizeof(float)));
    }
  }
}

// Stage K's cell (lx, ly) of the block's region in global, unwrapped
// coordinates (x, y): the region starts N - K cells before the tile on an
// outer side, at the tile on a side that faces the cluster.
template <int N, int K>
__device__ __forceinline__ void cell_at(const March& g, int lx, int ly, int& x,
                                        int& y) {
  x = g.x0 - g.ol * (N - K) + lx;
  y = g.y0 - g.ob * (N - K) + ly;
}

// Whether the region's cell t (of pcells(K)) is one of this block's: the
// region's size is the largest over the cluster's blocks, a middle block's
// is smaller.
template <int N, int K>
__device__ __forceinline__ bool region_cell(const March& g, int t, int& lx,
                                            int& ly) {
  using T = Tile<N>;
  constexpr int PW = T::pwidth(K);
  ly = t / PW;
  lx = t - ly * PW;
  if constexpr (T::kCX > 2 || T::kCY > 2) {
    return lx < T::kTileX + (g.ol + g.orr) * (N - K) &&
           ly < T::kTileY + (g.ob + g.ot) * (N - K);
  }
  return true;
}

// Stage K's cell (lx, ly) of the block's region, in the block's ring.
template <int N, int K>
__device__ __forceinline__ int ring_cell(const March& g, int lx, int ly) {
  return (ly + 1 - g.ob) * Tile<N>::width(K) + lx + 1 - g.ol;
}

// Store stage K's cell (lx, ly) of the region where it lies in a
// neighbour's frame into that neighbour's ring (distributed shared memory,
// st.async: each store completes 4 bytes of the neighbour's transaction
// barrier of stage K), whether the cell is stepped or not (then v holds
// zeros), so that a frame receives its bytes whatever the domain. A
// neighbour's ring starts one cell before its tile on a side that faces
// the cluster, N - K cells on an outer side.
template <int N, int K>
__device__ __forceinline__ void push(const float* ring, const Slots& s,
                                     const uint64_t* bars, const March& g,
                                     int lx, int ly, const float* v) {
  using T = Tile<N>;
  if constexpr (T::kCluster) {
    constexpr int W = T::width(K);
    constexpr int C = T::cells(K);
    const int tx = lx - g.ol * (N - K);  // the cell in the tile
    const int ty = ly - g.ob * (N - K);
    const int sx0 = tx == 0 && g.px > 0 ? -1 : 0;
    const int sx1 = tx == T::kTileX - 1 && g.px < T::kCX - 1 ? 1 : 0;
    const int sy0 = ty == 0 && g.py > 0 ? -1 : 0;
    const int sy1 = ty == T::kTileY - 1 && g.py < T::kCY - 1 ? 1 : 0;
    if (sx0 == 0 && sx1 == 0 && sy0 == 0 && sy1 == 0) return;
    for (int sy = sy0; sy <= sy1; ++sy) {
      for (int sx = sx0; sx <= sx1; ++sx) {
        if (sx == 0 && sy == 0) continue;
        const int qx = g.px + sx;
        const int qy = g.py + sy;
        const int col = tx - sx * T::kTileX + (qx == 0 ? N - K : 1);
        const int row = ty - sy * T::kTileY + (qy == 0 ? N - K : 1);
        // the cluster's rank of block (qx, qy): x tiles count from the
        // right, so column qx has the rank kCX - 1 - qx along x
        const uint32_t rank =
            static_cast<uint32_t>(T::kCX - 1 - qx + qy * T::kCX);
        const float* at = ring + row * W + col;
#define TPULBM_PUSH(i, cx, cy, cz, o) \
  tpulbm_async::store_remote(at + ring_at<i, C>(s), bars + K, rank, v[i]);
        TPULBM_LAT3D(TPULBM_PUSH)
#undef TPULBM_PUSH
      }
    }
  }
}

// Stage K (0 < K < N) at march step m: plane m - K of the state after K
// substeps over the block's region of stage K, pulled from stage K-1's
// ring, stepped and collided into stage K's ring; then the barrier, and
// after stage 1's `after1()`.
template <int N, int K, class After1>
__device__ __forceinline__ void inner_stages(
    float* rings, const uint8_t* masks, uint64_t* bars, uint32_t& phases,
    const March& g, const Consts& k, const tpulbm::Links& links,
    const tpulbm3d::Shard& sh, int m, const After1& after1) {
  if constexpr (K < N) {
    using T = Tile<N>;
    constexpr int C = T::cells(K);
    constexpr int Ws = T::width(K - 1);
    constexpr int Cs = T::cells(K - 1);
    constexpr int PW0 = T::pwidth(0);
    const float* src = rings + T::ring_offset(K - 1);
    float* dst = rings + T::ring_offset(K);
    const int p = m - K;
    // the mask slots hold z-planes of the domain (the box reads no mask)
    const uint8_t* mask =
        masks + (p >= 0 ? p % T::kMaskSlots : 0) * T::pcells(0);
    // the box sweeps past the z edges (the extended sweep)
    const int lo = tpulbm3d::kPeriodicZ || g.z0 - (N - K) > 0
                       ? g.z0 - (N - K) : 0;
    const int hi = tpulbm3d::kPeriodicZ || g.z1 + (N - K) < g.nz
                       ? g.z1 + (N - K) : g.nz;
    const int pz = plane_of(p, g.nz);
    if (p >= lo && p < hi) {
      const Slots rd = pull_slots<Cs>(p);
      const Slots own = slots_of<Cs>(p);
      const Slots wr = slots_of<C>(p);
      arm_frame<N, K>(bars, g);
      for (int t = threadIdx.x; t < T::pcells(K); t += T::kThreads) {
        int lx, ly, x, y;
        if (!region_cell<N, K>(g, t, lx, ly)) continue;
        cell_at<N, K>(g, lx, ly, x, y);
        int bx = 0, by = 0;  // the cell in the shard's block (kRings)
        float v[kQ];
        const bool stepped = tpulbm::kRings
                                 ? sh.find(x, y, g.nx, g.ny, bx, by)
                                 : tile_cell(x, y, g.nx, g.ny);
        if (!stepped) {
          if constexpr (T::kCluster) {
#pragma unroll
            for (int i = 0; i < kQ; ++i) v[i] = 0.0f;
            push<N, K>(dst, wr, bars, g, lx, ly, v);
          }
          continue;
        }
        const int at = (ly + 1) * Ws + lx + 1;  // this cell in stage K-1
        const int at0 = (ly + g.ob * K) * PW0 + lx + g.ol * K;  // stage 0
        bool solid = false;
        if constexpr (tpulbm3d::kBounceBack)
          solid = tpulbm3d::is_solid(mask[at0]);
        tpulbm3d::step_cell(
            v, [&](int ox) { return tpulbm3d::is_solid(mask[at0 + ox]); }, x,
            y, p, g.nx, g.ny, g.nz, k, [&](auto i, int ox, int oy, int oz) {
              return src[ring_at<decltype(i)::value, Cs>(rd) + at + oy * Ws +
                         ox];
            });
        if constexpr (tpulbm3d::kBouzidi) {
          // this substep's own post-collision values, in stage K-1's
          // ring, which stage K does not write
          if (mask[at0] & tpulbm::kLinkBit) {
            const size_t cell =
                tpulbm::kRings
                    ? sh.padded(bx, by, pz)
                    : (static_cast<size_t>(p) * g.ny + y) * g.nx + x;
            tpulbm3d::apply_bouzidi(
                v, links.q + cell, links.plane, links.moving != 0,
                [&](auto i) {
                  return src[ring_at<decltype(i)::value, Cs>(own) + at];
                });
          }
        }
        tpulbm3d::collide_cell(v, k, solid, g.force + pz, g.nz);
        store_ring<C>(dst, wr, ring_cell<N, K>(g, lx, ly), v);
        push<N, K>(dst, wr, bars, g, lx, ly, v);
      }
      end_stage<N, K>(bars, phases);
    } else {
      __syncthreads();
    }
    if constexpr (K == 1) after1();
    inner_stages<N, K + 1>(rings, masks, bars, phases, g, k, links, sh, m,
                           after1);
  }
}

// Whether stage 0 runs at march plane q: a plane of the domain, or any in
// the box.
__device__ __forceinline__ bool loads_plane(int q, int nz) {
  return tpulbm3d::kPeriodicZ || (q >= 0 && q < nz);
}

// Stage 0's cell (lx, ly) of the region: where its populations and its
// mask byte lie in device memory at plane mz (population i `stride` floats
// after the first), or false where the cell is not stepped.
template <int N>
__device__ __forceinline__ bool stage0_source(
    const March& g, const float* f, const uint8_t* solid,
    const tpulbm3d::Shard& sh, int lx, int ly, int mz, const float*& src,
    size_t& stride, const uint8_t*& mask_byte) {
  int x, y;
  cell_at<N, 0>(g, lx, ly, x, y);
  if constexpr (tpulbm::kRings) {
    int bx, by;
    if (!sh.find(x, y, g.nx, g.ny, bx, by)) return false;
    mask_byte = sh.mask + sh.padded(bx, by, mz);
    src = sh.locate(bx, by, mz, stride);
  } else {
    if (!tile_cell(x, y, g.nx, g.ny)) return false;
    const size_t cell = (static_cast<size_t>(mz) * g.ny + y) * g.nx + x;
    mask_byte = solid + cell;
    src = f + cell;
    stride = static_cast<size_t>(g.nx) * g.ny * g.nz;
  }
  return true;
}

// The staged build's copies of march plane q into stage 0's ring, at the
// slots plane q takes there (free once stage 1 of march step q-1 has read
// them: its pull reads planes q-3 .. q-1 of classes 2 .. 0): one cp.async of
// 4 B a population and cell, one group a thread, and its mask bytes into
// `pending`; nothing where stage 0 does not run at q. Stage 0 collides each
// cell in place.
template <int N>
__device__ __forceinline__ void prefetch(
    float* rings, uint8_t (&pending)[Tile<N>::kVisits0], const March& g,
    const float* f, const uint8_t* solid, const tpulbm3d::Shard& sh, int q) {
  using T = Tile<N>;
  constexpr int C0 = T::cells(0);
  if (!loads_plane(q, g.nz)) return;
  const int qz = plane_of(q, g.nz);
  const Slots wr = slots_of<C0>(q);
#pragma unroll
  for (int j = 0; j < T::kVisits0; ++j) {
    const int t = threadIdx.x + j * T::kThreads;
    int lx, ly;
    const float* src;
    size_t stride;
    const uint8_t* mask_byte;
    if (t < T::pcells(0) && region_cell<N, 0>(g, t, lx, ly) &&
        stage0_source<N>(g, f, solid, sh, lx, ly, qz, src, stride,
                         mask_byte)) {
      if constexpr (tpulbm3d::kHasObstacle) pending[j] = *mask_byte;
      float* dst = rings + ring_cell<N, 0>(g, lx, ly);
#define TPULBM_COPY(i, cx, cy, cz, o)                                   \
  __pipeline_memcpy_async(dst + ring_at<i, C0>(wr), src + (i) * stride, \
                          sizeof(float));
      TPULBM_LAT3D(TPULBM_COPY)
#undef TPULBM_COPY
    }
  }
  __pipeline_commit();
}

// One block's z-march over the output tile (tx0, ty0) of z-chunk tz: the
// stage rings in `rings` (shared memory, or the block's slice of the
// scratch buffer) and the mask planes in `mask` (shared memory).
template <int N>
__device__ __forceinline__ void march(
    const float* __restrict__ f, float* __restrict__ out,
    const uint8_t* __restrict__ solid, const float* __restrict__ force,
    int nx, int ny, int nz, const Consts& k, const tpulbm::Links& links,
    const tpulbm3d::Shard& sh, int tx0, int ty0, int tz, float* rings,
    uint8_t* mask, uint64_t* bars) {
  using T = Tile<N>;

  March g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  // right-aligned to the last column of the grid (of the shard's block)
  g.x0 = (tpulbm::kRings ? sh.x0 + sh.nxl : nx) - T::kTileX * (tx0 + 1);
  g.y0 = (tpulbm::kRings ? sh.y0 : 0) + ty0 * T::kTileY;
  g.z0 = tz * kZChunk;
  g.z1 = g.z0 + kZChunk < nz ? g.z0 + kZChunk : nz;
  // tile tx0 counts from the right: the cluster's first x rank is its
  // rightmost block
  g.px = T::kCX - 1 - tx0 % T::kCX;
  g.py = ty0 % T::kCY;
  g.ol = T::kCX == 1 || g.px == 0;
  g.orr = T::kCX == 1 || g.px == T::kCX - 1;
  g.ob = T::kCY == 1 || g.py == 0;
  g.ot = T::kCY == 1 || g.py == T::kCY - 1;
  g.force = force;
  const size_t plane = static_cast<size_t>(nx) * ny;
  const int tid = threadIdx.x;
  constexpr int PW0 = T::pwidth(0);
  constexpr int PC0 = T::pcells(0);
  constexpr int W_last = T::width(N - 1);
  constexpr int C_last = T::cells(N - 1);
  const float* last = rings + T::ring_offset(N - 1);
  uint8_t pending[T::kVisits0];  // the mask bytes of the plane in flight
  uint32_t phases = 0;           // the transaction barriers' parities

  if constexpr (T::kStaged) prefetch<N>(rings, pending, g, f, solid, sh,
                                        g.z0 - N);
  for (int m = g.z0 - N; m < g.z1 + N; ++m) {
    // in a cluster, no block stores into a neighbour's frame of this march
    // step before the neighbour has read the frames of the last one
    if constexpr (T::kCluster) {
      if (m > g.z0 - N) tpulbm_async::cluster_wait();
    }
    // stage 0: plane m (in the box plane m mod nz) over the block's region
    // of stage 0: keep its mask, collide and keep the populations
    if (loads_plane(m, nz)) {
      const int mz = plane_of(m, nz);
      const Slots wr = slots_of<T::cells(0)>(m);
      uint8_t* mask_m = mask + (m >= 0 ? m % T::kMaskSlots : 0) * PC0;
      if constexpr (T::kStaged) {
        __pipeline_wait_prior(0);  // this thread's copies of plane m
        __syncthreads();           // and every other thread's
      }
      arm_frame<N, 0>(bars, g);
#pragma unroll
      for (int j = 0; j < T::kVisits0; ++j) {
        const int t = tid + j * T::kThreads;
        int lx, ly;
        const float* src;
        size_t stride;
        const uint8_t* mask_byte;
        if (t >= PC0 || !region_cell<N, 0>(g, t, lx, ly)) continue;
        float v[kQ];
        if (!stage0_source<N>(g, f, solid, sh, lx, ly, mz, src, stride,
                              mask_byte)) {
          if constexpr (T::kCluster) {
#pragma unroll
            for (int i = 0; i < kQ; ++i) v[i] = 0.0f;
            push<N, 0>(rings, wr, bars, g, lx, ly, v);
          }
          continue;
        }
        if constexpr (T::kStaged) {
          if constexpr (tpulbm3d::kHasObstacle) mask_m[t] = pending[j];
          const float* raw = rings + ring_cell<N, 0>(g, lx, ly);
#define TPULBM_TAKE(i, cx, cy, cz, o) v[i] = raw[ring_at<i, T::cells(0)>(wr)];
          TPULBM_LAT3D(TPULBM_TAKE)
#undef TPULBM_TAKE
        } else {
          if constexpr (tpulbm3d::kHasObstacle) mask_m[t] = *mask_byte;
#pragma unroll
          for (int i = 0; i < kQ; ++i) v[i] = src[i * stride];
        }
        tpulbm3d::collide_cell(
            v, k, tpulbm3d::kBounceBack && tpulbm3d::is_solid(mask_m[t]),
            force + mz, nz);
        store_ring<T::cells(0)>(rings, wr, ring_cell<N, 0>(g, lx, ly), v);
        push<N, 0>(rings, wr, bars, g, lx, ly, v);
      }
      end_stage<N, 0>(bars, phases);
    } else {
      __syncthreads();
    }
    // once stage 1 has read them, stage 0's slots of plane m+1 take its
    // populations during stages 2 .. N
    inner_stages<N, 1>(rings, mask, bars, phases, g, k, links, sh, m, [&] {
      if constexpr (T::kStaged) {
        if (m + 1 < g.z1 + N) prefetch<N>(rings, pending, g, f, solid, sh,
                                          m + 1);
      }
    });
    // stage N: plane m - N of the tile, stored
    const int p = m - N;
    if (p >= g.z0 && p < g.z1) {
      const Slots rd = pull_slots<C_last>(p);
      const uint8_t* mask_p = mask + (p % T::kMaskSlots) * PC0;
      for (int t = tid; t < T::kTileCells; t += T::kThreads) {
        const int ty = t / T::kTileX;
        const int tx = t - ty * T::kTileX;
        const int x = g.x0 + tx;
        const int y = g.y0 + ty;
        if (!(tpulbm::kRings ? sh.writes(x - sh.x0, y - sh.y0)
                             : x >= 0 && y < ny)) {
          continue;
        }
        const size_t cell =
            tpulbm::kRings ? sh.cell(x - sh.x0, y - sh.y0, p)
                           : static_cast<size_t>(p) * plane +
                                 static_cast<size_t>(y) * nx + x;
        const int at = (ty + 1) * W_last + tx + 1;
        const int at0 = (ty + g.ob * N) * PW0 + tx + g.ol * N;
        float v[kQ];
        tpulbm3d::step_cell(
            v, [&](int ox) { return tpulbm3d::is_solid(mask_p[at0 + ox]); },
            x, y, p, nx, ny, nz, k, [&](auto i, int ox, int oy, int oz) {
              return last[ring_at<decltype(i)::value, C_last>(rd) + at +
                          oy * W_last + ox];
            });
        if constexpr (tpulbm3d::kBouzidi) {
          if (mask_p[at0] & tpulbm::kLinkBit) {
            const Slots own = slots_of<C_last>(p);
            const size_t link =
                tpulbm::kRings ? sh.padded(x - sh.x0, y - sh.y0, p) : cell;
            tpulbm3d::apply_bouzidi(
                v, links.q + link, links.plane, links.moving != 0,
                [&](auto i) {
                  return last[ring_at<decltype(i)::value, C_last>(own) + at];
                });
          }
        }
        const size_t out_pop =
            tpulbm::kRings ? static_cast<size_t>(nz) * sh.nyl * sh.nxl
                           : plane * nz;
#pragma unroll
        for (int i = 0; i < kQ; ++i) out[i * out_pop + cell] = v[i];
      }
    }
    // this block has read every frame of the march step
    if constexpr (T::kCluster) tpulbm_async::cluster_arrive_relaxed();
  }
  if constexpr (T::kCluster) tpulbm_async::cluster_wait();
}

// The tiles of a launch over `cols` x `rows` cells (the grid, or a shard's
// block) and nz planes, along x, y and z, padded to whole clusters.
template <int N>
__host__ __device__ dim3 tiles_of(int cols, int rows, int nz) {
  using T = Tile<N>;
  const int tx = (cols + T::kTileX - 1) / T::kTileX;
  const int ty = (rows + T::kTileY - 1) / T::kTileY;
  return dim3((tx + T::kCX - 1) / T::kCX * T::kCX,
              (ty + T::kCY - 1) / T::kCY * T::kCY,
              (nz + kZChunk - 1) / kZChunk);
}

// One block per tile, its rings in shared memory; or (kScratch) as many
// blocks as the scratch buffer has slices, each walking the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... with its rings in its slice.
template <int N>
__global__ void __launch_bounds__(Tile<N>::kThreads)
    d3q19_blocked_kernel(const float* __restrict__ f, float* __restrict__ out,
                         const uint8_t* __restrict__ solid,
                         const float* __restrict__ force, int nx, int ny,
                         int nz, const __grid_constant__ Consts k,
                         tpulbm::Links links,
                         const __grid_constant__ tpulbm3d::Shard sh,
                         float* scratch) {
  using T = Tile<N>;
  // the rings of stages 0 .. N-1, the mask
  extern __shared__ float smem[];
  if constexpr (T::kScratch) {
    float* rings =
        scratch + static_cast<size_t>(blockIdx.x) * T::kMaskOffset;
    uint8_t* mask = reinterpret_cast<uint8_t*>(smem);
    const dim3 n = tiles_of<N>(tpulbm::kRings ? sh.nxl : nx,
                               tpulbm::kRings ? sh.nyl : ny, nz);
    const int n_x = static_cast<int>(n.x);
    const int n_xy = n_x * static_cast<int>(n.y);
    const int tiles = n_xy * static_cast<int>(n.z);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      march<N>(f, out, solid, force, nx, ny, nz, k, links, sh, t % n_x,
               t % n_xy / n_x, t / n_xy, rings, mask, nullptr);
      __syncthreads();  // the next tile's stage 0 reuses the mask slots
    }
  } else {
    uint64_t* bars = reinterpret_cast<uint64_t*>(
        reinterpret_cast<char*>(smem) + T::kBarrierOffset);
    if constexpr (T::kCluster) {
      if (threadIdx.x == 0) {
        for (int s = 0; s < N; ++s) tpulbm_async::barrier_init(bars + s);
        tpulbm_async::barrier_init_fence();
      }
      // every block of the cluster runs, its barriers initialised, before
      // any stores into another's ring
      cg::this_cluster().sync();
    }
    march<N>(f, out, solid, force, nx, ny, nz, k, links, sh,
             static_cast<int>(blockIdx.x), static_cast<int>(blockIdx.y),
             static_cast<int>(blockIdx.z), smem,
             reinterpret_cast<uint8_t*>(smem + T::kMaskOffset), bars);
  }
}

// The kernel's shared memory and cluster set for depth N (-1 where the
// runtime refuses an attribute), filling `cfg` (its grid left to the
// caller) and `attr`.
template <int N>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                      cudaStream_t stream) {
  using T = Tile<N>;
  constexpr size_t smem = T::kSmemBytes;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        d3q19_blocked_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if constexpr (T::kCX * T::kCY > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        d3q19_blocked_kernel<N>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr = cudaLaunchAttribute{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = T::kCX;
  attr.val.clusterDim.y = T::kCY;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = T::kCluster ? 1 : 0;
  return cudaSuccess;
}

// The bytes of scratch a launch of depth N needs: none where its rings fit
// shared memory, else one slice for each block the card keeps resident.
// -1 if the runtime refuses the query.
template <int N>
long long scratch_bytes(int device) {
  using T = Tile<N>;
  if constexpr (!T::kScratch) {
    return 0;
  } else {
    int sms = 0, per_sm = 0;
    if (cudaSetDevice(device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, d3q19_blocked_kernel<N>, T::kThreads, T::kSmemBytes) !=
            cudaSuccess) {
      return -1;
    }
    return static_cast<long long>(sms) * per_sm * sizeof(float) *
           T::kMaskOffset;
  }
}

// The clusters of depth N the card keeps resident at once
// (cudaOccupancyMaxActiveClusters; for a lone block, the blocks), -1 if
// the runtime refuses the query.
template <int N>
int active_clusters(int device) {
  using T = Tile<N>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (cudaSetDevice(device) != cudaSuccess ||
      configure<N>(cfg, attr, nullptr) != cudaSuccess) {
    return -1;
  }
  int n = 0;
  if constexpr (T::kCluster) {
    // a grid of whole clusters, as a launch has
    cfg.gridDim = dim3(T::kCX * 16, T::kCY * 16, 1);
    if (cudaOccupancyMaxActiveClusters(&n, d3q19_blocked_kernel<N>, &cfg) !=
        cudaSuccess) {
      return -1;
    }
  } else {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, d3q19_blocked_kernel<N>, T::kThreads, T::kSmemBytes) !=
            cudaSuccess) {
      return -1;
    }
    n *= sms;
  }
  return n;
}

// A launch of depth N over tiles of `cols` x `rows` cells (the grid, or a
// shard's block: sh); `scratch` holds scratch_bytes<N>() bytes (or more),
// null where it needs none. A cluster the runtime refuses returns its error:
// nothing runs.
template <int N>
cudaError_t launch(const float* f, float* out, const uint8_t* solid,
                   const float* force, int nx, int ny, int nz, int cols,
                   int rows, const Consts& k, const tpulbm::Links& links,
                   const tpulbm3d::Shard& sh, float* scratch,
                   long long scratch_size, cudaStream_t stream) {
  using T = Tile<N>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<N>(cfg, attr, stream);
  if (err != cudaSuccess) return err;
  cfg.gridDim = tiles_of<N>(cols, rows, nz);
  if constexpr (T::kScratch) {
    const long long slices =
        scratch == nullptr
            ? 0
            : scratch_size / static_cast<long long>(sizeof(float) *
                                                    T::kMaskOffset);
    const dim3 g = cfg.gridDim;
    const long long tiles = static_cast<long long>(g.x) * g.y * g.z;
    if (slices < 1) return cudaErrorInvalidValue;
    cfg.gridDim = dim3(static_cast<unsigned>(slices < tiles ? slices : tiles));
  }
  err = cudaLaunchKernelEx(&cfg, d3q19_blocked_kernel<N>, f, out, solid,
                           force, nx, ny, nz, k, links, sh, scratch);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The depths the library holds, as X(N) for each: 2 and 3, or in the deep
// build 4-8.
#if TPULBM_DEEP
#define TPULBM_DEPTHS(X) X(4) X(5) X(6) X(7) X(8)
#else
#define TPULBM_DEPTHS(X) X(2) X(3)
#endif

}  // namespace

// Plain C interface, loaded with ctypes (tpulbm_torch/ops/step_cuda.py).
// Launches n_sub steps on `stream` and returns the launch's error or
// cudaGetLastError() (a refused launch, a cluster the card cannot place
// among them, never runs and a later synchronize would not report it); it
// neither synchronizes nor allocates. links and link_planes: the Bouzidi
// link table, 19 or 38 planes (tpulbm::Links), read by the kBouzidi build
// only (elsewhere null and 0); force: the force profile's (Q, nz) table on
// the card, read by the kForce build only (elsewhere null); scratch and
// scratch_size: a buffer on the card of at least
// tpulbm_d3q19_blocked_scratch_bytes(n_sub) bytes (null and 0 where that is
// 0).
#if !TPULBM_RINGS
extern "C" int tpulbm_d3q19_step_blocked(
    const float* f, float* out, const uint8_t* solid, int nx, int ny, int nz,
    int n_sub, float inv_tau, const float* eq_in, const float* w,
    const float* mode, const float* src, const float* force,
    const float* links, int link_planes, float* scratch,
    long long scratch_size, int device, void* stream) {
  if (!tpulbm::links_fit(links, link_planes, kQ)) return cudaErrorInvalidValue;
  if ((force != nullptr) != tpulbm::kForce) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Consts k = tpulbm3d::make_consts(inv_tau, eq_in, w, mode, src);
  const tpulbm::Links lk{links, static_cast<size_t>(nx) * ny * nz,
                         link_planes == 2 * kQ};
  const tpulbm3d::Shard none{};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_sub) {
#define TPULBM_CASE(N)                                                     \
  case N:                                                                  \
    err = launch<N>(f, out, solid, force, nx, ny, nz, nx, ny, k, lk, none, \
                    scratch, scratch_size, s);                             \
    break;
    TPULBM_DEPTHS(TPULBM_CASE)
#undef TPULBM_CASE
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
#else
// n_sub steps of the shard (nxl x nyl at global x0, y0 of the nx x ny
// grid, every one of the nz planes) from f and its rings (n_sub deep; hx 0
// or n_sub, as tpulbm3d::Shard describes them) into out. mask is the
// shard's kernel mask padded by n_sub rows and columns, and links its cut
// of the link table padded the same way.
extern "C" int tpulbm_d3q19_step_blocked_rings(
    const float* f, float* out, const uint8_t* mask, const float* rb,
    const float* rt, const float* rl, const float* rr, int nx, int ny,
    int nz, int nxl, int nyl, int x0, int y0, int hx, int n_sub,
    float inv_tau, const float* eq_in, const float* w, const float* mode,
    const float* src, const float* force, const float* links,
    int link_planes, float* scratch, long long scratch_size, int device,
    void* stream) {
  if (!tpulbm::links_fit(links, link_planes, kQ)) return cudaErrorInvalidValue;
  if ((force != nullptr) != tpulbm::kForce) return cudaErrorInvalidValue;
  if (nxl < 1 || nyl < 1 || (hx != 0 && hx != n_sub))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Consts k = tpulbm3d::make_consts(inv_tau, eq_in, w, mode, src);
  const tpulbm::Links lk{
      links,
      static_cast<size_t>(nz) * (nyl + 2 * n_sub) * (nxl + 2 * n_sub),
      link_planes == 2 * kQ};
  const tpulbm3d::Shard sh{f, rb, rt, rl, rr, mask, nxl, nyl, nz,
                           x0, y0, hx, n_sub};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_sub) {
#define TPULBM_CASE(N)                                                    \
  case N:                                                                 \
    err = launch<N>(f, out, nullptr, force, nx, ny, nz, nxl, nyl, k, lk, \
                    sh, scratch, scratch_size, s);                        \
    break;
    TPULBM_DEPTHS(TPULBM_CASE)
#undef TPULBM_CASE
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
#endif

// Dynamic shared memory one block of depth n_sub takes, in bytes (-1 for
// a depth the library does not hold).
extern "C" int tpulbm_d3q19_blocked_smem_bytes(int n_sub) {
  switch (n_sub) {
#define TPULBM_CASE(N) \
  case N: return static_cast<int>(Tile<N>::kSmemBytes);
    TPULBM_DEPTHS(TPULBM_CASE)
#undef TPULBM_CASE
    default: return -1;
  }
}

// The scratch a launch of depth n_sub on `device` needs, in bytes: 0 where
// its rings fit shared memory (every depth but D3Q27's 8), else one slice
// for each block the card keeps resident (-1 for a depth the library does
// not hold, or a query the runtime refuses).
extern "C" long long tpulbm_d3q19_blocked_scratch_bytes(int n_sub,
                                                        int device) {
  switch (n_sub) {
#define TPULBM_CASE(N) \
  case N: return scratch_bytes<N>(device);
    TPULBM_DEPTHS(TPULBM_CASE)
#undef TPULBM_CASE
    default: return -1;
  }
}

// The output tile of a block at depth n_sub, x * 256 + y (-1 for a depth
// the library does not hold).
extern "C" int tpulbm_d3q19_blocked_tile(int n_sub) {
  switch (n_sub) {
#define TPULBM_CASE(N) \
  case N: return Tile<N>::kTileX * 256 + Tile<N>::kTileY;
    TPULBM_DEPTHS(TPULBM_CASE)
#undef TPULBM_CASE
    default: return -1;
  }
}

// The cluster of depth n_sub, blocks along x * 256 + blocks along y (1 * 256
// + 1 for a lone block; -1 for a depth the library does not hold).
extern "C" int tpulbm_d3q19_blocked_cluster(int n_sub) {
  switch (n_sub) {
#define TPULBM_CASE(N) \
  case N: return Tile<N>::kCX * 256 + Tile<N>::kCY;
    TPULBM_DEPTHS(TPULBM_CASE)
#undef TPULBM_CASE
    default: return -1;
  }
}

// The threads of a block at depth n_sub (-1 for a depth the library does
// not hold).
extern "C" int tpulbm_d3q19_blocked_threads(int n_sub) {
  switch (n_sub) {
#define TPULBM_CASE(N) \
  case N: return Tile<N>::kThreads;
    TPULBM_DEPTHS(TPULBM_CASE)
#undef TPULBM_CASE
    default: return -1;
  }
}

// The clusters of depth n_sub that `device` keeps resident at once (-1 for
// a depth the library does not hold, or a query the runtime refuses).
extern "C" int tpulbm_d3q19_blocked_active_clusters(int n_sub, int device) {
  switch (n_sub) {
#define TPULBM_CASE(N) \
  case N: return active_clusters<N>(device);
    TPULBM_DEPTHS(TPULBM_CASE)
#undef TPULBM_CASE
    default: return -1;
  }
}

// The floats of the library's mode coefficients, which the caller's array
// must hold (its mode: collision_modes.cuh's tpulbm_collision_mode).
extern "C" int tpulbm_mode_floats() { return tpulbm3d::kModeFloats; }

// The populations of the library's velocity set (19 or 27).
extern "C" int tpulbm_lattice_q() { return kQ; }

extern "C" const char* tpulbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
