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
// Design: the 1-step kernel's z-march, N stages deep. A block owns a
// 32 x kBY (x, y) column and marches z over kZChunk output planes. Stage
// k < N holds the state after k substeps, collided, in a ring of planes
// over the tile widened by N - k cells in x and y (trapezoid validity);
// march step m loads and collides plane m (stage 0), then stage k computes
// plane m - k from stage k-1's ring (pull, boundary sequence, collide) and
// stage N pulls plane m - N from stage N-1's ring, runs the boundary
// sequence in registers and stores it. One barrier follows each of the
// stages 0 .. N-1. Cells outside the domain are never computed or read:
// the ghost rule replaces them at every substep, so x validity and the
// z ghost planes need no extra storage. The mask is read at every stage
// from device memory (one byte a cell, cached), so solid cells in the
// widened tiles are pinned at every substep.
//
// Shared memory is the design problem. A ring keeps each population only
// as long as a pull still needs it: those with cz = -1 are pulled from
// plane z+1 in the march step that writes them (one plane), cz = 0 from
// plane z one step later (two planes), cz = +1 from plane z-1 two steps
// later (three planes): 5 + 2*9 + 3*5 = 38 floats a cell instead of 3*19
// (D3Q27, whose classes hold 9 populations each: 9 + 2*9 + 3*9 = 54
// instead of 3*27).
// The mask of the last N+2 z-planes over stage 0's cells is kept beside
// the rings, so no stage after the first reads device memory for it. Of the
// tilings timed on an H100 at 256^3 (tile heights 2, 4, 8 with z-marches
// of 32, 64, 128; utils/tile_sweep.py, PERF.md), 32 x 8 over 64 planes was
// the fastest at both depths: 119,072 B at N=2 and 200,868 B at N=3, one
// block of 256 threads per SM. D3Q27 keeps 32 x 8 at N=2 (168,480 B); at
// N=3 its 54 floats a cell over 32 x 8 would take 284,324 B, above the
// 232,448 B a block may have, so N=3 takes 32 x 4 (190,252 B, 128
// threads).
//
// The zero-gradient outlet reads x = nx-2 (step_cell in d3q19_common.cuh),
// which needs x = nx-3 .. nx-1 of the ring at every stage. The x tiles are
// right-aligned as in the 1-step kernel, so the block that holds nx-1
// holds that neighbourhood at every stage; the ragged tile is the leftmost
// one, masked. Population-plane offsets are 64-bit. In the duct the
// widened tiles' x-halo wraps: a cell at x < 0 or x >= nx holds cell
// x mod nx, loaded from there and stepped like every other cell (the
// duct's rules do not depend on x), so the trapezoid of valid cells is that
// of an interior block.
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
// slots (43 floats a cell instead of 38; 226,948 B at N=3, 134,512 B at
// N=2, still one block an SM). On D3Q27 that is 63 floats instead of 54:
// the N=3 tile, 32 x 4, takes 221,644 B and N=2's, 32 x 8, 196,272 B, both
// within a block's 232,448 B, so the Bouzidi build keeps the tiles of the
// build without it.
//
// Built with -DTPULBM_RINGS=1 the kernel steps one shard of a mesh
// (tpulbm3d::Shard): make_local_step_pallas3d_tiled at n_sub 2, 3 with its
// ring inputs, N rows deep, and on a mesh that cuts x its N columns deep
// x rings (x_halo). The output tiles cover the shard's block, right-aligned
// to its last column; every stage's widened tile takes its cells from the
// block or the rings (find(), locate()), so no cell wraps inside the block
// on a cut axis: the duct's wrapped x columns and the box's wrapped rows
// come from the rings. A stage computes only the window cells the block
// and its rings hold; the trapezoid keeps the rest out of every cell the
// launch writes. Under kBouzidi (on a mesh that keeps x whole, as tpulbm's
// dispatch runs it) the cut links read the shard's padded link table.
//
// Bits. Collision, pull and boundary code come from d3q19_common.cuh,
// shared with step_d3q19.cu, and both libraries are built with -fmad=false:
// one launch gives the same bits as N launches of the 1-step kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d3q19_common.cuh"

namespace {

using tpulbm3d::Consts;
using tpulbm3d::kQ;

constexpr int kBX = 32;          // tile width: one warp per row
constexpr int kBY = 8;           // tile height
constexpr int kBY27N3 = 4;       // tile height of D3Q27 at N = 3
constexpr int kZChunk = 64;      // output z-planes a block marches over
constexpr size_t kMaxBlockSmem = 232448;  // what a block may take on sm_90

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
// (from z-1) three, the slot of z-plane q being (q + 6) % class_slots(c).
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
// hold z-plane q (q >= -1) in a ring of C cells.
struct Slots {
  int c0, c1, c2;
};
template <int C>
__device__ __forceinline__ Slots slots_of(int q) {
  return {((q + 6) % class_slots(0)) * class_size(0) * C,
          ((q + 6) % class_slots(1)) * class_size(1) * C,
          ((q + 6) % class_slots(2)) * class_size(2) * C};
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

template <int N>
struct Tile {
  static_assert(N >= 2, "one step per launch is step_d3q19.cu");
  // the output tile's height: kBY, but kBY27N3 where D3Q27's rings at N = 3
  // would not fit a block's shared memory
  static constexpr int kTileY = kQ == 27 && N == 3 ? kBY27N3 : kBY;
  static constexpr int kThreads = kBX * kTileY;
  // stage k < N covers the tile widened by N - k cells
  __host__ __device__ static constexpr int width(int k) {
    return kBX + 2 * (N - k);
  }
  __host__ __device__ static constexpr int height(int k) {
    return kTileY + 2 * (N - k);
  }
  __host__ __device__ static constexpr int cells(int k) {
    return width(k) * height(k);
  }
  __host__ __device__ static constexpr int ring_offset(int k) {
    return k == 0 ? 0 : ring_offset(k - 1) + kRingFloats * cells(k - 1);
  }
  // after the rings: the masks of z-planes m-N-1 .. m over stage 0's cells
  // (stage N reads plane m-N while stage 0 of the next march step, after
  // no barrier, writes plane m+1)
  static constexpr int kMaskSlots = N + 2;
  static constexpr int kMaskOffset = ring_offset(N);
  static constexpr size_t kSmemBytes =
      sizeof(float) * kMaskOffset + kMaskSlots * cells(0);
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

// Whether a widened tile's cell at global (x, y) is stepped: a cell of the
// domain, or in the duct any cell of a domain row, x then taken mod nx (the
// cell it holds), or in the box any cell, x taken mod nx and y mod ny.
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
  const float* force;  // the force profile's (Q, nz) table (kForce)
};

// Stage K (0 < K < N) at march step m: plane m - K of the state after K
// substeps over the tile widened by N - K, pulled from stage K-1's ring,
// stepped and collided into stage K's ring; then the barrier.
template <int N, int K>
__device__ __forceinline__ void inner_stages(float* smem, const March& g,
                                             const Consts& k,
                                             const tpulbm::Links& links,
                                             const tpulbm3d::Shard& sh,
                                             int m) {
  if constexpr (K < N) {
    using T = Tile<N>;
    constexpr int W = T::width(K);
    constexpr int C = T::cells(K);
    constexpr int Ws = T::width(K - 1);
    constexpr int Cs = T::cells(K - 1);
    constexpr int W0 = T::width(0);
    const float* src = smem + T::ring_offset(K - 1);
    float* dst = smem + T::ring_offset(K);
    const int p = m - K;
    // the mask slots hold z-planes of the domain (the box reads no mask)
    const uint8_t* mask = reinterpret_cast<const uint8_t*>(
                              smem + T::kMaskOffset) +
                          (p >= 0 ? p % T::kMaskSlots : 0) * T::cells(0);
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
      // each thread steps J cells: every pull before any store, so that
      // the loads of all J cells are in flight together
      constexpr int J = (C + T::kThreads - 1) / T::kThreads;
      float v[J][kQ];
      bool in[J], solid[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int t = threadIdx.x + j * T::kThreads;
        const int ly = t / W;
        const int lx = t - ly * W;
        int x = g.x0 - (N - K) + lx;
        int y = g.y0 - (N - K) + ly;
        int bx = 0, by = 0;  // the cell in the shard's block (kRings)
        if constexpr (tpulbm::kRings) {
          in[j] = t < C && sh.find(x, y, g.nx, g.ny, bx, by);
        } else {
          in[j] = t < C && tile_cell(x, y, g.nx, g.ny);
        }
        solid[j] = false;
        if (in[j]) {
          const int at = (ly + 1) * Ws + lx + 1;     // this cell in stage K-1
          const int at0 = (ly + K) * W0 + lx + K;    // and in stage 0
          if constexpr (tpulbm3d::kBounceBack)
            solid[j] = tpulbm3d::is_solid(mask[at0]);
          tpulbm3d::step_cell(
              v[j], [&](int ox) { return tpulbm3d::is_solid(mask[at0 + ox]); },
              x, y, p, g.nx, g.ny, g.nz, k,
              [&](auto i, int ox, int oy, int oz) {
                return src[ring_at<decltype(i)::value, Cs>(rd) + at +
                           oy * Ws + ox];
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
                  v[j], links.q + cell, links.plane, links.moving != 0,
                  [&](auto i) {
                    return src[ring_at<decltype(i)::value, Cs>(own) + at];
                  });
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (in[j]) {
          tpulbm3d::collide_cell(v[j], k, solid[j], g.force + pz, g.nz);
          store_ring<C>(dst, wr, threadIdx.x + j * T::kThreads, v[j]);
        }
      }
    }
    __syncthreads();
    inner_stages<N, K + 1>(smem, g, k, links, sh, m);
  }
}

template <int N>
__global__ void __launch_bounds__(Tile<N>::kThreads)
    d3q19_blocked_kernel(const float* __restrict__ f, float* __restrict__ out,
                         const uint8_t* __restrict__ solid,
                         const float* __restrict__ force, int nx, int ny,
                         int nz, const __grid_constant__ Consts k,
                         tpulbm::Links links,
                         const __grid_constant__ tpulbm3d::Shard sh) {
  using T = Tile<N>;
  extern __shared__ float smem[];  // the rings of stages 0 .. N-1, the mask

  March g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  // right-aligned to the last column of the grid (of the shard's block)
  g.x0 = (tpulbm::kRings ? sh.x0 + sh.nxl : nx) -
         kBX * (static_cast<int>(blockIdx.x) + 1);
  g.y0 = (tpulbm::kRings ? sh.y0 : 0) +
         static_cast<int>(blockIdx.y) * T::kTileY;
  g.z0 = static_cast<int>(blockIdx.z) * kZChunk;
  g.z1 = g.z0 + kZChunk < nz ? g.z0 + kZChunk : nz;
  g.force = force;
  const size_t plane = static_cast<size_t>(nx) * ny;
  const size_t pop = plane * nz;  // cells per population plane
  const int tid = threadIdx.x;
  uint8_t* mask = reinterpret_cast<uint8_t*>(smem + T::kMaskOffset);

  // the output cell of this thread
  const int tx = tid % kBX;
  const int ty = tid / kBX;
  const int x = g.x0 + tx;
  const int y = g.y0 + ty;
  const bool active = tpulbm::kRings ? sh.writes(x - sh.x0, y - sh.y0)
                                     : x >= 0 && y < ny;
  constexpr int W0 = T::width(0);
  constexpr int C0 = T::cells(0);
  constexpr int W_last = T::width(N - 1);
  constexpr int C_last = T::cells(N - 1);
  // stage 0's cells of each thread: all their loads are issued before any
  // is used, so a thread keeps J cells' loads in flight
  constexpr int J = (C0 + T::kThreads - 1) / T::kThreads;
  const float* last = smem + T::ring_offset(N - 1);

  for (int m = g.z0 - N; m < g.z1 + N; ++m) {
    // stage 0: load plane m (in the box plane m mod nz) over the tile
    // widened by N, keep its mask, collide and keep the populations
    if (tpulbm3d::kPeriodicZ || (m >= 0 && m < nz)) {
      const int mz = plane_of(m, nz);
      const Slots wr = slots_of<C0>(m);
      uint8_t* mask_m = mask + (m >= 0 ? m % T::kMaskSlots : 0) * C0;
      float v[J][kQ];
      bool in[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int t = tid + j * T::kThreads;
        const int ly = t / W0;
        const int lx = t - ly * W0;
        int gx = g.x0 - N + lx;
        int gy = g.y0 - N + ly;
        if constexpr (tpulbm::kRings) {
          int bx, by;
          in[j] = t < C0 && sh.find(gx, gy, nx, ny, bx, by);
          if (in[j]) {
            if constexpr (tpulbm3d::kHasObstacle)
              mask_m[t] = sh.mask[sh.padded(bx, by, mz)];
            size_t stride;
            const float* src = sh.locate(bx, by, mz, stride);
#pragma unroll
            for (int i = 0; i < kQ; ++i) v[j][i] = src[i * stride];
          }
        } else {
          in[j] = t < C0 && tile_cell(gx, gy, nx, ny);
          if (in[j]) {
            const size_t cell = static_cast<size_t>(mz) * plane +
                                static_cast<size_t>(gy) * nx + gx;
            if constexpr (tpulbm3d::kHasObstacle) mask_m[t] = solid[cell];
#pragma unroll
            for (int i = 0; i < kQ; ++i) v[j][i] = f[i * pop + cell];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (in[j]) {
          tpulbm3d::collide_cell(
              v[j], k,
              tpulbm3d::kBounceBack &&
                  tpulbm3d::is_solid(mask_m[tid + j * T::kThreads]),
              force + mz, nz);
          store_ring<C0>(smem, wr, tid + j * T::kThreads, v[j]);
        }
      }
    }
    __syncthreads();
    inner_stages<N, 1>(smem, g, k, links, sh, m);
    // stage N: plane m - N of the tile, stored
    const int p = m - N;
    if (active && p >= g.z0 && p < g.z1) {
      const size_t cell =
          tpulbm::kRings ? sh.cell(x - sh.x0, y - sh.y0, p)
                         : static_cast<size_t>(p) * plane +
                               static_cast<size_t>(y) * nx + x;
      const Slots rd = pull_slots<C_last>(p);
      const uint8_t* mask_p = mask + (p % T::kMaskSlots) * C0;
      const int at = (ty + 1) * W_last + tx + 1;
      const int at0 = (ty + N) * W0 + tx + N;
      float v[kQ];
      tpulbm3d::step_cell(
          v, [&](int ox) { return tpulbm3d::is_solid(mask_p[at0 + ox]); }, x,
          y, p, nx, ny, nz, k, [&](auto i, int ox, int oy, int oz) {
            return last[ring_at<decltype(i)::value, C_last>(rd) + at +
                        oy * W_last + ox];
          });
      if constexpr (tpulbm3d::kBouzidi) {
        if (mask_p[at0] & tpulbm::kLinkBit) {
          const Slots own = slots_of<C_last>(p);
          const size_t link =
              tpulbm::kRings ? sh.padded(x - sh.x0, y - sh.y0, p) : cell;
          tpulbm3d::apply_bouzidi(
              v, links.q + link, links.plane, links.moving != 0, [&](auto i) {
                return last[ring_at<decltype(i)::value, C_last>(own) + at];
              });
        }
      }
      const size_t out_pop =
          tpulbm::kRings ? static_cast<size_t>(nz) * sh.nyl * sh.nxl : pop;
#pragma unroll
      for (int i = 0; i < kQ; ++i) out[i * out_pop + cell] = v[i];
    }
  }
}

// A launch of depth N over tiles of `cols` x `rows` cells (the grid, or a
// shard's block: sh).
template <int N>
cudaError_t launch(const float* f, float* out, const uint8_t* solid,
                   const float* force, int nx, int ny, int nz, int cols,
                   int rows, const Consts& k, const tpulbm::Links& links,
                   const tpulbm3d::Shard& sh, cudaStream_t stream) {
  constexpr size_t smem = Tile<N>::kSmemBytes;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        d3q19_blocked_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  constexpr int by = Tile<N>::kTileY;
  const dim3 grid((cols + kBX - 1) / kBX, (rows + by - 1) / by,
                  (nz + kZChunk - 1) / kZChunk);
  d3q19_blocked_kernel<N><<<grid, Tile<N>::kThreads, smem, stream>>>(
      f, out, solid, force, nx, ny, nz, k, links, sh);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes (tpulbm_torch/ops/step_cuda.py).
// Launches n_sub steps on `stream` and returns cudaGetLastError() (a refused
// launch never runs and a later synchronize would not report it); it
// neither synchronizes nor allocates. links and link_planes: the Bouzidi
// link table, 19 or 38 planes (tpulbm::Links), read by the kBouzidi build
// only (elsewhere null and 0); force: the force profile's (Q, nz) table on
// the card, read by the kForce build only (elsewhere null).
#if !TPULBM_RINGS
extern "C" int tpulbm_d3q19_step_blocked(const float* f, float* out,
                                         const uint8_t* solid, int nx, int ny,
                                         int nz, int n_sub, float inv_tau,
                                         const float* eq_in, const float* w,
                                         const float* mode, const float* src,
                                         const float* force,
                                         const float* links, int link_planes,
                                         int device, void* stream) {
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
    case 2:
      err = launch<2>(f, out, solid, force, nx, ny, nz, nx, ny, k, lk, none,
                      s);
      break;
    case 3:
      err = launch<3>(f, out, solid, force, nx, ny, nz, nx, ny, k, lk, none,
                      s);
      break;
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
    int link_planes, int device, void* stream) {
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
    case 2:
      err = launch<2>(f, out, nullptr, force, nx, ny, nz, nxl, nyl, k, lk,
                      sh, s);
      break;
    case 3:
      err = launch<3>(f, out, nullptr, force, nx, ny, nz, nxl, nyl, k, lk,
                      sh, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
#endif

// Dynamic shared memory one block of depth n_sub takes, in bytes (-1 for
// a depth the library does not hold).
extern "C" int tpulbm_d3q19_blocked_smem_bytes(int n_sub) {
  switch (n_sub) {
    case 2: return static_cast<int>(Tile<2>::kSmemBytes);
    case 3: return static_cast<int>(Tile<3>::kSmemBytes);
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
