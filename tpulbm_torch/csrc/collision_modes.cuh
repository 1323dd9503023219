// The collision modes and domains of the port's kernels, and the per-cell
// relaxation rates that the D2Q9 (d2q9_common.cuh) and D3Q19
// (d3q19_common.cuh) collisions share: the Smagorinsky closed form and the
// power law's log-space Newton solve, in the arithmetic of tpulbm's Pallas
// kernels (tpulbm/physics.py::power_law_inv_tau_from_gfac, the closed forms
// of step_pallas.py and step_pallas3d.py).
//
// Each is fixed when a library is built (ops/step_cuda.py builds one
// library per combination a run asks for):
// * -DTPULBM_COLLISION=<mode>, BGK when it is unset;
// * -DTPULBM_DOMAIN=<domain>, the boundary layout: the obstacle domain when
//   it is unset (the 2-D cylinder: y walls, Zou-He inlet and outlet; the
//   3-D sphere: y and z walls, equilibrium inlet, zero-gradient outlet),
//   1 the channel (periodic x, y walls; in 3-D the duct, y and z walls),
//   2 the cavity (x and y walls, the moving lid, the corner closure; 2-D),
//   3 the periodic box (periodic x and y, no walls; in 3-D z as well);
// * -DTPULBM_SOURCE=1: the body force's source added after every
//   collision;
// * -DTPULBM_FORCE=1: the force profile's source, a table of S_i per
//   coordinate along one axis (Kolmogorov's: y in 2-D, z in 3-D), added
//   after that;
// * -DTPULBM_BOUNCE_BACK=1: the bounce-back obstacle (solid cells skip the
//   collision and store their pulled populations reversed) instead of the
//   equilibrium pin; the obstacle domain only.
// * -DTPULBM_BOUZIDI=1: the Bouzidi curved-wall obstacle (the cut links of
//   the cells the mask marks with kLinkBit rewritten from the link table,
//   then the equilibrium pin of the solid cells); the obstacle domain only.
// * -DTPULBM_RINGS=1: the D2Q9 kernels step one shard of a mesh, whose
//   cells outside its block come from the rings its neighbours sent
//   (d2q9_common.cuh's Shard), over a range of its rows.
// * -DTPULBM_Q=27: the 3-D kernels step the D3Q27 velocity set instead of
//   D3Q19 (d3q19_common.cuh; TPULBM_Q is 19 when it is unset).
// * -DTPULBM_SLAB=1: the channel domain without its y walls (2-D): the y
//   edges take the frozen-equilibrium ghosts and the solid mask carries
//   the walls, solid slabs under the equilibrium, the bounce-back or the
//   Bouzidi obstacle rule (tpulbm's fractional-wall, staircase and Couette
//   channels: walls_y off, periodic_x, a solid mask).
// A library built with none of them is the one every earlier build ran.

#pragma once

#ifndef TPULBM_COLLISION
#define TPULBM_COLLISION 0
#endif
#ifndef TPULBM_DOMAIN
#define TPULBM_DOMAIN 0
#endif
#ifndef TPULBM_SOURCE
#define TPULBM_SOURCE 0
#endif
#ifndef TPULBM_FORCE
#define TPULBM_FORCE 0
#endif
#ifndef TPULBM_BOUNCE_BACK
#define TPULBM_BOUNCE_BACK 0
#endif
#ifndef TPULBM_RINGS
#define TPULBM_RINGS 0
#endif
#ifndef TPULBM_BOUZIDI
#define TPULBM_BOUZIDI 0
#endif
#ifndef TPULBM_Q
#define TPULBM_Q 19
#endif
#ifndef TPULBM_SLAB
#define TPULBM_SLAB 0
#endif

#include <stddef.h>
#include <stdint.h>

namespace tpulbm {

// The collision modes, in the order ops/step_cuda.py's COLLISION_MODES
// lists them.
enum Collision : int {
  kBGK = 0,
  kTRT = 1,
  kMRT = 2,
  kRegularized = 3,
  kKBC = 4,
  kSmagorinsky = 5,
  kPowerLaw = 6,
};
constexpr int kMode = TPULBM_COLLISION;
static_assert(kMode >= kBGK && kMode <= kPowerLaw, "unknown collision mode");

// The domains, in the order ops/step_cuda.py's DOMAINS lists them.
enum Domain : int {
  kObstacle = 0,  // inlet, outlet and a voxel obstacle
  kChannel = 1,   // periodic x, no obstacle (kSlab: no y walls, a mask)
  kCavity = 2,    // closed box with a moving lid, no obstacle
  kBox = 3,       // periodic x and y (and z in 3-D), no walls, no obstacle
};
constexpr int kDomain = TPULBM_DOMAIN;
static_assert(kDomain >= kObstacle && kDomain <= kBox, "unknown domain");
constexpr bool kPeriodicX = kDomain == kChannel || kDomain == kBox;
constexpr bool kPeriodicY = kDomain == kBox;
constexpr bool kPeriodicZ = kDomain == kBox;  // read by the 3-D kernels
// the slab: the channel whose y walls are solid rows of the mask
constexpr bool kSlab = TPULBM_SLAB != 0;
static_assert(!kSlab || kDomain == kChannel,
              "the slab is the channel domain without its y walls");
// a solid mask and an obstacle rule: the obstacle domain and the slab
constexpr bool kHasObstacle = kDomain == kObstacle || kSlab;
constexpr bool kSource = TPULBM_SOURCE != 0;
constexpr bool kForce = TPULBM_FORCE != 0;
constexpr bool kBounceBack = TPULBM_BOUNCE_BACK != 0;
static_assert(!kBounceBack || kHasObstacle,
              "the bounce-back obstacle needs the obstacle domain or the "
              "slab");
constexpr bool kRings = TPULBM_RINGS != 0;
constexpr bool kBouzidi = TPULBM_BOUZIDI != 0;
static_assert(TPULBM_Q == 19 || TPULBM_Q == 27, "a 3-D set: 19 or 27");
constexpr bool kD3Q27 = TPULBM_Q == 27;
static_assert(!kBouzidi || (kHasObstacle && !kBounceBack),
              "the Bouzidi obstacle needs the obstacle domain or the slab, "
              "and is not the bounce-back one");

// The bits of a cell's byte in the uint8 mask the kernels read: solid, and
// (kBouzidi) at least one cut link, so that a kernel reads the link table
// only at the cells that have one (ops/step_cuda.py::kernel_mask).
constexpr uint8_t kSolidBit = 1;
constexpr uint8_t kLinkBit = 4;

__device__ __forceinline__ bool is_solid(uint8_t m) {
  return (m & kSolidBit) != 0;
}

// The Bouzidi link table (kBouzidi; ops/bouzidi.py::link_tables): q, float32
// planes of `plane` cells, Q of them, then (moving != 0, a spinning wall)
// Q more of the moving-wall scalars w_j (c_j . u_w). A one-device launch
// reads the whole grid's table at a cell's index in the state; a shard's
// launch reads its block's cut padded as its mask (bouzidi.table_block).
struct Links {
  const float* q;
  size_t plane;
  int moving;
};

// Whether a launcher's link table fits the build of a q-population
// lattice: the kBouzidi build takes q or 2q planes, every other build none.
inline bool links_fit(const float* links, int planes, int q) {
  if constexpr (kBouzidi) {
    return links != nullptr && (planes == q || planes == 2 * q);
  } else {
    return links == nullptr && planes == 0;
  }
}

constexpr int kPowerLawIters = 8;  // tpulbm physics.PLAW_ITERS

// The Smagorinsky rate 1/tau_eff = 2 / (tau0 + sqrt(tau0² + 18 Cs² Q̄ / rho))
// from the stress norm Q̄; coef = 18 Cs².
__device__ __forceinline__ float smagorinsky_inv_tau(float qbar, float inv_rho,
                                                     float tau0, float tau0_sq,
                                                     float coef) {
  return 2.0f / (tau0 + sqrtf(tau0_sq + coef * qbar * inv_rho));
}

// The power-law rate from gfac = 1.5 Q̄ / rho (floored at 1e-12):
// kPowerLawIters Newton steps on lam = log(tau - 1/2) of
// lam + (n-1) log tau - log 3k - (n-1) log gfac, each clamped to
// [lam_lo, lam_hi]; nm1 = n - 1, log3k = log 3k.
__device__ __forceinline__ float power_law_inv_tau(float gfac, float nm1,
                                                   float log3k, float lam_lo,
                                                   float lam_hi) {
  const float gl = logf(fmaxf(gfac, 1e-12f));
  float lam = 0.0f;
#pragma unroll 1
  for (int it = 0; it < kPowerLawIters; ++it) {
    const float tau = 0.5f + expf(lam);
    const float r = lam + nm1 * logf(tau) - log3k - nm1 * gl;
    const float rp = 1.0f + nm1 * (tau - 0.5f) / tau;
    lam = fminf(fmaxf(lam - r / rp, lam_lo), lam_hi);
  }
  return 1.0f / (0.5f + expf(lam));
}

}  // namespace tpulbm

// The collision mode the library was built for (tpulbm::Collision);
// ops/step_cuda.py checks it when it binds a library built for a mode.
extern "C" int tpulbm_collision_mode() { return tpulbm::kMode; }

// The rest of the build: the domain, then 4 with the source, 8 with the
// bounce-back obstacle, 16 with the rings, 32 with the force profile, 64
// with the Bouzidi obstacle, 128 on D3Q27 and 256 for the slab;
// ops/step_cuda.py checks it too.
extern "C" int tpulbm_build_variant() {
  return tpulbm::kDomain | (tpulbm::kSource ? 4 : 0) |
         (tpulbm::kBounceBack ? 8 : 0) | (tpulbm::kRings ? 16 : 0) |
         (tpulbm::kForce ? 32 : 0) | (tpulbm::kBouzidi ? 64 : 0) |
         (tpulbm::kD3Q27 ? 128 : 0) | (tpulbm::kSlab ? 256 : 0);
}
