// The per-cell parts of a D3Q19 or D3Q27 timestep that the port's 3-D
// kernels share, float32: the collisions with the body force's source and
// the force profile's (a table per z), the pull with the reference's ghost
// rule (or a periodic x, or every axis periodic), and the boundary
// sequences of the sphere in a duct (the obstacle domain), of the periodic
// duct (the channel domain) and of the fully periodic box (the box domain:
// no ghost, no wall). step_d3q19.cu (one step per launch) and
// step_d3q19_blocked.cu (N steps per launch) both build on these
// functions, so that N launches of the first and one launch of the second
// run the same operations in the same order and give the same bits, under
// every collision.
//
// Rounding: the BGK relaxation follows the plain version
// (tpulbm_torch/ops/step_torch.py); the other collisions follow the
// arithmetic of tpulbm's Pallas kernels
// (tpulbm/ops/step_pallas3d.py::_collide_planes_core :140-358): MRT in
// rank-r form, TRT in its closed form, the six Pi_ab summed over the
// velocity table, so kernel and plain version agree at float32 rounding,
// not bitwise. Directions are summed in order, u = m * (1/rho), and the
// libraries are built with -fmad=false, so no multiply and add share one
// rounding, and without fast math, so sqrtf, expf, logf and division stay
// IEEE.
//
// The collision is fixed when a library is built (collision_modes.cuh):
// BGK, TRT, MRT, regularized, Smagorinsky or the power law (tpulbm has no
// 3-D KBC, and no MRT on D3Q27); so are the domain, the source, the force
// profile, the obstacle rule and the velocity set (-DTPULBM_Q=27 for
// D3Q27; D3Q19 by default). Every loop over the populations is the
// X-macro TPULBM_LAT3D of the build's set. Built with -DTPULBM_RINGS=1
// both kernels step one shard of a mesh (Shard below) instead of the
// whole grid.

#pragma once

#include <stdint.h>
#include <string.h>

#include "collision_modes.cuh"

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

// The D3Q27 velocity set in tpulbm.lattice.D3Q27's order: D3Q19's 19 rows,
// then the eight corners. tests/test_torch_d3q27.py parses this table.
#define TPULBM_D3Q27(X) \
  TPULBM_D3Q19(X)       \
  X(19, 1, 1, 1, 20)    \
  X(20, -1, -1, -1, 19) \
  X(21, 1, 1, -1, 22)   \
  X(22, -1, -1, 1, 21)  \
  X(23, 1, -1, 1, 24)   \
  X(24, -1, 1, -1, 23)  \
  X(25, 1, -1, -1, 26)  \
  X(26, -1, 1, 1, 25)

// The build's set, which every per-population loop below expands.
#if TPULBM_Q == 27
#define TPULBM_LAT3D(X) TPULBM_D3Q27(X)
#else
#define TPULBM_LAT3D(X) TPULBM_D3Q19(X)
#endif

// +v, -v or nothing, by the sign of a velocity component (a literal)
#define TPULBM_SIGNED_ADD(acc, c, v) \
  if ((c) > 0) {                     \
    acc = acc + (v);                 \
  } else if ((c) < 0) {              \
    acc = acc - (v);                 \
  }

namespace tpulbm3d {

constexpr int kQ = tpulbm::kD3Q27 ? 27 : 19;
using tpulbm::is_solid;
using tpulbm::kBounceBack;
using tpulbm::kBouzidi;
using tpulbm::kHasObstacle;
using tpulbm::kMode;
using tpulbm::kPeriodicX;
using tpulbm::kPeriodicY;
using tpulbm::kPeriodicZ;
static_assert(kMode != tpulbm::kKBC, "tpulbm's KBC operator is 2-D only");
static_assert(!(tpulbm::kD3Q27 && kMode == tpulbm::kMRT),
              "tpulbm has no MRT basis for D3Q27");
static_assert(!tpulbm::kSlab, "the slab is a 2-D channel");
static_assert(tpulbm::kDomain != tpulbm::kCavity, "the cavity is 2-D");

// MRT's rank-r correction (D3Q19), zero-padded to the largest rank: only the
// ten ghost moments (e, eps, qx, qy, qz, pixx, piww, mx, my, mz) can relax
// at another rate than 1/tau
constexpr int kMrtRank = 10;

// Population index I as a type, so that a pull's callee sees it as a
// constant expression: Pop<I>::value.
template <int I>
struct Pop {
  static constexpr int value = I;
};

// The collisions' coefficients, computed on the host in double precision
// as tpulbm's 3-D builders compute them (step_pallas3d.py:408-434) and
// rounded once to float (ops/step_cuda.py::mode_floats_3d writes them in
// this order). A mode reads only its own, with compile-time indices, so
// they stay in the parameter space.
struct ModeConsts {
  float trt_hp, trt_hm;             // TRT: 0.5/tau and 0.5·ω⁻
  float mrt_u[kQ][kMrtRank];        // MRT: U (Q x r) and V (r x Q)
  float mrt_v[kMrtRank][kQ];
  float reg_keep;                   // regularized: 1 - 1/tau, and the shell
  float reg_diag[3][kQ];            // 4.5 w_i (c_ia² - 1/3), a = x, y, z
  float reg_off[3][kQ];             // 9 w_i c_ia c_ib, ab = xy, xz, yz
  float smag_tau0, smag_tau0_sq, smag_coef;  // Smagorinsky: 18 Cs^2
  float plaw_nm1, plaw_log3k, plaw_lam_lo, plaw_lam_hi;  // power law
};

constexpr int kModeFloats = sizeof(ModeConsts) / sizeof(float);
static_assert(sizeof(ModeConsts) == kModeFloats * sizeof(float),
              "ModeConsts holds floats only");

struct Consts {
  float inv_tau;    // 1 / tau
  float eq_in[kQ];  // frozen ghost and inlet equilibrium(rho=1, u=(U,0,0))
  float w[kQ];      // lattice weights: the rest equilibrium of solids
  ModeConsts m;
  float src[kQ];    // body-force source 3 w_i (c_i . F) (kSource)
};

// src may be null: no source (zeros).
inline Consts make_consts(float inv_tau, const float* eq_in, const float* w,
                          const float* mode, const float* src = nullptr) {
  Consts k;
  k.inv_tau = inv_tau;
  for (int i = 0; i < kQ; ++i) {
    k.eq_in[i] = eq_in[i];
    k.w[i] = w[i];
    k.src[i] = src ? src[i] : 0.0f;
  }
  memcpy(&k.m, mode, sizeof(ModeConsts));
  return k;
}

// Density and velocity of one cell's populations.
struct Moments {
  float rho, inv_rho, ux, uy, uz;
};

__device__ __forceinline__ Moments moments3d(const float* f) {
  float rho = f[0];
#pragma unroll
  for (int i = 1; i < kQ; ++i) rho = rho + f[i];
  float mx = 0.0f, my = 0.0f, mz = 0.0f;
#define TPULBM_MOMENT(i, cx, cy, cz, o) \
  TPULBM_SIGNED_ADD(mx, cx, f[i])       \
  TPULBM_SIGNED_ADD(my, cy, f[i])       \
  TPULBM_SIGNED_ADD(mz, cz, f[i])
  TPULBM_LAT3D(TPULBM_MOMENT)
#undef TPULBM_MOMENT
  const float inv_rho = 1.0f / rho;
  return {rho, inv_rho, mx * inv_rho, my * inv_rho, mz * inv_rho};
}

__device__ __forceinline__ float base_of(const Moments& m) {
  return 1.0f - 1.5f * (m.ux * m.ux + m.uy * m.uy + m.uz * m.uz);
}

// c_i . u as exact +-adds, for the population of the X-macro row in scope
#define TPULBM_CU(cu, cx, cy, cz, m) \
  float cu = 0.0f;                   \
  TPULBM_SIGNED_ADD(cu, cx, m.ux)    \
  TPULBM_SIGNED_ADD(cu, cy, m.uy)    \
  TPULBM_SIGNED_ADD(cu, cz, m.uz)

// BGK relaxation of one cell's populations, in place.
__device__ __forceinline__ void collide_bgk(float* f, const Consts& k) {
  const Moments m = moments3d(f);
  const float rho = m.rho;
  const float base = base_of(m);
  f[0] = f[0] - k.inv_tau * (f[0] - k.w[0] * rho * base);
#define TPULBM_RELAX(i, cx, cy, cz, o)                               \
  if ((i) > 0) {                                                     \
    TPULBM_CU(cu, cx, cy, cz, m)                                     \
    const float feq =                                                \
        k.w[i] * rho * (base + 3.0f * cu + 4.5f * cu * cu);          \
    f[i] = f[i] - k.inv_tau * (f[i] - feq);                          \
  }
  TPULBM_LAT3D(TPULBM_RELAX)
#undef TPULBM_RELAX
}

// The non-equilibrium parts dev_i = f_i - feq_i, feq as collide_bgk and
// the Pallas kernel compute it.
__device__ __forceinline__ void deviations(const float* f, const Moments& m,
                                           const float* w, float* dev) {
  const float base = base_of(m);
  dev[0] = f[0] - w[0] * m.rho * base;
#define TPULBM_DEV(i, cx, cy, cz, o)                                      \
  if ((i) > 0) {                                                          \
    TPULBM_CU(cu, cx, cy, cz, m)                                          \
    dev[i] = f[i] - w[i] * m.rho * (base + 3.0f * cu + 4.5f * cu * cu);   \
  }
  TPULBM_LAT3D(TPULBM_DEV)
#undef TPULBM_DEV
}

// The non-equilibrium momentum flux Pi_ab = sum_i c_ia c_ib dev_i, each
// summed over i in order.
struct Stress {
  float xx, xy, xz, yy, yz, zz;
};

__device__ __forceinline__ Stress stress(const float* d) {
  Stress p = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#define TPULBM_PI(i, cx, cy, cz, o)          \
  TPULBM_SIGNED_ADD(p.xx, (cx) * (cx), d[i]) \
  TPULBM_SIGNED_ADD(p.xy, (cx) * (cy), d[i]) \
  TPULBM_SIGNED_ADD(p.xz, (cx) * (cz), d[i]) \
  TPULBM_SIGNED_ADD(p.yy, (cy) * (cy), d[i]) \
  TPULBM_SIGNED_ADD(p.yz, (cy) * (cz), d[i]) \
  TPULBM_SIGNED_ADD(p.zz, (cz) * (cz), d[i])
  TPULBM_LAT3D(TPULBM_PI)
#undef TPULBM_PI
  return p;
}

// Q̄ = sqrt(2 Σ_ab w_ab Pi_ab²), off-diagonal pairs twice, summed over
// (a, b) = xx, xy, xz, yy, yz, zz as the Pallas kernel sums it.
__device__ __forceinline__ float stress_norm(const Stress& p) {
  return sqrtf(2.0f * (p.xx * p.xx + 2.0f * (p.xy * p.xy) +
                       2.0f * (p.xz * p.xz) + p.yy * p.yy +
                       2.0f * (p.yz * p.yz) + p.zz * p.zz));
}

// TRT in the Pallas kernel's closed form: feq_i ± feq_opp(i) is
// 2 w rho (base + 4.5 cu²) and 6 w rho cu.
__device__ __forceinline__ void collide_trt(float* f, const Consts& k) {
  const Moments m = moments3d(f);
  const float rho = m.rho;
  const float base = base_of(m);
  float out[kQ];
  out[0] = f[0] - k.inv_tau * (f[0] - k.w[0] * rho * base);
#define TPULBM_TRT(i, cx, cy, cz, o)                                        \
  if ((i) > 0) {                                                            \
    TPULBM_CU(cu, cx, cy, cz, m)                                            \
    const float wr = k.w[i] * rho;                                          \
    const float even = (f[i] + f[o]) - 2.0f * wr * (base + 4.5f * cu * cu); \
    const float odd = (f[i] - f[o]) - 6.0f * wr * cu;                       \
    out[i] = f[i] - k.m.trt_hp * even - k.m.trt_hm * odd;                   \
  }
  TPULBM_LAT3D(TPULBM_TRT)
#undef TPULBM_TRT
#pragma unroll
  for (int i = 0; i < kQ; ++i) f[i] = out[i];
}

// MRT in rank-r form: f - dev/tau - sum_r U[:,r] (V[r] . dev). The padded
// ranks and the zeros Pallas skips add 0·x, which leaves every finite value
// as it is.
__device__ __forceinline__ void collide_mrt(float* f, const Consts& k) {
  float dev[kQ];
  deviations(f, moments3d(f), k.w, dev);
  float t[kMrtRank];
#pragma unroll
  for (int r = 0; r < kMrtRank; ++r) {
    t[r] = k.m.mrt_v[r][0] * dev[0];
#pragma unroll
    for (int j = 1; j < kQ; ++j) t[r] = t[r] + k.m.mrt_v[r][j] * dev[j];
  }
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    float fp = f[i] - k.inv_tau * dev[i];
#pragma unroll
    for (int r = 0; r < kMrtRank; ++r) fp = fp - k.m.mrt_u[i][r] * t[r];
    f[i] = fp;
  }
}

// Regularized BGK: the deviation replaced by its second-order Hermite
// projection (9/2) w_i Q_i:Pi before relaxing.
__device__ __forceinline__ void collide_regularized(float* f,
                                                    const Consts& k) {
  float dev[kQ];
  deviations(f, moments3d(f), k.w, dev);
  const Stress p = stress(dev);
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const float proj = k.m.reg_diag[0][i] * p.xx + k.m.reg_diag[1][i] * p.yy +
                       k.m.reg_diag[2][i] * p.zz + k.m.reg_off[0][i] * p.xy +
                       k.m.reg_off[1][i] * p.xz + k.m.reg_off[2][i] * p.yz;
    f[i] = (f[i] - dev[i]) + k.m.reg_keep * proj;
  }
}

// BGK at the per-cell Smagorinsky rate (tpulbm::smagorinsky_inv_tau).
__device__ __forceinline__ void collide_smagorinsky(float* f,
                                                    const Consts& k) {
  const Moments m = moments3d(f);
  float dev[kQ];
  deviations(f, m, k.w, dev);
  const float inv_t =
      tpulbm::smagorinsky_inv_tau(stress_norm(stress(dev)), m.inv_rho,
                                  k.m.smag_tau0, k.m.smag_tau0_sq,
                                  k.m.smag_coef);
#pragma unroll
  for (int i = 0; i < kQ; ++i) f[i] = f[i] - inv_t * dev[i];
}

// BGK at the per-cell power-law rate (tpulbm::power_law_inv_tau).
__device__ __forceinline__ void collide_power_law(float* f, const Consts& k) {
  const Moments m = moments3d(f);
  float dev[kQ];
  deviations(f, m, k.w, dev);
  const float inv_t = tpulbm::power_law_inv_tau(
      1.5f * stress_norm(stress(dev)) * m.inv_rho, k.m.plaw_nm1,
      k.m.plaw_log3k, k.m.plaw_lam_lo, k.m.plaw_lam_hi);
#pragma unroll
  for (int i = 0; i < kQ; ++i) f[i] = f[i] - inv_t * dev[i];
}

// One cell's collision in the library's mode, in place. The BGK case is
// the relaxation every earlier build of these kernels ran.
__device__ __forceinline__ void collide(float* f, const Consts& k) {
  if constexpr (kMode == tpulbm::kBGK) {
    collide_bgk(f, k);
  } else if constexpr (kMode == tpulbm::kTRT) {
    collide_trt(f, k);
  } else if constexpr (kMode == tpulbm::kMRT) {
    collide_mrt(f, k);
  } else if constexpr (kMode == tpulbm::kRegularized) {
    collide_regularized(f, k);
  } else if constexpr (kMode == tpulbm::kSmagorinsky) {
    collide_smagorinsky(f, k);
  } else {
    collide_power_law(f, k);
  }
}

// One cell's collision with what the build adds to it, in place: nothing
// on a solid cell under the bounce-back obstacle (it keeps its
// populations), else the collision, with kSource the source and with
// kForce the force profile's source at the cell, prof[i * stride] for
// population i: the column of the (Q, nz) table at the plane of the cell
// that owns it (z mod nz), so that every halo or widened-tile cell adds
// the source its owner adds.
__device__ __forceinline__ void collide_cell(float* f, const Consts& k,
                                             bool solid,
                                             const float* prof = nullptr,
                                             int stride = 0) {
  if constexpr (kBounceBack) {
    if (solid) return;
  }
  collide(f, k);
  if constexpr (tpulbm::kSource) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) f[i] = f[i] + k.src[i];
  }
  if constexpr (tpulbm::kForce) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) f[i] = f[i] + prof[i * stride];
  }
}

// Pull g_i(x, y, z) = f_post_i((x, y, z) - c_i) with the reference's ghost
// rule: a source across a y or z edge gives the frozen equilibrium, one
// across only an x edge gives zero (in the duct the x axis wraps, in the
// box every axis, and the caller's post returns the wrapped neighbour), and
// an in-domain source gives post(Pop<i>(), ox, oy, oz), the collided value
// the caller keeps at offset (ox, oy, oz) = -c_i from (x, y, z).
template <class Post>
__device__ __forceinline__ void pull3d(float* g, int x, int y, int z, int nx,
                                       int ny, int nz, const Consts& k,
                                       const Post& post) {
  if ((kPeriodicX || (x > 0 && x < nx - 1)) &&
      (kPeriodicY || (y > 0 && y < ny - 1)) &&
      (kPeriodicZ || (z > 0 && z < nz - 1))) {
    // every source lies in the domain: the same values, no edge tests
#define TPULBM_PULL_IN(i, cx, cy, cz, o) \
  g[i] = post(Pop<i>(), -(cx), -(cy), -(cz));
    TPULBM_LAT3D(TPULBM_PULL_IN)
#undef TPULBM_PULL_IN
    return;
  }
#define TPULBM_PULL(i, cx, cy, cz, o)                                      \
  {                                                                        \
    const int sx = x - (cx), sy = y - (cy), sz = z - (cz);                 \
    if ((!kPeriodicY && (sy < 0 || sy >= ny)) ||                           \
        (!kPeriodicZ && (sz < 0 || sz >= nz))) {                           \
      g[i] = k.eq_in[i];                                                   \
    } else if (!kPeriodicX && (sx < 0 || sx >= nx)) {                      \
      g[i] = 0.0f;                                                         \
    } else {                                                               \
      g[i] = post(Pop<i>(), -(cx), -(cy), -(cz));                          \
    }                                                                      \
  }
  TPULBM_LAT3D(TPULBM_PULL)
#undef TPULBM_PULL
}

// The part of the boundary sequence that precedes the outlet, on the
// post-stream populations of a fluid cell at (x, y, z), in place:
// bounce-back y walls (bottom, then top), z walls (bottom, then top), each
// reading what the one before wrote, then (the obstacle domain) the
// equilibrium inlet at x = 0. The box has neither.
__device__ __forceinline__ void walls_and_inlet(float* g, int x, int y, int z,
                                                int ny, int nz,
                                                const Consts& k) {
#define TPULBM_WALL(i, cx, cy, cz, o, comp, sign) \
  if ((comp) == (sign)) g[i] = g[o];
#define TPULBM_WALL_Y0(i, cx, cy, cz, o) TPULBM_WALL(i, cx, cy, cz, o, cy, 1)
#define TPULBM_WALL_Y1(i, cx, cy, cz, o) TPULBM_WALL(i, cx, cy, cz, o, cy, -1)
#define TPULBM_WALL_Z0(i, cx, cy, cz, o) TPULBM_WALL(i, cx, cy, cz, o, cz, 1)
#define TPULBM_WALL_Z1(i, cx, cy, cz, o) TPULBM_WALL(i, cx, cy, cz, o, cz, -1)
  if constexpr (!kPeriodicY) {
    if (y == 0) { TPULBM_LAT3D(TPULBM_WALL_Y0) }
    if (y == ny - 1) { TPULBM_LAT3D(TPULBM_WALL_Y1) }
  }
  if constexpr (!kPeriodicZ) {
    if (z == 0) { TPULBM_LAT3D(TPULBM_WALL_Z0) }
    if (z == nz - 1) { TPULBM_LAT3D(TPULBM_WALL_Z1) }
  }
#undef TPULBM_WALL_Y0
#undef TPULBM_WALL_Y1
#undef TPULBM_WALL_Z0
#undef TPULBM_WALL_Z1
#undef TPULBM_WALL
  if (kHasObstacle && x == 0) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) g[i] = k.eq_in[i];
  }
}

// One cell's populations after a whole step (tpulbm's stored state:
// post-BC, pre-collision) at (x, y, z); solid_at(ox) tells whether the cell
// at offset ox along x is solid (read in the obstacle domain only). In the
// duct a cell pulls, then the walls apply; in the box it only pulls. In the
// obstacle domain a solid
// cell is pinned to rest equilibrium (the equilibrium obstacle) or stores
// its pulled populations reversed (the bounce-back obstacle); a fluid cell
// pulls, then the walls and the inlet apply. The zero-gradient outlet is
// not cell-local: a fluid cell at x = nx-1 takes every population of
// x = nx-2 as it stands after the stream and the walls, before the
// obstacle, even when nx-2 is solid (the walls skip solids), so its pull
// is that of nx-2 (of x itself when nx == 1, as a roll does).
// post(Pop<i>(), ox, oy, oz) reads the collided value at offset
// (ox, oy, oz) from (x, y, z).
template <class Solid, class Post>
__device__ __forceinline__ void step_cell(float* g, const Solid& solid_at,
                                          int x, int y, int z, int nx, int ny,
                                          int nz, const Consts& k,
                                          const Post& post) {
  if constexpr (!kHasObstacle) {
    pull3d(g, x, y, z, nx, ny, nz, k, post);
    walls_and_inlet(g, x, y, z, ny, nz, k);
    return;
  }
  if (solid_at(0)) {
    if constexpr (kBounceBack) {
      float r[kQ];
      pull3d(r, x, y, z, nx, ny, nz, k, post);
#define TPULBM_REVERSE(i, cx, cy, cz, o) g[i] = r[o];
      TPULBM_LAT3D(TPULBM_REVERSE)
#undef TPULBM_REVERSE
    } else {
#pragma unroll
      for (int i = 0; i < kQ; ++i) g[i] = k.w[i];
    }
    return;
  }
  const int dx = (x == nx - 1 && nx > 1) ? 1 : 0;
  const int xs = x - dx;
  pull3d(g, xs, y, z, nx, ny, nz, k,
             [&](auto i, int ox, int oy, int oz) {
               return post(i, ox - dx, oy, oz);
             });
  if (dx == 0 || !solid_at(-dx)) walls_and_inlet(g, xs, y, z, ny, nz, k);
}

// The Bouzidi rewrite (kBouzidi) of one fluid cell's cut links, in place,
// after its whole boundary sequence (step_cell): tpulbm's apply_bouzidi
// (ops/bouzidi.py:186-223) at one cell, in its arithmetic and order, as
// d2q9_common.cuh's. q points at the cell's entry of the link table's
// plane 0 (planes `plane` floats apart, the moving wall's scalars Q planes
// after q's); own(Pop<i>()) is the cell's own post-collision population i.
// g_opp(j) is read as it stood on entry.
template <class Own>
__device__ __forceinline__ void apply_bouzidi(float* g, const float* q,
                                              size_t plane, bool moving,
                                              const Own& own) {
  float snap[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) snap[i] = g[i];
#define TPULBM_BZ(j, cx, cy, cz, o)                                       \
  if ((j) != 0) {                                                         \
    const float qj = q[(j) * plane];                                      \
    if (qj >= 0.0f) {                                                     \
      const float fi = own(Pop<o>());                                     \
      float v;                                                            \
      if (qj < 0.5f) {                                                    \
        v = 2.0f * qj * fi + (1.0f - 2.0f * qj) * snap[o];                \
        if (moving) v = v + 6.0f * q[(kQ + (j)) * plane];                 \
      } else {                                                            \
        const float inv2q = 1.0f / (2.0f * fmaxf(qj, 0.5f));              \
        v = inv2q * fi + (1.0f - inv2q) * own(Pop<j>());                  \
        if (moving) v = v + (6.0f * inv2q) * q[(kQ + (j)) * plane];       \
      }                                                                   \
      g[j] = v;                                                           \
    }                                                                     \
  }
  TPULBM_LAT3D(TPULBM_BZ)
#undef TPULBM_BZ
}

// The populations of one row of cells at plane 0 (a shard's block row or
// one of its ring rows): population i of column c at plane z lies at
// at(c, s, zs) + z * zs + i * s. Where the row is a block row with x
// rings, columns c < 0 lie in the left ring and c >= split in the right
// one (left and right not null). Every stride fits 32 bits: a buffer holds
// fewer than 2^31 cells.
struct RowSource {
  const float* mid;
  const float* left;
  const float* right;
  unsigned stride, plane, side_stride, side_plane;
  int split;

  __device__ __forceinline__ const float* at(int c, unsigned& s,
                                             unsigned& zs) const {
    if (left != nullptr) {
      if (c < 0) {
        s = side_stride;
        zs = side_plane;
        return left + c;
      }
      if (c >= split) {
        s = side_stride;
        zs = side_plane;
        return right + c;
      }
    }
    s = stride;
    zs = plane;
    return mid + c;
  }
};

// One shard of a 3-D mesh (the rings builds, kRings): the block of rows
// [y0, y0 + nyl) and columns [x0, x0 + nxl) of the global nx x ny grid, at
// every one of its nz planes (z is never cut: f is (Q, nz, nyl, nxl)), and
// the rings its neighbours sent, each `depth` cells deep and nz planes
// tall: rb and rt the rows below and above the block, (Q, nz, depth,
// nxl + 2 hx), extended across the x rings so that they carry the diagonal
// neighbours' corners (tpulbm's ring_rows_ext_3d); rl and rr the columns
// left and right of it, (Q, nz, nyl, hx). hx is depth where the mesh cuts x
// and 0 where the block spans every column: there the duct's and the box's
// x wraps inside the block, as on one device. y never wraps inside the
// block: in the box the rows around it come from rb and rt, which carry the
// wrapped neighbours' rows, and on a cut x the wrapped columns come from rl
// and rr. mask is the kernel mask of the block and its rings, (nz, nyl +
// 2 depth, nxl + 2 depth), a byte per cell (kSolidBit, and kLinkBit under
// kBouzidi, whose link table the launch reads padded the same way).
//
// The kernels keep working in global coordinates: a window cell at global
// (gx, gy, z) is stepped where it is a cell of the domain, exactly as on
// one device, so the ghost rule, the walls, the inlet, the outlet, the
// obstacle and the force act only at the domain's own edges and cells;
// find() says whether the window cell's populations are held, in the
// block or in a ring, and locate() points at them there. A cell beyond
// the rings is never loaded: no cell that the launch writes depends on it.
struct Shard {
  const float* f;
  const float* rb;
  const float* rt;
  const float* rl;
  const float* rr;
  const uint8_t* mask;
  int nxl, nyl, nz, x0, y0, hx, depth;

  // Whether the window cell at global (gx, gy) is a cell of the domain that
  // the block or its rings hold (in the box every row and column is); if
  // so (lx, ly) are its coordinates in the block (negative or past nxl,
  // nyl in a ring) and gx is taken mod nx in the duct and the box.
  __device__ __forceinline__ bool find(int& gx, int gy, int nx, int ny,
                                       int& lx, int& ly) const {
    if (!kPeriodicY && (gy < 0 || gy >= ny)) return false;
    ly = gy - y0;
    if (ly < -depth || ly >= nyl + depth) return false;
    if (!kPeriodicX && (gx < 0 || gx >= nx)) return false;
    if (hx == 0) {
      if constexpr (kPeriodicX) {
        gx %= nx;
        if (gx < 0) gx += nx;
      }
      lx = gx - x0;
      return true;
    }
    lx = gx - x0;
    if (lx < -hx || lx >= nxl + hx) return false;
    if constexpr (kPeriodicX) {
      gx %= nx;
      if (gx < 0) gx += nx;
    }
    return true;
  }

  // Population 0 at plane z of the cell at block coordinates (lx, ly) that
  // find() returned, in the block or the ring that holds it; population i
  // lies i * stride floats further.
  __device__ __forceinline__ const float* locate(int lx, int ly, int z,
                                                 size_t& stride) const {
    const size_t wr = static_cast<size_t>(nxl) + 2 * hx;
    const size_t zc = static_cast<size_t>(z);
    if (ly < 0) {
      stride = static_cast<size_t>(nz) * depth * wr;
      return rb + (zc * depth + depth + ly) * wr + lx + hx;
    }
    if (ly >= nyl) {
      stride = static_cast<size_t>(nz) * depth * wr;
      return rt + (zc * depth + ly - nyl) * wr + lx + hx;
    }
    if (lx < 0) {
      stride = static_cast<size_t>(nz) * nyl * hx;
      return rl + (zc * nyl + ly) * hx + hx + lx;
    }
    if (lx >= nxl) {
      stride = static_cast<size_t>(nz) * nyl * hx;
      return rr + (zc * nyl + ly) * hx + lx - nxl;
    }
    stride = static_cast<size_t>(nz) * nyl * nxl;
    return f + (zc * nyl + ly) * nxl + lx;
  }

  // The index of the cell at block coordinates (lx, ly) and plane z in the
  // mask and in the link table (both padded by depth rows and columns).
  __device__ __forceinline__ size_t padded(int lx, int ly, int z) const {
    return (static_cast<size_t>(z) * (nyl + 2 * depth) + ly + depth) *
               (nxl + 2 * depth) +
           lx + depth;
  }

  // The index of the cell at block coordinates (lx, ly) and plane z in the
  // block (and in out).
  __device__ __forceinline__ size_t cell(int lx, int ly, int z) const {
    return (static_cast<size_t>(z) * nyl + ly) * nxl + lx;
  }

  // Whether the launch writes the cell at block coordinates (lx, ly).
  __device__ __forceinline__ bool writes(int lx, int ly) const {
    return lx >= 0 && lx < nxl && ly >= 0 && ly < nyl;
  }

  // find() split in two for a kernel that finds a window row's source once
  // (the 1-step kernel's z-march): whether the block or its rings hold row
  // gy (global), and if so its block row ly; then whether they hold column
  // gx of such a row, and if so its block column lx (gx taken mod nx first
  // where the block spans every column of the duct or the box). row() &&
  // column() is find().
  __device__ __forceinline__ bool row(int gy, int ny, int& ly) const {
    if (!kPeriodicY && (gy < 0 || gy >= ny)) return false;
    ly = gy - y0;
    return ly >= -depth && ly < nyl + depth;
  }
  __device__ __forceinline__ bool column(int gx, int nx, int& lx) const {
    if (!kPeriodicX && (gx < 0 || gx >= nx)) return false;
    if (hx == 0) {
      if constexpr (kPeriodicX) {
        gx %= nx;
        if (gx < 0) gx += nx;
      }
      lx = gx - x0;
      return true;
    }
    lx = gx - x0;
    return lx >= -hx && lx < nxl + hx;
  }

  // Where the populations of block row ly (one that row() returned) lie at
  // plane 0, once for the row: locate() for each of its columns, with the
  // stride from one plane to the next.
  __device__ __forceinline__ RowSource row_source(int ly) const {
    const unsigned wr = static_cast<unsigned>(nxl + 2 * hx);
    const unsigned ring_plane = static_cast<unsigned>(depth) * wr;
    const unsigned ring_pop = static_cast<unsigned>(nz) * ring_plane;
    if (ly < 0) return {rb + (depth + ly) * wr + hx, nullptr, nullptr,
                        ring_pop, ring_plane, 0, 0, 0};
    if (ly >= nyl) return {rt + (ly - nyl) * wr + hx, nullptr, nullptr,
                           ring_pop, ring_plane, 0, 0, 0};
    const unsigned block_plane = static_cast<unsigned>(nyl) * nxl;
    const unsigned side_plane = static_cast<unsigned>(nyl) * hx;
    const size_t row = static_cast<size_t>(ly);
    return {f + row * nxl,
            hx > 0 ? rl + row * hx + hx : nullptr,
            hx > 0 ? rr + row * hx - nxl : nullptr,
            static_cast<unsigned>(nz) * block_plane, block_plane,
            static_cast<unsigned>(nz) * side_plane, side_plane, nxl};
  }
};

}  // namespace tpulbm3d
