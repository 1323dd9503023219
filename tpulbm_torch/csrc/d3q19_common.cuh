// The per-cell parts of a D3Q19 timestep that the port's 3-D kernels share,
// float32: the collisions with the body force's source, the pull with the
// reference's ghost rule (or a periodic x), and the boundary sequences of
// the sphere in a duct (the obstacle domain) and of the periodic duct (the
// channel domain). step_d3q19.cu (one step per launch) and
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
// 3-D KBC); so are the domain, the source and the obstacle rule.

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

// +v, -v or nothing, by the sign of a velocity component (a literal)
#define TPULBM_SIGNED_ADD(acc, c, v) \
  if ((c) > 0) {                     \
    acc = acc + (v);                 \
  } else if ((c) < 0) {              \
    acc = acc - (v);                 \
  }

namespace tpulbm3d {

constexpr int kQ = 19;
using tpulbm::is_solid;
using tpulbm::kBounceBack;
using tpulbm::kBouzidi;
using tpulbm::kHasObstacle;
using tpulbm::kMode;
using tpulbm::kPeriodicX;
static_assert(kMode != tpulbm::kKBC, "tpulbm's KBC operator is 2-D only");
static_assert(tpulbm::kDomain != tpulbm::kCavity, "the cavity is 2-D");
static_assert(tpulbm::kDomain != tpulbm::kBox && !tpulbm::kForce,
              "the 3-D periodic box and force profile are not ported");

// MRT's rank-r correction, zero-padded to the largest D3Q19 rank: only the
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

// Density and velocity of one cell's 19 populations.
struct Moments {
  float rho, inv_rho, ux, uy, uz;
};

__device__ __forceinline__ Moments moments_d3q19(const float* f) {
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

// BGK relaxation of one cell's 19 populations, in place.
__device__ __forceinline__ void collide_bgk(float* f, const Consts& k) {
  const Moments m = moments_d3q19(f);
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
  TPULBM_D3Q19(TPULBM_RELAX)
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
  TPULBM_D3Q19(TPULBM_DEV)
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
  TPULBM_D3Q19(TPULBM_PI)
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
  const Moments m = moments_d3q19(f);
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
  TPULBM_D3Q19(TPULBM_TRT)
#undef TPULBM_TRT
#pragma unroll
  for (int i = 0; i < kQ; ++i) f[i] = out[i];
}

// MRT in rank-r form: f - dev/tau - sum_r U[:,r] (V[r] . dev). The padded
// ranks and the zeros Pallas skips add 0·x, which leaves every finite value
// as it is.
__device__ __forceinline__ void collide_mrt(float* f, const Consts& k) {
  float dev[kQ];
  deviations(f, moments_d3q19(f), k.w, dev);
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
  deviations(f, moments_d3q19(f), k.w, dev);
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
  const Moments m = moments_d3q19(f);
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
  const Moments m = moments_d3q19(f);
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
// populations), else the collision and, with kSource, the source.
__device__ __forceinline__ void collide_cell(float* f, const Consts& k,
                                             bool solid) {
  if constexpr (kBounceBack) {
    if (solid) return;
  }
  collide(f, k);
  if constexpr (tpulbm::kSource) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) f[i] = f[i] + k.src[i];
  }
}

// Pull g_i(x, y, z) = f_post_i((x, y, z) - c_i) with the reference's ghost
// rule: a source across a y or z edge gives the frozen equilibrium, one
// across only an x edge gives zero (in the duct the x axis wraps, and the
// caller's post returns the wrapped neighbour), and an in-domain source
// gives post(Pop<i>(), ox, oy, oz), the collided value the caller keeps at
// offset (ox, oy, oz) = -c_i from (x, y, z).
template <class Post>
__device__ __forceinline__ void pull_d3q19(float* g, int x, int y, int z,
                                           int nx, int ny, int nz,
                                           const Consts& k, const Post& post) {
  if ((kPeriodicX || (x > 0 && x < nx - 1)) && y > 0 && y < ny - 1 &&
      z > 0 && z < nz - 1) {
    // every source lies in the domain: the same values, no edge tests
#define TPULBM_PULL_IN(i, cx, cy, cz, o) \
  g[i] = post(Pop<i>(), -(cx), -(cy), -(cz));
    TPULBM_D3Q19(TPULBM_PULL_IN)
#undef TPULBM_PULL_IN
    return;
  }
#define TPULBM_PULL(i, cx, cy, cz, o)                                      \
  {                                                                        \
    const int sx = x - (cx), sy = y - (cy), sz = z - (cz);                 \
    if (sy < 0 || sy >= ny || sz < 0 || sz >= nz) {                        \
      g[i] = k.eq_in[i];                                                   \
    } else if (!kPeriodicX && (sx < 0 || sx >= nx)) {                      \
      g[i] = 0.0f;                                                         \
    } else {                                                               \
      g[i] = post(Pop<i>(), -(cx), -(cy), -(cz));                          \
    }                                                                      \
  }
  TPULBM_D3Q19(TPULBM_PULL)
#undef TPULBM_PULL
}

// The part of the boundary sequence that precedes the outlet, on the
// post-stream populations of a fluid cell at (x, y, z), in place:
// bounce-back y walls (bottom, then top), z walls (bottom, then top), each
// reading what the one before wrote, then (the obstacle domain) the
// equilibrium inlet at x = 0.
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
  if (kHasObstacle && x == 0) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) g[i] = k.eq_in[i];
  }
}

// One cell's populations after a whole step (tpulbm's stored state:
// post-BC, pre-collision) at (x, y, z); solid_at(ox) tells whether the cell
// at offset ox along x is solid (read in the obstacle domain only). In the
// duct a cell pulls, then the walls apply. In the obstacle domain a solid
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
    pull_d3q19(g, x, y, z, nx, ny, nz, k, post);
    walls_and_inlet(g, x, y, z, ny, nz, k);
    return;
  }
  if (solid_at(0)) {
    if constexpr (kBounceBack) {
      float r[kQ];
      pull_d3q19(r, x, y, z, nx, ny, nz, k, post);
#define TPULBM_REVERSE(i, cx, cy, cz, o) g[i] = r[o];
      TPULBM_D3Q19(TPULBM_REVERSE)
#undef TPULBM_REVERSE
    } else {
#pragma unroll
      for (int i = 0; i < kQ; ++i) g[i] = k.w[i];
    }
    return;
  }
  const int dx = (x == nx - 1 && nx > 1) ? 1 : 0;
  const int xs = x - dx;
  pull_d3q19(g, xs, y, z, nx, ny, nz, k,
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
  TPULBM_D3Q19(TPULBM_BZ)
#undef TPULBM_BZ
}

}  // namespace tpulbm3d
