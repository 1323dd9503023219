// The per-cell parts of a D2Q9 timestep that every kernel of the port
// shares, float32: moments and the collisions with the body force's
// source and the force profile's, the pull with the reference's ghost rule
// (or a periodic x, or periodic x and y), and the boundary sequence of
// each domain. The D2Q9 row march (d2q9_march.cuh), which step_d2q9.cu
// runs at one step per launch and step_d2q9_blocked.cu at N, builds on
// these functions, so that N launches of the first and one launch of the
// second run the same operations in the same order and give the same bits;
// the
// thermal and multiphase kernels (step_thermal.cu, step_multiphase.cu)
// reuse the moments and the BGK and Smagorinsky relaxations.
//
// Rounding: the BGK relaxation follows the plain version
// (tpulbm_torch/ops/step_torch.py); the other collisions follow the
// arithmetic of tpulbm's Pallas kernel (tpulbm/ops/step_pallas.py:170-415)
// where it differs from the plain version's, so kernel and plain version
// agree at float32 rounding, not bitwise. The libraries are built with
// -fmad=false, so no multiply and add are fused into one rounding, and
// without fast math, so sqrtf, expf, logf and division stay IEEE.
//
// The collision, the domain, the source and the obstacle rule are fixed
// when a library is built (collision_modes.cuh).

#pragma once

#include <stdint.h>
#include <string.h>

#include "collision_modes.cuh"

namespace tpulbm {

constexpr int kQ = 9;
static_assert(!kD3Q27, "TPULBM_Q picks a 3-D velocity set");

// MRT's rank-r correction, zero-padded to the largest D2Q9 rank (e, eps,
// qx, qy: the non-conserved, non-shear moments)
constexpr int kMrtRank = 4;

// The collisions' coefficients, computed on the host in double precision
// as tpulbm's _physics_cfg_fields computes them and rounded once to float
// (ops/step_cuda.py::mode_floats writes them in this order). A mode reads
// only its own.
struct ModeConsts {
  float trt_hp, trt_hm;        // TRT: 0.5/tau and 0.5·ω⁻
  float mrt_u[kQ][kMrtRank];   // MRT: U (Q x r) and V (r x Q)
  float mrt_v[kMrtRank][kQ];
  float reg_keep;              // regularized: 1 - 1/tau, and the shell
  float reg_a[kQ], reg_b[kQ], reg_g[kQ];  // weights of Pi_xx, Pi_yy, Pi_xy
  float kbc_sp[kQ], kbc_sn[kQ];            // KBC: shear and higher parts
  float kbc_ht[kQ], kbc_hqx[kQ], kbc_hqy[kQ], kbc_ha[kQ];
  float kbc_inv_beta, kbc_two_minus_inv_beta, kbc_beta, kbc_two_beta;
  float smag_tau0, smag_tau0_sq, smag_coef;  // Smagorinsky: 18 Cs^2
  float plaw_nm1, plaw_log3k, plaw_lam_lo, plaw_lam_hi;  // power law
};

struct StepConsts {
  float inv_tau;         // 1 / tau
  float u_in;            // inlet velocity
  float one_minus_u_in;  // 1 - u_in, rounded once on the host
  float eq_in[kQ];       // frozen ghost equilibrium(rho=1, u=(u_in, 0))
  float w[kQ];           // lattice weights: the rest equilibrium of solids
  ModeConsts m;
  float src[kQ];         // body-force source 3 w_i (c_i . F) (kSource)
  float lid7, lid8;      // the lid's 6 w_i (c_i . u_lid) for i = 7, 8
};

constexpr int kModeFloats = sizeof(ModeConsts) / sizeof(float);
static_assert(sizeof(ModeConsts) == kModeFloats * sizeof(float),
              "ModeConsts holds floats only");

inline StepConsts make_consts(float inv_tau, float u_in, float one_minus_u_in,
                              const float* eq_in, const float* w,
                              const float* mode, const float* src, float lid7,
                              float lid8) {
  StepConsts k;
  k.inv_tau = inv_tau;
  k.u_in = u_in;
  k.one_minus_u_in = one_minus_u_in;
  for (int i = 0; i < kQ; ++i) {
    k.eq_in[i] = eq_in[i];
    k.w[i] = w[i];
    k.src[i] = src[i];
  }
  k.lid7 = lid7;
  k.lid8 = lid8;
  memcpy(&k.m, mode, sizeof(ModeConsts));
  return k;
}

// Density and velocity of one cell's 9 populations, u = m * (1/rho) as the
// Pallas kernels compute it.
struct Moments {
  float rho, ux, uy;
};

__device__ __forceinline__ Moments moments_d2q9(const float* f) {
  float rho = f[0];
#pragma unroll
  for (int i = 1; i < kQ; ++i) rho = rho + f[i];
  const float mx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8];
  const float my = f[2] - f[4] + f[5] + f[6] - f[7] - f[8];
  const float inv_rho = 1.0f / rho;
  return {rho, mx * inv_rho, my * inv_rho};
}

// BGK relaxation of 9 populations toward equilibrium(m.rho, m.u), in place.
__device__ __forceinline__ void relax_bgk(float* f, const Moments& m,
                                          float inv_tau, const float* w) {
  const float rho = m.rho, ux = m.ux, uy = m.uy;
  const float base = 1.0f - 1.5f * (ux * ux + uy * uy);
  // c_i . u for i = 1..8, as exact +-adds
  const float cu[kQ] = {0.0f, ux, uy, -ux, -uy,
                        ux + uy, -ux + uy, -ux + -uy, ux + -uy};
  f[0] = f[0] - inv_tau * (f[0] - w[0] * rho * base);
#pragma unroll
  for (int i = 1; i < kQ; ++i) {
    const float feq = w[i] * rho * (base + 3.0f * cu[i] + 4.5f * cu[i] * cu[i]);
    f[i] = f[i] - inv_tau * (f[i] - feq);
  }
}

// The non-equilibrium parts dev_i = f_i - feq_i, with feq as relax_bgk
// computes it, and the equilibria themselves.
__device__ __forceinline__ void deviations(const float* f, const Moments& m,
                                           const float* w, float* feq,
                                           float* dev) {
  const float rho = m.rho, ux = m.ux, uy = m.uy;
  const float base = 1.0f - 1.5f * (ux * ux + uy * uy);
  const float cu[kQ] = {0.0f, ux, uy, -ux, -uy,
                        ux + uy, -ux + uy, -ux + -uy, ux + -uy};
  feq[0] = w[0] * rho * base;
#pragma unroll
  for (int i = 1; i < kQ; ++i)
    feq[i] = w[i] * rho * (base + 3.0f * cu[i] + 4.5f * cu[i] * cu[i]);
#pragma unroll
  for (int i = 0; i < kQ; ++i) dev[i] = f[i] - feq[i];
}

// The non-equilibrium momentum flux Pi_ab = sum_i c_ia c_ib dev_i.
struct Stress {
  float xx, yy, xy;
};

__device__ __forceinline__ Stress stress(const float* d) {
  return {d[1] + d[3] + d[5] + d[6] + d[7] + d[8],
          d[2] + d[4] + d[5] + d[6] + d[7] + d[8],
          d[5] - d[6] + d[7] - d[8]};
}

// TRT in the Pallas kernel's closed form: feq_i ± feq_opp(i) is
// 2 w rho (base + 4.5 cu²) and 6 w rho cu.
__device__ __forceinline__ void collide_trt(float* f, const StepConsts& k) {
  constexpr int opp[kQ] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  const Moments m = moments_d2q9(f);
  const float rho = m.rho, ux = m.ux, uy = m.uy;
  const float base = 1.0f - 1.5f * (ux * ux + uy * uy);
  const float cu[kQ] = {0.0f, ux, uy, -ux, -uy,
                        ux + uy, -ux + uy, -ux + -uy, ux + -uy};
  float out[kQ];
  out[0] = f[0] - k.inv_tau * (f[0] - k.w[0] * rho * base);
#pragma unroll
  for (int i = 1; i < kQ; ++i) {
    const float wr = k.w[i] * rho;
    const float fo = f[opp[i]];
    const float even = (f[i] + fo) - 2.0f * wr * (base + 4.5f * cu[i] * cu[i]);
    const float odd = (f[i] - fo) - 6.0f * wr * cu[i];
    out[i] = f[i] - k.m.trt_hp * even - k.m.trt_hm * odd;
  }
#pragma unroll
  for (int i = 0; i < kQ; ++i) f[i] = out[i];
}

// MRT in rank-r form: f - dev/tau - sum_r U[:,r] (V[r] . dev). The padded
// ranks and the structural zeros Pallas skips add 0·x, which leaves every
// finite value as it is.
__device__ __forceinline__ void collide_mrt(float* f, const StepConsts& k) {
  float feq[kQ], dev[kQ];
  deviations(f, moments_d2q9(f), k.w, feq, dev);
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
                                                    const StepConsts& k) {
  float feq[kQ], dev[kQ];
  deviations(f, moments_d2q9(f), k.w, feq, dev);
  const Stress p = stress(dev);
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const float proj = k.m.reg_a[i] * p.xx + k.m.reg_b[i] * p.yy +
                       k.m.reg_g[i] * p.xy;
    f[i] = (f[i] - dev[i]) + k.m.reg_keep * proj;
  }
}

// KBC: shear part at 2 beta = 1/tau, higher part at beta·gamma, with the
// entropic gamma = 1/beta - (2 - 1/beta) <ds|dh> / (<dh|dh> + 1e-10). The
// sums keep the Pallas kernel's order: the ratio amplifies rounding.
__device__ __forceinline__ void collide_kbc(float* f, const StepConsts& k) {
  float feq[kQ], dev[kQ];
  deviations(f, moments_d2q9(f), k.w, feq, dev);
  const Stress p = stress(dev);
  const float dn = p.xx - p.yy;
  const float dt = p.xx + p.yy;
  const float dqx = dev[5] - dev[6] - dev[7] + dev[8];  // sum c_x c_y² dev
  const float dqy = dev[5] + dev[6] - dev[7] - dev[8];  // sum c_x² c_y dev
  const float da = dev[5] + dev[6] + dev[7] + dev[8];   // sum c_x² c_y² dev
  float ds[kQ], dh[kQ];
  float sh = 0.0f, hh = 0.0f;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    ds[i] = k.m.kbc_sp[i] * p.xy + k.m.kbc_sn[i] * dn;
    dh[i] = k.m.kbc_ht[i] * dt + k.m.kbc_hqx[i] * dqx +
            k.m.kbc_hqy[i] * dqy + k.m.kbc_ha[i] * da;
    const float ife = 1.0f / feq[i];
    const float t1 = ds[i] * dh[i] * ife;
    const float t2 = dh[i] * dh[i] * ife;
    sh = i == 0 ? t1 : sh + t1;
    hh = i == 0 ? t2 : hh + t2;
  }
  const float gamma =
      k.m.kbc_inv_beta - k.m.kbc_two_minus_inv_beta * sh / (hh + 1e-10f);
  const float bg = k.m.kbc_beta * gamma;
#pragma unroll
  for (int i = 0; i < kQ; ++i)
    f[i] = f[i] - k.m.kbc_two_beta * ds[i] - bg * dh[i];
}

// BGK of 9 populations at the per-cell Smagorinsky rate of
// smagorinsky_inv_tau, Q̄ = sqrt(2 (Pi_xx² + Pi_yy² + 2 Pi_xy²)), in place;
// the thermal kernel's LES build relaxes its flow planes with it too.
__device__ __forceinline__ void relax_smagorinsky(float* f, const Moments& m,
                                                  const float* w, float tau0,
                                                  float tau0_sq, float coef) {
  float feq[kQ], dev[kQ];
  deviations(f, m, w, feq, dev);
  const Stress p = stress(dev);
  const float qbar = sqrtf(2.0f * (p.xx * p.xx + p.yy * p.yy +
                                   2.0f * (p.xy * p.xy)));
  const float inv_t = smagorinsky_inv_tau(qbar, 1.0f / m.rho, tau0, tau0_sq,
                                          coef);
#pragma unroll
  for (int i = 0; i < kQ; ++i) f[i] = f[i] - inv_t * dev[i];
}

__device__ __forceinline__ void collide_smagorinsky(float* f,
                                                    const StepConsts& k) {
  relax_smagorinsky(f, moments_d2q9(f), k.w, k.m.smag_tau0, k.m.smag_tau0_sq,
                    k.m.smag_coef);
}

// BGK at the per-cell power-law rate of power_law_inv_tau, Q̄ summed as
// Pi_xx² + 2 Pi_xy² + Pi_yy².
__device__ __forceinline__ void collide_power_law(float* f,
                                                  const StepConsts& k) {
  const Moments m = moments_d2q9(f);
  float feq[kQ], dev[kQ];
  deviations(f, m, k.w, feq, dev);
  const Stress p = stress(dev);
  const float qbar = sqrtf(2.0f * (p.xx * p.xx + 2.0f * (p.xy * p.xy) +
                                   p.yy * p.yy));
  const float inv_t = power_law_inv_tau(
      1.5f * qbar * (1.0f / m.rho), k.m.plaw_nm1, k.m.plaw_log3k,
      k.m.plaw_lam_lo, k.m.plaw_lam_hi);
#pragma unroll
  for (int i = 0; i < kQ; ++i) f[i] = f[i] - inv_t * dev[i];
}

// One cell's collision in the library's mode, in place. The BGK case is
// the relaxation every earlier build of these kernels ran.
__device__ __forceinline__ void collide(float* f, const StepConsts& k) {
  if constexpr (kMode == kBGK) {
    relax_bgk(f, moments_d2q9(f), k.inv_tau, k.w);
  } else if constexpr (kMode == kTRT) {
    collide_trt(f, k);
  } else if constexpr (kMode == kMRT) {
    collide_mrt(f, k);
  } else if constexpr (kMode == kRegularized) {
    collide_regularized(f, k);
  } else if constexpr (kMode == kKBC) {
    collide_kbc(f, k);
  } else if constexpr (kMode == kSmagorinsky) {
    collide_smagorinsky(f, k);
  } else {
    collide_power_law(f, k);
  }
}

// One cell's collision with what the build adds to it, in place: nothing
// on a solid cell under the bounce-back obstacle (it keeps its
// populations), else the collision, with kSource the source and with
// kForce the force profile's source at the cell, prof[i * stride] for
// population i (the caller's staged table, ForceTable). Under the
// equilibrium obstacle solid cells collide like fluid ones: the pin
// replaces them after the stream.
__device__ __forceinline__ void collide_cell(float* f, const StepConsts& k,
                                             bool solid,
                                             const float* prof = nullptr,
                                             int stride = 0) {
  if constexpr (kBounceBack) {
    if (solid) return;
  }
  collide(f, k);
  if constexpr (kSource) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) f[i] = f[i] + k.src[i];
  }
  if constexpr (kForce) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) f[i] = f[i] + prof[i * stride];
  }
}

// The force profile (kForce): `table` is the (9, n) source
// S_i(c) = 3 w_i (c_i . F(c)) at the coordinates c = 0 .. n-1 along `axis`
// (0 x, n = nx; 1 y, n = ny), computed on the host as the plain version
// computes it. A kernel stages the entries of its window's rows (axis 1)
// or columns (axis 0) in shared memory once per block (the N-step march:
// its widened columns once, a y profile's rows as they enter): `stage`
// fills dst[i * len + t] with the entry of window position t at global
// coordinate start + t, taken mod n, so every window, halo or ring cell
// adds the source of the cell that owns it and N launches of one step
// give the bits of one N-step launch.
struct ForceTable {
  const float* table;
  int axis;

  __device__ __forceinline__ void stage(float* dst, int len, int start,
                                        int n, int tid,
                                        int threads) const {
    for (int t = tid; t < len; t += threads) {
      int c = (start + t) % n;
      if (c < 0) c += n;
#pragma unroll
      for (int i = 0; i < kQ; ++i) dst[i * len + t] = table[i * n + c];
    }
  }
};

// Pull g_i(x, y) = f_post_i((x, y) - c_i) with the reference's ghost rule:
// a source across a y edge (corners included) gives the frozen equilibrium,
// one across an x edge gives zero (in the channel the x axis wraps, in the
// box both axes, and the caller's post returns the wrapped neighbour), and
// an in-domain source gives post(i, dx, dy), the post-collision value of
// population i at (x + dx, y + dy) that the caller keeps.
template <class Post>
__device__ __forceinline__ void pull_d2q9(float* g, int x, int y, int nx,
                                          int ny, const StepConsts& k,
                                          const Post& post) {
  auto pull = [&](int i, int cx, int cy) -> float {
    const int sy = y - cy;
    const int sx = x - cx;
    if (!kPeriodicY && (sy < 0 || sy >= ny)) return k.eq_in[i];
    if (!kPeriodicX && (sx < 0 || sx >= nx)) return 0.0f;
    return post(i, -cx, -cy);
  };
  g[0] = pull(0, 0, 0);
  g[1] = pull(1, 1, 0);
  g[2] = pull(2, 0, 1);
  g[3] = pull(3, -1, 0);
  g[4] = pull(4, 0, -1);
  g[5] = pull(5, 1, 1);
  g[6] = pull(6, -1, 1);
  g[7] = pull(7, -1, -1);
  g[8] = pull(8, 1, -1);
}

// Bounce-back y walls on one cell, bottom then top.
__device__ __forceinline__ void walls_y(float* g, int y, int ny) {
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
}

// The edge rules of the obstacle domain on one fluid cell's post-stream
// populations, in place: bounce-back walls (bottom, then top) -> Zou-He
// inlet -> Zou-He outlet. Every rule reads only this cell.
__device__ __forceinline__ void apply_edges(float* g, int x, int y, int nx,
                                            int ny, const StepConsts& k) {
  walls_y(g, y, ny);
  // Zou-He velocity inlet at x = 0
  if (x == 0) {
    const float rho_bc =
        (g[0] + g[2] + g[4] + 2.0f * (g[3] + g[6] + g[7])) / k.one_minus_u_in;
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

// One corner node of the clean closure: the wall-tangential unknowns X
// (along x), Y (along y) and D (the inward diagonal) bounce back from
// their opposites and the diagonal pair P0, P1 takes the density residual
// 0.5 (rho* - g0) - (g_opp(X) + g_opp(Y) + g_opp(D)), summed as the Pallas
// kernel sums it.
template <int X, int Y, int D, int P0, int P1>
__device__ __forceinline__ void close_corner(float* g, float rho_star) {
  constexpr int opp[kQ] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  const float resid =
      0.5f * (rho_star - g[0]) - (g[opp[X]] + g[opp[Y]] + g[opp[D]]);
  g[X] = g[opp[X]];
  g[Y] = g[opp[Y]];
  g[D] = g[opp[D]];
  g[P0] = resid;
  g[P1] = resid;
}

// The clean Zou-He corner closure (tpulbm ops/boundaries.py:163-200,
// step_pallas.py:672-704) at a fluid wall∩inlet/outlet cell, after its edge
// rules. At the inlet corners rho* is the density of the node one row
// inward on the same column after ITS pull, walls and inlet, which this
// thread recomputes from post() (so the caller must hold the post-collision
// values two rows inward) and solid_at(dx, dy), the solid flag at
// (x + dx, y + dy). At the outlet corners rho* = 1.
template <class Post, class SolidAt>
__device__ __forceinline__ void apply_corner(float* g, int x, int y, int nx,
                                             int ny, const StepConsts& k,
                                             const Post& post,
                                             const SolidAt& solid_at) {
  const bool bottom = y == 0;
  const bool inlet = x == 0;
  float rho_star = 1.0f;
  if (inlet) {
    const int dy = ny == 1 ? 0 : bottom ? 1 : -1;
    float h[kQ];
    pull_d2q9(h, x, y + dy, nx, ny, k, [&](int i, int sx, int sy) {
      return post(i, sx, sy + dy);
    });
    if (!solid_at(0, dy)) apply_edges(h, x, y + dy, nx, ny, k);
    rho_star = h[0];
#pragma unroll
    for (int i = 1; i < kQ; ++i) rho_star = rho_star + h[i];
  }
  if (inlet && bottom) {
    close_corner<1, 2, 5, 6, 8>(g, rho_star);
  } else if (bottom) {
    close_corner<3, 2, 6, 5, 7>(g, rho_star);
  } else if (inlet) {
    close_corner<1, 4, 8, 5, 7>(g, rho_star);
  } else {
    close_corner<3, 4, 7, 6, 8>(g, rho_star);
  }
}

// The cavity's walls on one cell, in place, in tpulbm's order: the bottom
// wall; the top wall moving at u_lid, f_i <- f_opp(i) + 6 w_i rho_w
// (c_i . u_lid) with rho_w = sum_{c_y = 0} f + 2 sum_{c_y > 0} f in index
// order (the known populations); then the side walls, left and right.
__device__ __forceinline__ void cavity_walls(float* g, int x, int y, int nx,
                                             int ny, const StepConsts& k) {
  if (y == 0) {
    g[2] = g[4];
    g[5] = g[7];
    g[6] = g[8];
  }
  if (y == ny - 1) {
    float rho_w = g[0] + g[1];
    rho_w = rho_w + 2.0f * g[2];
    rho_w = rho_w + g[3];
    rho_w = rho_w + 2.0f * g[5];
    rho_w = rho_w + 2.0f * g[6];
    g[4] = g[2];
    g[7] = g[5] + k.lid7 * rho_w;
    g[8] = g[6] + k.lid8 * rho_w;
  }
  if (x == 0) {
    g[1] = g[3];
    g[5] = g[7];
    g[8] = g[6];
  }
  if (x == nx - 1) {
    g[3] = g[1];
    g[6] = g[8];
    g[7] = g[5];
  }
}

// The cavity's corner closure (tpulbm ops/boundaries.py:203-246,
// step_pallas.py:598-641) at a wall∩wall cell, after its walls: rho* is the
// density of the diagonally inward neighbour after its pull (an interior
// cell when nx, ny >= 3: no ghost rule, no wall), which this thread
// recomputes from post(), so the caller must hold the post-collision values
// two cells inward in x and y; its populations are summed in index order.
template <class Post>
__device__ __forceinline__ void cavity_corner(float* g, int x, int y, int nx,
                                              int ny, const StepConsts& k,
                                              const Post& post) {
  const int dx = x == 0 ? 1 : -1;
  const int dy = y == 0 ? 1 : -1;
  float h[kQ];
  pull_d2q9(h, x + dx, y + dy, nx, ny, k, [&](int i, int sx, int sy) {
    return post(i, sx + dx, sy + dy);
  });
  float rho_star = h[0];
#pragma unroll
  for (int i = 1; i < kQ; ++i) rho_star = rho_star + h[i];
  if (dy > 0 && dx > 0) {
    close_corner<1, 2, 5, 6, 8>(g, rho_star);
  } else if (dy > 0) {
    close_corner<3, 2, 6, 5, 7>(g, rho_star);
  } else if (dx > 0) {
    close_corner<1, 4, 8, 5, 7>(g, rho_star);
  } else {
    close_corner<3, 4, 7, 6, 8>(g, rho_star);
  }
}

// The Bouzidi rewrite (kBouzidi) of one fluid cell's cut links, in place,
// after its edge rules: tpulbm's apply_bouzidi (ops/bouzidi.py:186-223)
// at one cell, in its arithmetic and order. q points at the cell's entry
// of the link table's plane 0 (planes `plane` floats apart, the moving
// wall's scalars Q planes after q's), post(i, 0, 0) is the cell's own
// post-collision population i. Direction j is cut where q_j >= 0:
//   q_j < 1/2:  g_j = 2 q_j f̂_i + (1 - 2 q_j) g_i  (+ 6 tw_j)
//   q_j >= 1/2: g_j = inv2q f̂_i + (1 - inv2q) f̂_j  (+ (6 inv2q) tw_j),
// inv2q = 1 / (2 max(q_j, 1/2)), i = opp(j), g_i as it stood on entry (a
// copy, so a cell cut along both j and opp(j) reads the values of before
// the rewrite). apply_bouzidi_at takes the entries from q_at(j) (q_j, and
// the wall's scalar at kQ + j), so that a kernel may hold them in
// registers.
template <class QAt, class Post>
__device__ __forceinline__ void apply_bouzidi_at(float* g, const QAt& q_at,
                                                 bool moving,
                                                 const Post& post) {
  constexpr int opp[kQ] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  float snap[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) snap[i] = g[i];
#pragma unroll
  for (int j = 1; j < kQ; ++j) {
    const float qj = q_at(j);
    if (!(qj >= 0.0f)) continue;
    const int i = opp[j];
    const float fi = post(i, 0, 0);
    float v;
    if (qj < 0.5f) {
      v = 2.0f * qj * fi + (1.0f - 2.0f * qj) * snap[i];
      if (moving) v = v + 6.0f * q_at(kQ + j);
    } else {
      const float inv2q = 1.0f / (2.0f * fmaxf(qj, 0.5f));
      v = inv2q * fi + (1.0f - inv2q) * post(j, 0, 0);
      if (moving) v = v + (6.0f * inv2q) * q_at(kQ + j);
    }
    g[j] = v;
  }
}
template <class Post>
__device__ __forceinline__ void apply_bouzidi(float* g, const float* q,
                                              size_t plane, bool moving,
                                              const Post& post) {
  apply_bouzidi_at(
      g, [&](int j) { return q[j * plane]; }, moving, post);
}

// The boundary sequence of the library's domain on one cell's post-stream
// populations, in place. The obstacle domain: on a solid cell the obstacle
// rule (the pin to rest equilibrium, or under kBounceBack the pulled
// populations reversed), else the edge rules, then (kCorners) the clean
// corners, then (kBouzidi) the rewrite of the cell's cut links, where
// `link` (the cell's entry of the link table's plane 0) is not null. The
// channel: the y walls; the slab (kSlab, the channel without them) the
// obstacle domain's sequence with no edge rule: its y edges are the pull's
// frozen-equilibrium ghosts (tpulbm's walls_y off) and its walls solid
// rows. The cavity: its walls, then the corner closure. The box: nothing.
// post and solid_at as for apply_corner; solid is false outside the
// obstacle domain and the slab. The obstacle domain's kernels are built
// with and without the clean corners (kCornerRule), so that a run without
// them carries no trace of their code.
template <bool kCorners, class Post, class SolidAt>
__device__ __forceinline__ void apply_boundaries(
    float* g, bool solid, int x, int y, int nx, int ny, const StepConsts& k,
    const Post& post, const SolidAt& solid_at, const float* link = nullptr,
    const Links& links = Links{}) {
  if constexpr (kDomain == kBox) {
    return;
  } else if constexpr (kDomain == kChannel && !kSlab) {
    walls_y(g, y, ny);
  } else if constexpr (kDomain == kCavity) {
    cavity_walls(g, x, y, nx, ny, k);
    if ((x == 0 || x == nx - 1) && (y == 0 || y == ny - 1))
      cavity_corner(g, x, y, nx, ny, k, post);
  } else {
    if (solid) {
      if constexpr (kBounceBack) {
        constexpr int opp[kQ] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
        float r[kQ];
#pragma unroll
        for (int i = 0; i < kQ; ++i) r[i] = g[opp[i]];
#pragma unroll
        for (int i = 0; i < kQ; ++i) g[i] = r[i];
      } else {
        // equilibrium obstacle: solid cells are pinned to rest equilibrium
#pragma unroll
        for (int i = 0; i < kQ; ++i) g[i] = k.w[i];
      }
      return;
    }
    if constexpr (!kSlab) {
      apply_edges(g, x, y, nx, ny, k);
      if constexpr (kCorners) {
        if ((x == 0 || x == nx - 1) && (y == 0 || y == ny - 1))
          apply_corner(g, x, y, nx, ny, k, post, solid_at);
      }
    }
    if constexpr (kBouzidi) {
      if (link != nullptr)
        apply_bouzidi(g, link, links.plane, links.moving != 0, post);
    }
  }
}

// One shard of a mesh (the rings builds, kRings): the block of rows
// [y0, y0 + nyl) and columns [x0, x0 + nxl) of the global nx x ny grid, and
// the rings its neighbours sent, each `depth` cells deep: rb and rt the rows
// below and above the block, (9, depth, nxl + 2 hx), extended across the
// x rings so that they carry the diagonal neighbours' corners (tpulbm's
// ring_rows_ext); rl and rr the columns left and right of it, (9, nyl, hx).
// hx is depth where the mesh cuts x and 0 where the block spans every
// column: there the channel's x wraps inside the block, as on one device.
// In the box y never wraps inside the block: the rows around it come from
// rb and rt, which carry the wrapped neighbours' rows.
// mask is the solid mask of the block and its rings, padded by depth on
// every side (a byte per cell: kSolidBit, and kLinkBit under kBouzidi,
// whose link table the launch reads padded the same way). A launch writes
// the rows [r0, r1) of the block.
//
// The kernels keep working in global coordinates: a window cell at global
// (gx, gy) is stepped where it is a cell of the domain, exactly as on one
// device, so the ghost rule, the walls, the inlet, the outlet and the
// corners act only at the domain's own edges; row() and column() say
// whether the launch reads a cell and where it lies in the block, and
// row_source() (locate() for one cell) points at its populations, in the
// block or in a ring. A cell more than depth + 1 rows from the rows the
// launch writes (a corner rule reads one row further than a pull), or
// beyond the rings, is never loaded: no cell that the launch writes depends
// on it, and a ranged launch whose rows keep depth + 1 rows clear of an
// edge of the block reads no ring there.
// The populations of one row of cells (a grid row, a shard's block row or
// one of its ring rows): population i of column c lies at at(c, s) + i * s.
// Where the row is a block row with x rings, columns c < 0 lie in the left
// ring and c >= split in the right one (left and right not null).
struct RowSource {
  const float* mid;
  const float* left;
  const float* right;
  size_t stride, side_stride;
  int split;

  __device__ __forceinline__ const float* at(int c, size_t& s) const {
    if (left != nullptr) {
      if (c < 0) {
        s = side_stride;
        return left + c;
      }
      if (c >= split) {
        s = side_stride;
        return right + c;
      }
    }
    s = stride;
    return mid + c;
  }
};

struct Shard {
  const float* f;
  const float* rb;
  const float* rt;
  const float* rl;
  const float* rr;
  const uint8_t* mask;
  int nxl, nyl, x0, y0, hx, depth, r0, r1;

  // Population 0 of the cell at block coordinates (lx, ly) that the launch
  // reads, in the block or the ring that holds it; population i lies
  // i * stride floats further.
  __device__ __forceinline__ const float* locate(int lx, int ly,
                                                 size_t& stride) const {
    const size_t wr = static_cast<size_t>(nxl) + 2 * hx;
    if (ly < 0) {
      stride = depth * wr;
      return rb + (depth + ly) * wr + lx + hx;
    }
    if (ly >= nyl) {
      stride = depth * wr;
      return rt + (ly - nyl) * wr + lx + hx;
    }
    if (lx < 0) {
      stride = static_cast<size_t>(nyl) * hx;
      return rl + static_cast<size_t>(ly) * hx + hx + lx;
    }
    if (lx >= nxl) {
      stride = static_cast<size_t>(nyl) * hx;
      return rr + static_cast<size_t>(ly) * hx + lx - nxl;
    }
    stride = static_cast<size_t>(nyl) * nxl;
    return f + static_cast<size_t>(ly) * nxl + lx;
  }

  // The index of the cell at block coordinates (lx, ly) in the mask and
  // in the link table (both padded by depth on every side).
  __device__ __forceinline__ size_t padded(int lx, int ly) const {
    return static_cast<size_t>(ly + depth) * (nxl + 2 * depth) + lx + depth;
  }

  // The mask byte of the cell at block coordinates (lx, ly).
  __device__ __forceinline__ uint8_t mask_byte(int lx, int ly) const {
    return mask[padded(lx, ly)];
  }

  // Whether the launch reads row gy (global), and if so its block row ly;
  // then whether it reads column gx of such a row, and if so its block
  // column lx (gx taken mod nx first where the block spans every column of
  // the channel or the box; in the box y never wraps inside the block).
  __device__ __forceinline__ bool row(int gy, int ny, int& ly) const {
    if (!kPeriodicY && (gy < 0 || gy >= ny)) return false;
    ly = gy - y0;
    return !(ly < r0 - depth - 1 || ly < -depth || ly >= r1 + depth + 1 ||
             ly >= nyl + depth);
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

  // Where the populations of block row ly (one that row() returned) lie,
  // once for the row (locate() for each of its columns).
  __device__ __forceinline__ RowSource row_source(int ly) const {
    const size_t wr = static_cast<size_t>(nxl) + 2 * hx;
    if (ly < 0) return {rb + (depth + ly) * wr + hx, nullptr, nullptr,
                        depth * wr, 0, 0};
    if (ly >= nyl) return {rt + (ly - nyl) * wr + hx, nullptr, nullptr,
                           depth * wr, 0, 0};
    const size_t row = static_cast<size_t>(ly);
    return {f + row * nxl,
            hx > 0 ? rl + row * hx + hx : nullptr,
            hx > 0 ? rr + row * hx - nxl : nullptr,
            static_cast<size_t>(nyl) * nxl, static_cast<size_t>(nyl) * hx,
            nxl};
  }
};

// Whether the library's domain has a clean-corner rule: the obstacle
// domain's inlet and outlet corners. Only its kernels are instantiated
// with kCorners true; every other domain's boundary sequence ignores
// kCorners, so a launcher there takes the kCorners-false kernel whatever
// clean_corners says (the same bits, half the build).
constexpr bool kCornerRule = kDomain == kObstacle && !kSlab;

// Columns the D2Q9 march's strips start left of x = 0: one in the cavity
// when its right corners would sit on a strip's first column, where the
// corner rule's read two columns inward would reach past the columns the
// strip holds (its segments keep two rows for the same reason). Other
// domains' strips start at x = 0 (kColShift false).
constexpr bool kColShift = kDomain == kCavity;
inline int tile_col_shift(int nx, int kBX) {
  return kColShift && nx > 1 && (nx - 1) % kBX == 0 ? 1 : 0;
}

}  // namespace tpulbm
