// The per-cell parts of a D2Q9 timestep that every kernel of the port
// shares, float32: moments and BGK collision, the pull with the reference's
// ghost rule, and the boundary sequence. step_d2q9.cu (one step per launch)
// and step_d2q9_blocked.cu (N steps per launch) both build on these
// functions, so that N launches of the first and one launch of the second
// run the same operations in the same order and give the same bits; the
// thermal kernel (step_thermal.cu) reuses the moments and the relaxation.
//
// Rounding follows the plain version (tpulbm_torch/ops/step_torch.py): the
// expression order below is the reference's, and the libraries are built
// with -fmad=false so no multiply and add are fused into one rounding.

#pragma once

#include <stdint.h>

namespace tpulbm {

constexpr int kQ = 9;

struct StepConsts {
  float inv_tau;         // 1 / tau
  float u_in;            // inlet velocity
  float one_minus_u_in;  // 1 - u_in, rounded once on the host
  float eq_in[kQ];       // frozen ghost equilibrium(rho=1, u=(u_in, 0))
  float w[kQ];           // lattice weights: the rest equilibrium of solids
};

inline StepConsts make_consts(float inv_tau, float u_in, float one_minus_u_in,
                              const float* eq_in, const float* w) {
  StepConsts k;
  k.inv_tau = inv_tau;
  k.u_in = u_in;
  k.one_minus_u_in = one_minus_u_in;
  for (int i = 0; i < kQ; ++i) {
    k.eq_in[i] = eq_in[i];
    k.w[i] = w[i];
  }
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

// BGK relaxation of one cell's 9 populations, in place.
__device__ __forceinline__ void collide_bgk(float* f, const StepConsts& k) {
  relax_bgk(f, moments_d2q9(f), k.inv_tau, k.w);
}

// Pull g_i(x, y) = f_post_i((x, y) - c_i) with the reference's ghost rule:
// a source across a y edge (corners included) gives the frozen equilibrium,
// one across an x edge gives zero, and an in-domain source gives
// post(i, cx, cy), the post-collision value the caller keeps for it.
template <class Post>
__device__ __forceinline__ void pull_d2q9(float* g, int x, int y, int nx,
                                          int ny, const StepConsts& k,
                                          const Post& post) {
  auto pull = [&](int i, int cx, int cy) -> float {
    const int sy = y - cy;
    const int sx = x - cx;
    if (sy < 0 || sy >= ny) return k.eq_in[i];
    if (sx < 0 || sx >= nx) return 0.0f;
    return post(i, cx, cy);
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

// The boundary sequence on one cell's post-stream populations, in place:
// bounce-back walls (bottom, then top) -> Zou-He inlet -> Zou-He outlet, or
// the obstacle pin on a solid cell. Every rule reads only this cell.
__device__ __forceinline__ void apply_boundaries(float* g, bool solid, int x,
                                                 int y, int nx, int ny,
                                                 const StepConsts& k) {
  if (solid) {
    // equilibrium obstacle: solid cells are pinned to rest equilibrium
#pragma unroll
    for (int i = 0; i < kQ; ++i) g[i] = k.w[i];
    return;
  }
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

}  // namespace tpulbm
