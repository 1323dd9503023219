// The collision modes of the port's kernels and the per-cell relaxation
// rates that the D2Q9 (d2q9_common.cuh) and D3Q19 (d3q19_common.cuh)
// collisions share: the Smagorinsky closed form and the power law's
// log-space Newton solve, in the arithmetic of tpulbm's Pallas kernels
// (tpulbm/physics.py::power_law_inv_tau_from_gfac, the closed forms of
// step_pallas.py and step_pallas3d.py).
//
// The collision is fixed when a library is built: -DTPULBM_COLLISION=<mode>
// (ops/step_cuda.py builds one library per mode), BGK when it is unset.

#pragma once

#ifndef TPULBM_COLLISION
#define TPULBM_COLLISION 0
#endif

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
