"""Pointwise physics on tensors: moments, equilibrium and the collisions.

Port of tpulbm/physics.py: BGK, TRT, MRT (rank-r form), regularized BGK,
KBC, the Smagorinsky closure and power-law rheology, the thermal scalar's
equilibrium and the Shan-Chen pieces. `f` is (Q, *spatial) in SoA layout,
x minor. Every expression keeps tpulbm's operation order so the f64
results agree to round-off.

The moment, projector and c·u sums are explicit sums over the planes,
never tensordot, einsum or matmul: the velocity components are 0/±1, so
most adds are exact, and a float32 matmul on a GPU may run in TF32 (about
three decimal digits), the trap tpulbm met as bfloat16 passes on a TPU.

The host-side parts (the equilibria that set the initial state and the
frozen ghost values, the MRT basis and its rank-r correction, the KBC
coefficient vectors) are NumPy, copied from tpulbm line for line so that
their arrays equal tpulbm's bit for bit. A uniform body force F enters
every collision as tpulbm's does: the source 3 w_i (c_i·F), computed on
the host in double precision, is added after the relaxation.
"""
from __future__ import annotations

import numpy as np
import torch

from .lattice import Lattice


def moments(lat: Lattice,
            f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """rho = Σ_i f_i and u = Σ_i c_i f_i / rho.
    Returns (rho (*spatial,), u (D, *spatial))."""
    rho = torch.sum(f, dim=0)
    c = lat.c
    comps = []
    for d in range(lat.D):
        acc = None
        for i in range(lat.Q):
            cid = int(c[i, d])
            if cid == 0:
                continue
            term = f[i] if cid > 0 else -f[i]
            acc = term if acc is None else acc + term
        comps.append(acc)
    return rho, torch.stack(comps) / rho


def equilibrium(lat: Lattice, rho: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """f_eq_i = w_i rho (1 + 3 c_i·u + 4.5 (c_i·u)^2 - 1.5 u·u)."""
    c = lat.c
    usq = torch.sum(u * u, dim=0)
    base = 1.0 - 1.5 * usq
    planes = []
    for i in range(lat.Q):
        cu = None
        for d in range(lat.D):
            cid = int(c[i, d])
            if cid == 0:
                continue
            term = u[d] if cid > 0 else -u[d]
            cu = term if cu is None else cu + term
        w = float(lat.w[i])
        if cu is None:
            planes.append(w * rho * base)
        else:
            planes.append(w * rho * (base + 3.0 * cu + 4.5 * cu * cu))
    return torch.stack(planes)


def force_source(lat: Lattice, force: tuple[float, ...]) -> np.ndarray:
    """(Q,) float64 source S_i = 3 w_i (c_i·F) of a uniform body force F:
    added after the relaxation it injects exactly the momentum F a step
    (Σ_i c_i S_i = F)."""
    c = lat.c.astype(np.float64)
    return np.asarray(3.0 * lat.w * (c @ np.asarray(force, np.float64)))


def _add_source(lat: Lattice, f_post: torch.Tensor,
                force: tuple[float, ...]) -> torch.Tensor:
    """f_post plus the body-force source, rounded to f_post's dtype; f_post
    itself without a force."""
    if not force:
        return f_post
    src = torch.as_tensor(force_source(lat, force), dtype=f_post.dtype,
                          device=f_post.device)
    return f_post + src.reshape((lat.Q,) + (1,) * (f_post.dim() - 1))


def equilibrium_with_force(lat: Lattice, rho: torch.Tensor, u: torch.Tensor,
                           force: tuple[float, ...]) -> torch.Tensor:
    """Equilibrium plus 3 w_i (c_i·F), the forced equilibrium of tpulbm's
    physics.py (the reference's literal formula; the collisions add the
    source after relaxing instead)."""
    return _add_source(lat, equilibrium(lat, rho, u), force)


def collide(lat: Lattice, f: torch.Tensor, inv_tau: float,
            force: tuple[float, ...] = ()) -> torch.Tensor:
    """BGK relaxation: f_post = f - (1/tau) (f - f_eq), plus the source of
    a body force."""
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    return _add_source(lat, f - inv_tau * (f - feq), force)


def _plane_sum(coeffs, planes):
    """Σ_j coeffs[j]·planes[j] in j order, skipping zero coefficients and
    multiplying by ±1 as an exact sign; None when every coefficient is 0."""
    acc = None
    for cj, plane in zip(coeffs, planes):
        cj = float(cj)
        if cj == 0.0:
            continue
        term = plane if cj == 1.0 else -plane if cj == -1.0 else cj * plane
        acc = term if acc is None else acc + term
    return acc


def omega_minus_trt(inv_tau: float, magic: float = 3.0 / 16.0) -> float:
    """Odd-moment relaxation rate for TRT from the viscosity rate 1/tau and
    the magic parameter Λ = (1/ω+ − ½)(1/ω− − ½); Λ = 3/16 puts
    bounce-back walls halfway along the links."""
    lam_plus = 1.0 / inv_tau - 0.5
    lam_minus = magic / lam_plus
    return 1.0 / (lam_minus + 0.5)


def collide_trt(lat: Lattice, f: torch.Tensor, inv_tau: float,
                force: tuple[float, ...] = (),
                magic: float = 3.0 / 16.0) -> torch.Tensor:
    """Two-relaxation-time collision: even parts relax at 1/tau, odd parts
    at ω⁻ from the magic parameter,

        f_post = f − ω⁺ (f⁺ − feq⁺) − ω⁻ (f⁻ − feq⁻),
        g±_i = (g_i ± g_opp(i)) / 2.

    At tau → 1/2 with the Zou-He inlet and outlet it needs the clean
    corners (Problem.clean_corners), as in tpulbm."""
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    opp = torch.as_tensor(lat.opposite, dtype=torch.int64, device=f.device)
    f_o = f[opp]
    feq_o = feq[opp]
    half_p = 0.5 * inv_tau
    half_m = 0.5 * omega_minus_trt(inv_tau, magic)
    return _add_source(lat, (f
                             - half_p * ((f + f_o) - (feq + feq_o))
                             - half_m * ((f - f_o) - (feq - feq_o))), force)


def collide_regularized(lat: Lattice, f: torch.Tensor, inv_tau: float,
                        force: tuple[float, ...] = ()) -> torch.Tensor:
    """Regularized BGK (Latt & Chopard 2006): the non-equilibrium part is
    projected onto its second-order Hermite shell before relaxing,

        Π^neq_αβ = Σ_i c_iα c_iβ (f_i − feq_i)
        fneq_reg_i = (9/2) w_i Q_iαβ Π^neq_αβ,  Q_i = c_i c_i − I/3
        f_post = feq + (1 − 1/τ) fneq_reg."""
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    fneq = f - feq
    c = lat.c.astype(np.float64)
    D = lat.D
    # Σ_αβ Q_iαβ Π_αβ = Σ_α (c_iα² − 1/3) Π_αα + 2 Σ_{α<β} c_iα c_iβ Π_αβ
    proj = 0.0
    pairs = [(a, a) for a in range(D)] + [(a, b) for a in range(D)
                                          for b in range(a + 1, D)]
    wshape = (lat.Q,) + (1,) * rho.dim()
    for a, b in pairs:
        cab = c[:, a] * c[:, b]
        pi_ab = _plane_sum(cab, fneq)
        coeff = cab - (1.0 / 3.0 if a == b else 0.0)
        if a != b:
            coeff = 2.0 * coeff
        wq = torch.as_tensor(4.5 * lat.w * coeff, dtype=f.dtype,
                             device=f.device).reshape(wshape)
        proj = proj + wq * pi_ab[None]
    return _add_source(lat, feq + (1.0 - inv_tau) * proj, force)


def kbc_projectors(lat: Lattice) -> tuple[np.ndarray, np.ndarray]:
    """(S, H) population-space projectors of the D2Q9 KBC operator (Bösch,
    Chikatamarla & Karlin 2015): S onto the shear moments {Π_xy, N = Π_xx
    − Π_yy}, H onto the higher ones {T = Π_xx + Π_yy, q_xyy, q_yxx,
    A_xxyy}; S + H is the identity on the non-conserved subspace."""
    if lat.D != 2 or lat.Q != 9:
        raise ValueError("the KBC operator is implemented for D2Q9")
    c = lat.c.astype(np.float64)
    mons = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2),
            (1, 2), (2, 1), (2, 2)]
    M = np.stack([c[:, 0] ** p * c[:, 1] ** q for p, q in mons])  # (9, Q)
    Minv = np.linalg.inv(M)
    Ps = np.zeros((9, 9))
    Ps[3, 3] = 1.0                      # Π_xy
    # N-part of the (Π_xx, Π_yy) subspace: (Δxx − Δyy)/2 · (±1)
    Ps[4, 4] = Ps[5, 5] = 0.5
    Ps[4, 5] = Ps[5, 4] = -0.5
    Ph = np.zeros((9, 9))
    for k in (6, 7, 8):                 # q_xyy, q_yxx, A_xxyy
        Ph[k, k] = 1.0
    # T-part (trace) of the (Π_xx, Π_yy) subspace
    Ph[4, 4] = Ph[5, 5] = Ph[4, 4] + 0.5
    Ph[4, 5] = Ph[5, 4] = 0.5
    S = Minv @ Ps @ M
    H = Minv @ Ph @ M
    return S, H


def kbc_coeffs(lat: Lattice):
    """Per-population coefficient vectors of the KBC deviation parts (the
    kernels' unrolled form of kbc_projectors):

        Δs_i = sP_i·ΔΠ_xy + sN_i·ΔN
        Δh_i = hT_i·ΔT + hqx_i·Δq_xyy + hqy_i·Δq_yxx + hA_i·ΔA_xxyy"""
    if lat.D != 2 or lat.Q != 9:
        raise ValueError("the KBC operator is implemented for D2Q9")
    c = lat.c.astype(np.float64)
    mons = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2),
            (1, 2), (2, 1), (2, 2)]
    M = np.stack([c[:, 0] ** p * c[:, 1] ** q for p, q in mons])
    Minv = np.linalg.inv(M)
    return (Minv[:, 3], 0.5 * (Minv[:, 4] - Minv[:, 5]),
            0.5 * (Minv[:, 4] + Minv[:, 5]),
            Minv[:, 6], Minv[:, 7], Minv[:, 8])


def collide_kbc(lat: Lattice, f: torch.Tensor, inv_tau: float,
                force: tuple[float, ...] = ()) -> torch.Tensor:
    """KBC entropic multi-relaxation collision (D2Q9):

        f' = f − 2β·Δs − β·γ·Δh,   β = 1/(2τ),
        γ = 1/β − (2 − 1/β) · ⟨Δs|Δh⟩ / (⟨Δh|Δh⟩ + λ),
        ⟨x|y⟩ = Σ_i x_i y_i / feq_i.

    λ is tpulbm's Tikhonov floor (1e-10 in f32, 1e-20 in f64): without it
    the ratio amplifies rounding noise whenever Δh is noise and Δs is not.
    The projector contractions are sums over the planes."""
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    dneq = f - feq
    S, H = kbc_projectors(lat)
    zero = torch.zeros_like(rho)       # rows of S or H that are all zero

    def contract(P, i):
        acc = _plane_sum(P[i], dneq)
        return zero if acc is None else acc

    ds = torch.stack([contract(S, i) for i in range(lat.Q)])
    dh = torch.stack([contract(H, i) for i in range(lat.Q)])
    inv_feq = 1.0 / feq
    sh = torch.sum(ds * dh * inv_feq, dim=0)
    hh = torch.sum(dh * dh * inv_feq, dim=0)
    beta = 0.5 * inv_tau
    lam = 1e-20 if f.dtype == torch.float64 else 1e-10
    gamma = 1.0 / beta - (2.0 - 1.0 / beta) * sh / (hh + lam)
    return _add_source(lat, f - (2.0 * beta) * ds - (beta * gamma)[None] * dh,
                       force)


def _mrt_basis(lat: Lattice) -> tuple[np.ndarray, tuple[str, ...]]:
    """Moment matrix M (Q, Q) and per-row moment names of the MRT operator:
    Lallemand & Luo (2000) for D2Q9, d'Humieres et al. (2002) for D3Q19.
    The rows are mutually orthogonal (asserted)."""
    c = lat.c.astype(np.float64)                     # (Q, D)
    cx, cy = c[:, 0], c[:, 1]
    if lat.D == 2:
        c2 = cx * cx + cy * cy
        rows = [
            ("rho", np.ones(lat.Q)),
            ("e", -4.0 + 3.0 * c2),
            ("eps", 4.0 - 10.5 * c2 + 4.5 * c2 * c2),
            ("jx", cx),
            ("qx", (-5.0 + 3.0 * c2) * cx),
            ("jy", cy),
            ("qy", (-5.0 + 3.0 * c2) * cy),
            ("pxx", cx * cx - cy * cy),
            ("pxy", cx * cy),
        ]
    elif lat.D == 3:
        cz = c[:, 2]
        c2 = cx * cx + cy * cy + cz * cz
        rows = [
            ("rho", np.ones(lat.Q)),
            ("e", 19.0 * c2 - 30.0),
            ("eps", (21.0 * c2 * c2 - 53.0 * c2 + 24.0) / 2.0),
            ("jx", cx),
            ("qx", (5.0 * c2 - 9.0) * cx),
            ("jy", cy),
            ("qy", (5.0 * c2 - 9.0) * cy),
            ("jz", cz),
            ("qz", (5.0 * c2 - 9.0) * cz),
            ("pxx", 3.0 * cx * cx - c2),
            ("pixx", (3.0 * c2 - 5.0) * (3.0 * cx * cx - c2)),
            ("pww", cy * cy - cz * cz),
            ("piww", (3.0 * c2 - 5.0) * (cy * cy - cz * cz)),
            ("pxy", cx * cy),
            ("pyz", cy * cz),
            ("pxz", cx * cz),
            ("mx", (cy * cy - cz * cz) * cx),
            ("my", (cz * cz - cx * cx) * cy),
            ("mz", (cx * cx - cy * cy) * cz),
        ]
    else:
        raise ValueError(f"no MRT basis for D={lat.D}")
    names = tuple(n for n, _ in rows)
    M = np.stack([r for _, r in rows])
    gram = M @ M.T
    assert np.allclose(gram, np.diag(np.diag(gram))), \
        "MRT basis rows must be orthogonal"
    return M, names


# Ghost-moment relaxation rates (tpulbm physics.py:401-430). Conserved
# moments get rate 0, shear stresses 1/tau (the viscosity, as in BGK), the
# rest are tuned for stability; None means 1/tau. D2Q9's q rates are 1/tau
# because the Zou-He corner chain re-injects non-equilibrium every step and
# a fixed q rate far from 1/tau amplifies it; near tau = 1/2 the e rate
# joins that loop, so runs there take --mrt-rates 'e=1.857'.
_MRT_GHOST_RATES = {
    2: {"e": 1.64, "eps": 1.54, "qx": None, "qy": None},
    3: {"e": 1.19, "eps": 1.4, "qx": 1.2, "qy": 1.2, "qz": 1.2,
        "pixx": 1.4, "piww": 1.4, "mx": 1.98, "my": 1.98, "mz": 1.98},
}
_MRT_SHEAR = {2: ("pxx", "pxy"),
              3: ("pxx", "pww", "pxy", "pyz", "pxz")}
_MRT_CONSERVED = ("rho", "jx", "jy", "jz")


def mrt_rates(lat: Lattice, inv_tau: float,
              overrides: dict[str, float] | None = None) -> np.ndarray:
    """(Q,) relaxation rate per moment row of _mrt_basis(lat)."""
    _, names = _mrt_basis(lat)
    ghost = dict(_MRT_GHOST_RATES[lat.D])
    if overrides:
        unknown = set(overrides) - set(names)
        if unknown:
            raise ValueError(f"unknown MRT moments {sorted(unknown)}; "
                             f"rows are {names}")
        ghost.update(overrides)
    out = []
    for n in names:
        if n in _MRT_CONSERVED:
            out.append(0.0)
        elif n in _MRT_SHEAR[lat.D]:
            out.append(inv_tau)
        else:
            v = ghost[n]
            out.append(inv_tau if v is None else float(v))
    return np.asarray(out, np.float64)


def mrt_relax_matrix(lat: Lattice, inv_tau: float,
                     overrides: dict[str, float] | None = None) -> np.ndarray:
    """R = M⁻¹ S M (Q, Q float64), f_post = f − R (f − feq); entries below
    1e-13 are zeroed (inversion noise and structural zeros)."""
    M, _ = _mrt_basis(lat)
    S = np.diag(mrt_rates(lat, inv_tau, overrides))
    R = np.linalg.inv(M) @ S @ M
    R[np.abs(R) < 1e-13] = 0.0
    return R


def mrt_rank_correction(lat: Lattice, inv_tau: float,
                        overrides: dict[str, float] | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Low-rank form of the MRT operator, what the kernels evaluate:

        R = s_nu·I + Σ_k (s_k − s_nu) · u_k v_kᵀ
          with u_k = (M⁻¹) column k, v_k = M row k,

    over the non-conserved moments whose rate differs from s_nu = 1/tau.
    Returns (U (Q, r), V (r, Q)) float64; r = 2 for D2Q9's defaults, 0
    when MRT degenerates to BGK."""
    M, names = _mrt_basis(lat)
    rates = mrt_rates(lat, inv_tau, overrides)
    Minv = np.linalg.inv(M)
    keep = [k for k, n in enumerate(names)
            if n not in _MRT_CONSERVED and rates[k] != inv_tau]
    U = np.stack([(rates[k] - inv_tau) * Minv[:, k] for k in keep], axis=1) \
        if keep else np.zeros((lat.Q, 0))
    V = M[keep] if keep else np.zeros((0, lat.Q))
    U[np.abs(U) < 1e-15] = 0.0
    return U, V


def collide_mrt(lat: Lattice, f: torch.Tensor, inv_tau: float,
                force: tuple[float, ...] = (),
                overrides: dict[str, float] | None = None) -> torch.Tensor:
    """Multiple-relaxation-time collision, f_post = f − R (f − feq) with
    R = mrt_relax_matrix: shear stresses relax at 1/tau (BGK's viscosity),
    conserved moments not at all, ghost moments at their own rates. The
    per-plane loop skips R's zeros, as tpulbm's does."""
    R = mrt_relax_matrix(lat, inv_tau, overrides)
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    d = f - feq
    planes = []
    for i in range(lat.Q):
        acc = None
        for j in range(lat.Q):
            rij = float(R[i, j])
            if rij == 0.0:
                continue
            term = rij * d[j]
            acc = term if acc is None else acc + term
        planes.append(f[i] if acc is None else f[i] - acc)
    return _add_source(lat, torch.stack(planes), force)


def _stress_norm_sq(lat: Lattice, devs):
    """Σ_ab w_ab Π_ab², Π_ab = Σ_i c_ia c_ib devs_i, off-diagonal pairs
    counted twice, accumulated over (a, b) = (0, 0), (0, 1), ... as
    tpulbm's smagorinsky_inv_tau and power_law_inv_tau accumulate it."""
    c = lat.c
    ssum = None
    for a in range(lat.D):
        for b in range(a, lat.D):
            acc = _plane_sum([int(c[i, a]) * int(c[i, b])
                              for i in range(lat.Q)], devs)
            w = 1.0 if a == b else 2.0
            term = w * (acc * acc)
            ssum = term if ssum is None else ssum + term
    return ssum


def smagorinsky_inv_tau(lat: Lattice, inv_rho: torch.Tensor, devs,
                        inv_tau0: float, cs: float) -> torch.Tensor:
    """Per-cell 1/tau_eff of the Smagorinsky closure (Hou, Sterling, Chen &
    Doolen 1996), from the non-equilibrium stress Q̄ = sqrt(2 Σ_ab Π_ab²):

        tau_eff = (tau0 + sqrt(tau0² + 18 Cs² Q̄ / rho)) / 2.

    devs: the Q (f_i − feq_i) planes."""
    qbar = torch.sqrt(2.0 * _stress_norm_sq(lat, devs))
    tau0 = 1.0 / inv_tau0
    return 2.0 / (tau0 + torch.sqrt(tau0 * tau0
                                    + (18.0 * cs * cs) * qbar * inv_rho))


# Truncated power-law bounds (Gabbanelli, Drazer & Koplik 2005): tau is
# clamped to [PLAW_TAU_MIN, PLAW_TAU_MAX].
PLAW_TAU_MIN = 0.5005
PLAW_TAU_MAX = 20.0
PLAW_ITERS = 8
PLAW_GAMMA_FLOOR = 1e-12


def power_law_inv_tau_from_gfac(gfac: torch.Tensor, k: float,
                                n: float) -> torch.Tensor:
    """Per-cell 1/tau_eff from gfac = γ̇·tau = 3 Q̄ / (2 rho): PLAW_ITERS
    Newton iterations on λ = log(tau − 1/2) of

        R(λ) = λ + (n−1)·log tau − log(3k) − (n−1)·log gfac,
        R'(λ) = 1 + (n−1)(tau − 1/2)/tau,

    from λ = 0, each iterate clamped to [log(TAU_MIN − 1/2),
    log(TAU_MAX − 1/2)]; gfac is floored at PLAW_GAMMA_FLOOR."""
    nm1 = float(n) - 1.0
    lam_lo = float(np.log(PLAW_TAU_MIN - 0.5))
    lam_hi = float(np.log(PLAW_TAU_MAX - 0.5))
    gl = torch.log(torch.clamp(gfac, min=PLAW_GAMMA_FLOOR))
    const = float(np.log(3.0 * k))
    lam = torch.zeros_like(gfac)
    for _ in range(PLAW_ITERS):
        tau = 0.5 + torch.exp(lam)
        r = lam + nm1 * torch.log(tau) - const - nm1 * gl
        rp = 1.0 + nm1 * (tau - 0.5) / tau
        lam = torch.clamp(lam - r / rp, lam_lo, lam_hi)
    return 1.0 / (0.5 + torch.exp(lam))


def power_law_inv_tau(lat: Lattice, inv_rho: torch.Tensor, devs,
                      k: float, n: float) -> torch.Tensor:
    """Per-cell 1/tau_eff of an Ostwald-de Waele fluid, nu = k γ̇^(n-1),
    with γ̇·tau = 3 Q̄ / (2 rho) from the same stress norm as the
    Smagorinsky closure. devs: the Q (f_i − feq_i) planes."""
    qbar = torch.sqrt(2.0 * _stress_norm_sq(lat, devs))
    gfac = 1.5 * qbar * inv_rho
    return power_law_inv_tau_from_gfac(gfac, k, n)


def collide_power_law(lat: Lattice, f: torch.Tensor, k: float, n: float,
                      force: tuple[float, ...] = ()) -> torch.Tensor:
    """BGK with the per-cell power-law rate of power_law_inv_tau."""
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    devs = f - feq
    inv_t = power_law_inv_tau(lat, 1.0 / rho, devs, k, n)
    return _add_source(lat, f - inv_t[None] * devs, force)


def collide_smagorinsky(lat: Lattice, f: torch.Tensor, inv_tau: float,
                        cs: float,
                        force: tuple[float, ...] = ()) -> torch.Tensor:
    """BGK with the per-cell rate of smagorinsky_inv_tau; Cs = 0 (or zero
    shear) is BGK."""
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    devs = f - feq
    inv_t = smagorinsky_inv_tau(lat, 1.0 / rho, devs, inv_tau, cs)
    return _add_source(lat, f - inv_t[None] * devs, force)


def thermal_equilibrium(lat_g: Lattice, T: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """Advection-diffusion equilibrium of the scalar carried by the flow:
    g_eq_i = w_i T (1 + 3 c_i·u), linear in u (tpulbm physics.py:740-761).
    c·u as exact ±adds, as in equilibrium()."""
    c = lat_g.c
    planes = []
    for i in range(lat_g.Q):
        cu = None
        for d in range(lat_g.D):
            cid = int(c[i, d])
            if cid == 0:
                continue
            term = u[d] if cid > 0 else -u[d]
            cu = term if cu is None else cu + term
        w = float(lat_g.w[i])
        if cu is None:
            planes.append(w * T)
        else:
            planes.append(w * T * (1.0 + 3.0 * cu))
    return torch.stack(planes)


def shan_chen_psi(rho: torch.Tensor, rho0: float = 1.0) -> torch.Tensor:
    """Shan-Chen pseudopotential ψ(ρ) = ρ0 (1 − e^(−ρ/ρ0)) (tpulbm
    physics.py:710-715), bounded, so the interaction saturates in the
    liquid."""
    return rho0 * (1.0 - torch.exp(-rho / rho0))


def shan_chen_pressure(rho: torch.Tensor, g: float,
                       rho0: float = 1.0) -> torch.Tensor:
    """Bulk equation of state P = ρ cs² + (g cs²/2) ψ(ρ)² of the
    pseudopotential fluid (cs² = 1/3): what the Laplace-law gate evaluates
    inside and outside a droplet."""
    psi = shan_chen_psi(rho, rho0)
    return rho / 3.0 + (g / 6.0) * psi * psi


def collide_shan_chen(lat: Lattice, f: torch.Tensor, inv_tau: float,
                      F: torch.Tensor) -> torch.Tensor:
    """BGK with the Shan-Chen velocity-shift forcing: relax toward
    equilibrium(ρ, u + τ F / ρ). F: (D, *spatial), from the step's ψ
    neighbour sums."""
    rho, u = moments(lat, f)
    u_eq = u + (1.0 / inv_tau) * F / rho
    feq = equilibrium(lat, rho, u_eq)
    return f - inv_tau * (f - feq)


def rest_equilibrium(lat: Lattice, dtype=np.float64) -> np.ndarray:
    """Equilibrium at (rho=1, u=0): the weights, which solid cells hold."""
    return lat.w.astype(dtype)


def uniform_equilibrium(lat: Lattice, rho: float, u: tuple[float, ...],
                        dtype=np.float64) -> np.ndarray:
    """(Q,) equilibrium of a uniform (rho, u), computed on the host: the
    initial state and the frozen ghost values at the domain edges."""
    c = lat.c.astype(np.float64)
    uv = np.asarray(u, dtype=np.float64)
    cu = c @ uv
    usq = float(uv @ uv)
    feq = lat.w * rho * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
    return feq.astype(dtype)


def is_stable(f: torch.Tensor, bound: float = 1e5) -> torch.Tensor:
    """All populations finite and |f| < bound (a bool scalar tensor)."""
    return torch.all(torch.isfinite(f) & (torch.abs(f) < bound))


def max_velocity(lat: Lattice, f: torch.Tensor,
                 solid: torch.Tensor | None = None) -> torch.Tensor:
    """max |u| over the domain; solid cells report u = 0."""
    _, u = moments(lat, f)
    vel2 = torch.sum(u * u, dim=0)
    if solid is not None:
        vel2 = torch.where(solid, 0.0, vel2)
    return torch.sqrt(torch.max(vel2))
