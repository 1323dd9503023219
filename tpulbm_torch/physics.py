"""Pointwise physics on tensors: moments, equilibrium, BGK collision.

Port of tpulbm/physics.py (the BGK subset, the thermal scalar's
equilibrium and the Shan-Chen pieces). `f` is (Q, *spatial) in SoA
layout, x minor. Every expression keeps tpulbm's operation order so the
f64 results agree to round-off.

The moment and c·u sums are explicit ±plane adds, never einsum or matmul:
the velocity components are 0/±1, so the adds are exact, and a float32
matmul on a GPU may run in TF32 (about three decimal digits).

The host-side equilibria (rest_equilibrium, uniform_equilibrium) are NumPy,
as in tpulbm; they set the initial state and the frozen ghost values.
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


def collide(lat: Lattice, f: torch.Tensor, inv_tau: float) -> torch.Tensor:
    """BGK relaxation: f_post = f - (1/tau) (f - f_eq)."""
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    return f - inv_tau * (f - feq)


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
