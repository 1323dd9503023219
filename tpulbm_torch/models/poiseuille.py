"""Poiseuille flow driven by a uniform body force: periodic in x, no-slip
walls in y (2-D channel, D2Q9) or in y and z (3-D rectangular duct,
D3Q19 or, with lattice3d, D3Q27), under any collision tpulbm runs there.

Port of tpulbm/models/poiseuille.py, with its analytic profiles: the
parabola, the power-law channel profile and the duct's Fourier series,
each with the walls at the nodes y = 0, ny-1 (and z = 0, nz-1).
"""
from __future__ import annotations

import numpy as np

from ..config import SimulationParams
from ..lattice import D2Q9, D3Q19, D3Q27
from .base import Problem

# the force when the parameters set none (tpulbm's default)
DEFAULT_FORCE = 1e-5


def make_problem(params: SimulationParams) -> Problem:
    force = tuple(params.body_force) or (DEFAULT_FORCE, 0.0)
    d3 = params.is_3d
    if d3:
        force = force + (0.0,) * (3 - len(force))
    return Problem(
        params=params,
        lattice=((D3Q27 if params.lattice3d == "d3q27" else D3Q19)
                 if d3 else D2Q9),
        solid=None,
        init_rho=1.0,
        init_u=(0.0,) * (3 if d3 else 2),
        walls_y=True,
        walls_z=d3,
        periodic_x=True,
        body_force=force,
        obstacle_bc=params.obstacle_bc,
        collision=params.collision,
        smagorinsky=params.smagorinsky,
        power_law=params.power_law() or (),
        trt_magic=params.trt_magic,
        mrt_rates=params.mrt_rates,
    )


def _force_x(params: SimulationParams) -> float:
    return params.body_force[0] if params.body_force else DEFAULT_FORCE


def analytic_profile(params: SimulationParams) -> np.ndarray:
    """Steady ux(y) of the body-forced channel, no-slip at the wall nodes
    (channel width ny-1): u(y) = F/(2 nu) y (ny-1 - y)."""
    ny = params.ny
    y = np.arange(ny, dtype=np.float64)
    return _force_x(params) / (2.0 * params.nu()) * y * (ny - 1 - y)


def analytic_profile_power_law(params: SimulationParams) -> np.ndarray:
    """Steady ux(y) of the power-law channel, nu = k γ̇^(n-1), half-width
    h = (ny-1)/2 and s = |y - h|:

        u(s) = n/(n+1) (F/k)^(1/n) (h^(1+1/n) - s^(1+1/n));

    n = 1 is the parabola."""
    plaw = params.power_law()
    k, n = plaw if plaw else (params.nu(), 1.0)
    h = (params.ny - 1) / 2.0
    s = np.abs(np.arange(params.ny, dtype=np.float64) - h)
    e = 1.0 + 1.0 / n
    return n / (n + 1.0) * (_force_x(params) / k) ** (1.0 / n) \
        * (h ** e - s ** e)


def analytic_profile_duct(params: SimulationParams) -> np.ndarray:
    """Steady ux(z, y) of the body-forced rectangular duct (White, Viscous
    Fluid Flow, eq. 3.48), no-slip at the wall nodes, a = (ny-1)/2,
    b = (nz-1)/2, centred coordinates:

        u = 16 a² F / (nu π³) Σ_{n odd} (−1)^((n−1)/2) / n³
            · [1 − cosh(nπẑ/(2a)) / cosh(nπb/(2a))] · cos(nπŷ/(2a)).

    Returns (nz, ny)."""
    ny, nz = params.ny, params.nz
    a = (ny - 1) / 2.0
    b = (nz - 1) / 2.0
    yh = np.arange(ny, dtype=np.float64) - a
    zh = np.arange(nz, dtype=np.float64) - b
    u = np.zeros((nz, ny))
    for n in range(1, 100, 2):
        k = n * np.pi / (2.0 * a)
        sign = -1.0 if (n - 1) // 2 % 2 else 1.0
        term_z = 1.0 - np.cosh(k * zh) / np.cosh(k * b)
        term_y = np.cos(k * yh)
        u += sign / n ** 3 * term_z[:, None] * term_y[None, :]
    return 16.0 * a * a * _force_x(params) / (params.nu() * np.pi ** 3) * u
