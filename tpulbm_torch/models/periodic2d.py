"""Fully periodic 2-D boxes: the decaying Taylor-Green vortex, Minion and
Brown's double shear layer, forced Kolmogorov flow and the passive scalar.

Port of tpulbm/models/periodic2d.py, the 2-D branch. Each starts from the
equilibrium at an analytic (rho, u) field (Problem.init_fields) and runs
with periodic x and y and no walls: the kernels' box domain wraps both
axes. Kolmogorov's force F_x(y) = F0·cos(κy), κ = 2π·n/ny, is a
ForceProfile along y, evaluated per coordinate (no stored field). The
passive scalar is the D2Q5 thermal scalar with buoyancy 0 and no y walls,
stirred by a decaying Taylor-Green flow (inlet_velocity > 0) or at rest.
The 3-D boxes (nz > 0) raise NotImplementedError naming ROADMAP Queue 1
item 16; the other problems are 2-D only, as in tpulbm.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SimulationParams
from ..lattice import D2Q5, D2Q9
from .base import ForceProfile, Problem, ThermalConfig


def _grids(params: SimulationParams):
    x = np.arange(params.nx, dtype=np.float64)
    y = np.arange(params.ny, dtype=np.float64)
    return np.meshgrid(x, y)            # X, Y each (ny, nx)


def taylor_green_fields(params: SimulationParams, t: float = 0.0):
    """Analytic (rho, u) of the decaying Taylor-Green vortex at time t
    (lattice units), one full period per box axis."""
    nx, ny = params.nx, params.ny
    u0 = params.inlet_velocity or 0.04
    kx = 2.0 * np.pi / nx
    ky = 2.0 * np.pi / ny
    nu = params.nu()
    damp = np.exp(-nu * (kx * kx + ky * ky) * t)
    X, Y = _grids(params)
    ux = -u0 * np.sqrt(ky / kx) * np.cos(kx * X) * np.sin(ky * Y) * damp
    uy = u0 * np.sqrt(kx / ky) * np.sin(kx * X) * np.cos(ky * Y) * damp
    # the consistent pressure
    p = -0.25 * u0 * u0 * ((ky / kx) * np.cos(2 * kx * X)
                           + (kx / ky) * np.cos(2 * ky * Y)) * damp * damp
    rho = 1.0 + 3.0 * p                  # cs² = 1/3
    return rho, np.stack([ux, uy])


def shear_layer_fields(params: SimulationParams, k: float = 80.0,
                       delta: float = 0.05):
    """Minion & Brown (1997) thin double shear layer: two tanh layers at
    y = L/4 and 3L/4 with a sinusoidal transverse perturbation."""
    u0 = params.inlet_velocity or 0.04
    X, Y = _grids(params)
    xr, yr = X / params.nx, Y / params.ny
    ux = np.where(yr <= 0.5, u0 * np.tanh(k * (yr - 0.25)),
                  u0 * np.tanh(k * (0.75 - yr)))
    uy = delta * u0 * np.sin(2.0 * np.pi * (xr + 0.25))
    return np.ones((params.ny, params.nx)), np.stack([ux, uy])


def kolmogorov_kappa(params: SimulationParams) -> float:
    """Forcing wavenumber κ = 2π·n/ny (lattice units)."""
    return 2.0 * np.pi * params.kolmogorov_n / params.ny


def kolmogorov_f0(params: SimulationParams) -> float:
    """Forcing amplitude F0 = u0·ν·κ²: the laminar fixed point
    u_x(y) = F0/(ν κ²)·cos(κ y) peaks at u0 = inlet_velocity."""
    u0 = params.inlet_velocity or 0.04
    kappa = kolmogorov_kappa(params)
    return u0 * params.nu() * kappa * kappa


def kolmogorov_force(params: SimulationParams) -> ForceProfile:
    """Kolmogorov's F(y) = (F0·cos(κy), 0) as a profile along y."""
    kappa = kolmogorov_kappa(params)
    f0 = kolmogorov_f0(params)
    return ForceProfile("y", lambda y: (f0 * torch.cos(kappa * y), 0.0))


def kolmogorov_fields(params: SimulationParams, perturb: float = 0.01):
    """Initial (rho, u): the laminar profile plus a small deterministic
    transverse seed."""
    u0 = params.inlet_velocity or 0.04
    kappa = kolmogorov_kappa(params)
    X, Y = _grids(params)
    ux = u0 * np.cos(kappa * Y)
    uy = perturb * u0 * np.sin(2.0 * np.pi * X / params.nx)
    return np.ones((params.ny, params.nx)), np.stack([ux, uy])


def passive_scalar_T0(params: SimulationParams):
    """Initial scalar: one sinusoidal stripe along x,
    T = t_ref + ½ΔT·sin(2πx/nx)."""
    t_ref = 0.5 * (params.t_hot + params.t_cold)
    amp = 0.5 * (params.t_hot - params.t_cold)
    x = np.arange(params.nx, dtype=np.float64)[None, :]
    return (t_ref + amp * np.sin(2.0 * np.pi * x / params.nx)
            ) * np.ones((params.ny, 1))


PROBLEMS = ("taylor-green", "shear-layer", "kolmogorov", "passive-scalar")


def check_2d(params: SimulationParams) -> None:
    """Raise for nz > 0: NotImplementedError naming ROADMAP item 16 for
    the 3-D Taylor-Green and Kolmogorov boxes, tpulbm's ValueError for the
    problems it runs in 2-D only."""
    if not params.is_3d:
        return
    if params.problem not in ("taylor-green", "kolmogorov"):
        raise ValueError(f"{params.problem} is 2-D only")
    raise NotImplementedError(
        f"the 3-D periodic box (problem={params.problem!r}, nz > 0) is not "
        "ported to tpulbm_torch yet (ROADMAP Queue 1 item 16, 3-D)")


def make_problem(params: SimulationParams) -> Problem:
    check_2d(params)
    force = None
    thermal = init_T = None
    if params.problem == "taylor-green":
        fields = taylor_green_fields(params)
    elif params.problem == "kolmogorov":
        fields = kolmogorov_fields(params)
        force = kolmogorov_force(params)
    elif params.problem == "passive-scalar":
        if params.thermal_tau <= 0.5:
            raise ValueError(
                f"passive-scalar needs thermal_tau > 0.5 (diffusivity "
                f"alpha = (thermal_tau - 1/2)/3 > 0), got "
                f"{params.thermal_tau}")
        fields = (taylor_green_fields(params) if params.inlet_velocity
                  else (np.ones((params.ny, params.nx)),
                        np.zeros((2, params.ny, params.nx))))
        init_T = passive_scalar_T0(params)
        thermal = ThermalConfig(lattice=D2Q5, tau_g=params.thermal_tau,
                                t_bottom=params.t_hot, t_top=params.t_cold,
                                buoyancy=0.0, perturb=0.0)
    else:
        fields = shear_layer_fields(params)
    return Problem(
        params=params,
        lattice=D2Q9,
        solid=None,
        init_rho=1.0,
        init_u=(0.0, 0.0),
        walls_y=False,
        periodic_x=True,
        periodic_y=True,
        body_force=tuple(params.body_force),
        force_profile=force,
        obstacle_bc=params.obstacle_bc,
        collision=params.collision,
        smagorinsky=params.smagorinsky,
        power_law=params.power_law() or (),
        trt_magic=params.trt_magic,
        mrt_rates=params.mrt_rates,
        init_fields=fields,
        thermal=thermal,
        init_T=init_T,
    )
