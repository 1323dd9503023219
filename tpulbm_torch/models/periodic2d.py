"""Fully periodic boxes: the decaying Taylor-Green vortex, Minion and
Brown's double shear layer, forced Kolmogorov flow and the passive scalar
in 2-D; the 3-D Taylor-Green vortex and 3-D Kolmogorov flow (nz > 0).

Port of tpulbm/models/periodic2d.py. Each starts from the equilibrium at
an analytic (rho, u) field (Problem.init_fields) and runs with every axis
periodic and no walls: the kernels' box domain wraps them all.
Kolmogorov's force F_x(y) = F0·cos(κy), κ = 2π·n/ny, is a ForceProfile
along y, evaluated per coordinate (no stored field); in 3-D it is
F_x(z) = F0·cos(κz), κ = 2π·n/nz, a ForceProfile along z, on D3Q19 or
D3Q27 (lattice3d). The passive scalar is the D2Q5 thermal scalar with
buoyancy 0 and no y walls, stirred by a decaying Taylor-Green flow
(inlet_velocity > 0) or at rest. The shear layer and the passive scalar
are 2-D only, as in tpulbm.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SimulationParams
from ..lattice import D2Q5, D2Q9, D3Q19, D3Q27
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


def kolmogorov3d_kappa(params: SimulationParams) -> float:
    """3-D forcing wavenumber κ = 2π·n/nz (the force varies along z)."""
    return 2.0 * np.pi * params.kolmogorov_n / params.nz


def kolmogorov3d_force(params: SimulationParams) -> ForceProfile:
    """3-D Kolmogorov's F = (F0·cos(κz), 0, 0), F0 = u0·ν·κ² as in 2-D, as
    a profile along z."""
    kappa = kolmogorov3d_kappa(params)
    u0 = params.inlet_velocity or 0.04
    f0 = u0 * params.nu() * kappa * kappa
    return ForceProfile("z",
                        lambda z: (f0 * torch.cos(kappa * z), 0.0, 0.0))


def kolmogorov3d_fields(params: SimulationParams, perturb: float = 0.01):
    """Initial (rho, u): the laminar u_x(z) = u0·cos(κz) plus small
    deterministic transverse seeds along the other two axes."""
    nx, ny, nz = params.nx, params.ny, params.nz
    u0 = params.inlet_velocity or 0.04
    kappa = kolmogorov3d_kappa(params)
    z = np.arange(nz, dtype=np.float64)[:, None, None]
    y = np.arange(ny, dtype=np.float64)[None, :, None]
    x = np.arange(nx, dtype=np.float64)[None, None, :]
    ux = u0 * np.cos(kappa * z) * np.ones((1, ny, nx))
    uy = perturb * u0 * np.sin(2.0 * np.pi * x / nx) * np.ones((nz, ny, 1))
    uz = perturb * u0 * np.sin(2.0 * np.pi * y / ny) * np.ones((nz, 1, nx))
    return np.ones((nz, ny, nx)), np.stack([ux, uy, uz])


def taylor_green_3d_fields(params: SimulationParams):
    """The 3-D Taylor-Green vortex, one period per axis:
    u = u0 (sin x cos y cos z, -cos x sin y cos z, 0) with its pressure."""
    nx, ny, nz = params.nx, params.ny, params.nz
    u0 = params.inlet_velocity or 0.04
    kx, ky, kz = (2 * np.pi / nx, 2 * np.pi / ny, 2 * np.pi / nz)
    z = np.arange(nz, dtype=np.float64)[:, None, None] * kz
    y = np.arange(ny, dtype=np.float64)[None, :, None] * ky
    x = np.arange(nx, dtype=np.float64)[None, None, :] * kx
    ux = u0 * np.sin(x) * np.cos(y) * np.cos(z)
    uy = -u0 * np.cos(x) * np.sin(y) * np.cos(z)
    uz = np.zeros_like(ux)
    p = (u0 * u0 / 16.0) * (np.cos(2 * x) + np.cos(2 * y)) \
        * (np.cos(2 * z) + 2.0)
    rho = 1.0 + 3.0 * p
    return rho, np.stack([ux, uy, uz])


PROBLEMS = ("taylor-green", "shear-layer", "kolmogorov", "passive-scalar")


def check_2d(params: SimulationParams) -> None:
    """tpulbm's ValueError for the problems it runs in 2-D only (nz > 0
    takes the 3-D boxes: Taylor-Green and Kolmogorov)."""
    if params.is_3d and params.problem not in ("taylor-green",
                                               "kolmogorov"):
        raise ValueError(f"{params.problem} is 2-D only")


def _make_problem_3d(params: SimulationParams) -> Problem:
    """tpulbm's 3-D branch (periodic2d.py:195-215): periodic x, y and z,
    no walls, D3Q19 or D3Q27."""
    lat = D3Q27 if params.lattice3d == "d3q27" else D3Q19
    if params.problem == "kolmogorov":
        fields, force = kolmogorov3d_fields(params), kolmogorov3d_force(params)
    else:
        fields, force = taylor_green_3d_fields(params), None
    return Problem(
        params=params, lattice=lat, solid=None,
        init_rho=1.0, init_u=(0.0, 0.0, 0.0),
        walls_y=False, walls_z=False,
        periodic_x=True, periodic_y=True, periodic_z=True,
        body_force=tuple(params.body_force),
        force_profile=force,
        obstacle_bc=params.obstacle_bc,
        collision=params.collision,
        smagorinsky=params.smagorinsky,
        power_law=params.power_law() or (),
        trt_magic=params.trt_magic,
        mrt_rates=params.mrt_rates,
        init_fields=fields,
    )


def make_problem(params: SimulationParams) -> Problem:
    check_2d(params)
    if params.is_3d:
        return _make_problem_3d(params)
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
