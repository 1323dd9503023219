"""3-D flow past a sphere in a duct (D3Q19).

Equilibrium inlet at x = 0, zero-gradient outlet at x = nx-1, bounce-back
walls in y and z, a voxel sphere, under any collision tpulbm runs in 3-D
(BGK, TRT, MRT, regularized, Smagorinsky, power law), with the
equilibrium, the bounce-back or the Bouzidi obstacle and an optional
uniform body force. Port of tpulbm/models/cylinder3d.py for the D3Q19
lattice.
"""
from __future__ import annotations

import numpy as np

from ..config import SimulationParams
from ..geometry import sphere_mask
from ..lattice import D3Q19
from .base import Problem


def _sphere_sdf(params: SimulationParams):
    """The sphere's signed distance for the Bouzidi rule (positive
    outside; geometry.sphere_mask's inclusive voxels have sdf <= 0)."""
    cx, cy = params.get_cylinder_x(), params.get_cylinder_y()
    cz = params.nz // 2
    r = float(params.get_cylinder_radius_cells())

    def sdf(pts):
        return np.sqrt((pts[..., 0] - cx) ** 2 + (pts[..., 1] - cy) ** 2
                       + (pts[..., 2] - cz) ** 2) - r

    return sdf


def make_problem(params: SimulationParams) -> Problem:
    if not params.is_3d:
        raise ValueError("cylinder3d requires nz > 0")
    return Problem(
        params=params,
        lattice=D3Q19,
        solid=sphere_mask(params),
        obstacle_sdf=_sphere_sdf(params),
        init_rho=1.0,
        init_u=(params.inlet_velocity, 0.0, 0.0),
        inlet_equilibrium=True,
        outlet_zero_grad=True,
        walls_y=True,
        walls_z=True,
        body_force=tuple(params.body_force),
        obstacle_bc=params.obstacle_bc,
        collision=params.collision,
        smagorinsky=params.smagorinsky,
        power_law=params.power_law() or (),
        trt_magic=params.trt_magic,
        mrt_rates=params.mrt_rates,
    )
