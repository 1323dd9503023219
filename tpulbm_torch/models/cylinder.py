"""Flagship model: 2-D flow around a cylinder (von Kármán vortex street).

Channel with bounce-back walls at the bottom and top, a Zou-He velocity
inlet on the left, a Zou-He pressure outlet on the right and a solid
cylinder (the equilibrium, the bounce-back or the Bouzidi obstacle, the
last also spinning), with an optional uniform body force. Port of
tpulbm/models/cylinder.py.
"""
from __future__ import annotations

import numpy as np

from ..config import SimulationParams
from ..geometry import cylinder_mask
from ..lattice import D2Q9
from .base import Problem


def _cylinder_sdf(params: SimulationParams):
    """The circle's signed distance for the Bouzidi rule: positive outside
    the cylinder, so that geometry.cylinder_mask's inclusive dist² <= r²
    voxels (the solid cells) have sdf <= 0."""
    cx, cy = params.get_cylinder_x(), params.get_cylinder_y()
    r = float(params.get_cylinder_radius_cells())

    def sdf(pts):
        return np.hypot(pts[..., 0] - cx, pts[..., 1] - cy) - r

    return sdf


def _cylinder_spin(params: SimulationParams):
    """The spinning cylinder's rigid-rotation wall velocity
    u_w = ω × (x − c), ω = cylinder_omega (rad/step; the Bouzidi rule
    only)."""
    cx, cy = params.get_cylinder_x(), params.get_cylinder_y()
    om = float(params.cylinder_omega)

    def uw(pts):
        return np.stack([-om * (pts[..., 1] - cy),
                         om * (pts[..., 0] - cx)], axis=-1)

    return uw


def make_problem(params: SimulationParams) -> Problem:
    return Problem(
        params=params,
        lattice=D2Q9,
        solid=cylinder_mask(params),
        obstacle_sdf=_cylinder_sdf(params),
        obstacle_velocity=(_cylinder_spin(params)
                           if params.cylinder_omega else None),
        init_rho=1.0,
        init_u=(params.inlet_velocity, 0.0),
        inlet_zou_he=True,
        outlet_zou_he=True,
        walls_y=True,
        body_force=tuple(params.body_force),
        obstacle_bc=params.obstacle_bc,
        collision=params.collision,
        smagorinsky=params.smagorinsky,
        power_law=params.power_law() or (),
        trt_magic=params.trt_magic,
        mrt_rates=params.mrt_rates,
        clean_corners=params.zou_he_corners == "clean",
    )
