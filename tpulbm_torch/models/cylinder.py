"""Flagship model: 2-D flow around a cylinder (von Kármán vortex street).

Channel with bounce-back walls at the bottom and top, a Zou-He velocity
inlet on the left, a Zou-He pressure outlet on the right and a solid
cylinder (the equilibrium or the bounce-back obstacle), with an optional
uniform body force. Port of tpulbm/models/cylinder.py for the voxel
obstacle modes.
"""
from __future__ import annotations

from ..config import SimulationParams
from ..geometry import cylinder_mask
from ..lattice import D2Q9
from .base import Problem


def make_problem(params: SimulationParams) -> Problem:
    return Problem(
        params=params,
        lattice=D2Q9,
        solid=cylinder_mask(params),
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
