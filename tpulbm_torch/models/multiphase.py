"""Shan-Chen single-component multiphase model.

Port of tpulbm/models/multiphase.py. An x-periodic channel with exact-mass
bounce-back walls in y, started from either a liquid droplet
(cylinder_radius > 0: radius fraction of ny, centred at
cylinder_x/cylinder_y) or a flat liquid band spanning the middle half of x
(cylinder_radius == 0). Both relax to the coexistence densities of the
pseudopotential equation of state (physics.shan_chen_pressure) under the
interaction strength g = params.shan_chen_g (g < −4 separates phases for
the standard ψ with ρ0 = 1).
"""
from __future__ import annotations

import numpy as np

from ..config import SimulationParams
from ..lattice import D2Q9
from .base import Problem


def make_problem(params: SimulationParams) -> Problem:
    g = params.shan_chen_g
    if not g:
        raise ValueError("the multiphase problem needs --shan-chen-g "
                         "(g < -4 separates phases)")
    ny, nx = params.ny, params.nx
    rho_l, rho_v = params.mp_rho_liquid, params.mp_rho_vapor
    yy, xx = np.ogrid[0:ny, 0:nx]
    if params.cylinder_radius > 0.0:
        r = params.cylinder_radius * ny
        cx_, cy_ = params.cylinder_x * nx, params.cylinder_y * ny
        liquid = (xx - cx_) ** 2 + (yy - cy_) ** 2 <= r * r
    else:  # flat liquid band spanning the middle half of x, all rows
        liquid = np.broadcast_to((xx >= nx // 4) & (xx < 3 * nx // 4),
                                 (ny, nx))
    rho_map = np.where(liquid, rho_l, rho_v).astype(np.float64)
    # init_rho doubles as the phantom wall density the ψ stencil reads
    # beyond the walls: > 1 wets, < 1 repels
    wall_rho = params.mp_wall_rho or 1.0
    return Problem(
        params=params,
        lattice=D2Q9,
        solid=None,
        init_rho=wall_rho,
        init_u=(0.0, 0.0),
        init_rho_map=rho_map,
        walls_y=True,
        periodic_x=True,
        shan_chen=(float(g), 1.0),
        obstacle_bc=params.obstacle_bc,
        collision=params.collision,
    )
