"""Lid-driven square cavity (D2Q9): bounce-back walls on three sides and a
lid moving in +x on top, a closed box whose mass the Runner pins.

Port of tpulbm/models/cavity.py. Re = U_lid (nx - 1) / nu: the walls sit
at the nodes, so the side is nx - 1 cells; `inlet_velocity` is the lid
speed.
"""
from __future__ import annotations

from ..config import SimulationParams
from ..lattice import D2Q9
from .base import Problem


def tau_for_cavity_reynolds(re: float, u_lid: float, nx: int) -> float:
    """tau with nu = u_lid (nx - 1) / re and nu = (tau - 1/2) / 3."""
    return 3.0 * u_lid * (nx - 1) / re + 0.5


def make_problem(params: SimulationParams) -> Problem:
    if params.is_3d:
        raise ValueError("the cavity model is 2-D (set nz=0)")
    if params.nx != params.ny:
        raise ValueError(
            f"the cavity model is a square: nx ({params.nx}) must equal "
            f"ny ({params.ny})")
    return Problem(
        params=params,
        lattice=D2Q9,
        solid=None,
        init_rho=1.0,
        init_u=(0.0, 0.0),
        walls_y=True,
        walls_x=True,
        lid_u=params.inlet_velocity,
        closed_box=True,
        body_force=tuple(params.body_force),
        obstacle_bc=params.obstacle_bc,
        collision=params.collision,
        smagorinsky=params.smagorinsky,
        power_law=params.power_law() or (),
        trt_magic=params.trt_magic,
        mrt_rates=params.mrt_rates,
    )
