"""Rayleigh-Bénard convection and the side-heated cavity (D2Q9 flow + D2Q5
temperature, Boussinesq coupling).

Port of tpulbm/models/rayleigh_benard.py. Rayleigh-Bénard: a fluid layer
between a hot plate below and a cold plate above, periodic in x. The
heated cavity (de Vahl Davis 1983) is rotated into the same frame: its hot
and cold walls are the y walls, its adiabatic no-slip walls the x walls,
and buoyancy acts along +x.

Control parameters (H = effective_height):

    Ra = buoyancy · ΔT · H³ / (nu · alpha),    Pr = nu / alpha
"""
from __future__ import annotations

from ..config import SimulationParams
from ..lattice import D2Q5, D2Q9
from .base import Problem, ThermalConfig


def effective_height(params: SimulationParams) -> float:
    """Plate gap H in lattice units: ny. The walls (full-way bounce-back
    for f, half-link anti-bounce-back for g) sit half a link outside the
    boundary nodes on each side (tpulbm's measurement of the convection
    onset places Ra_c within ~2% of 1707.76 with this H)."""
    return float(params.ny)


def buoyancy_for_rayleigh(ra: float, params: SimulationParams) -> float:
    """Boussinesq coefficient beta·g giving the requested Rayleigh number
    on this grid: buoyancy = Ra · nu · alpha / (ΔT · H³)."""
    nu = params.nu()
    alpha = (params.thermal_tau - 0.5) / 3.0
    dt = params.t_hot - params.t_cold
    return ra * nu * alpha / (dt * effective_height(params) ** 3)


def make_problem(params: SimulationParams) -> Problem:
    if params.is_3d:
        raise ValueError("the rayleigh-benard model is 2-D (set nz=0)")
    if params.thermal_tau <= 0.5:
        raise ValueError(
            f"rayleigh-benard needs thermal_tau > 0.5 (alpha > 0), got "
            f"{params.thermal_tau}")
    buoyancy = params.buoyancy
    if not buoyancy and params.rayleigh:
        buoyancy = buoyancy_for_rayleigh(params.rayleigh, params)
    cavity = params.problem == "heated-cavity"
    thermal = ThermalConfig(
        lattice=D2Q5,
        tau_g=params.thermal_tau,
        t_bottom=params.t_hot,
        t_top=params.t_cold,
        buoyancy=buoyancy,
        buoyancy_axis=0 if cavity else 1,
        # the side-heated base state is convective from the start: no
        # seed mode
        perturb=0.0 if cavity else ThermalConfig.perturb,
    )
    return Problem(
        params=params,
        lattice=D2Q9,
        solid=None,
        init_rho=1.0,
        init_u=(0.0, 0.0),
        walls_y=True,
        walls_x=cavity,
        periodic_x=not cavity,
        collision=params.collision,
        smagorinsky=params.smagorinsky,
        thermal=thermal,
    )
