"""On-device diagnostics: macroscopic fields, stability, max velocity, and
the thermal problems' temperature and Nusselt number (the passive
scalar's variance).

Port of tpulbm/ops/diagnostics.py (fields_fn, stability_fn,
max_velocity_fn; max |u| takes the bare moments for every problem, as in
tpulbm). Each *_fn returns a function of the state tensor whose
result stays on the device until the caller fetches it. The moments are
taken of f[:lattice.Q]: a thermal state stacks its 5 temperature planes
under the 9 flow planes, and they must not enter rho.
"""
from __future__ import annotations

import torch

from .. import physics
from ..models.base import Problem
from . import step_multiphase, step_thermal


def _solid(problem: Problem, device, solid=None):
    """`solid` (a shard's mask on a mesh), else the problem's on `device`
    (None without an obstacle)."""
    if solid is not None or problem.solid is None:
        return solid
    return torch.as_tensor(problem.solid, device=device)


def fields_fn(problem: Problem, device, solid=None):
    """f -> (rho, u) with the reference's solid-cell overrides: rho = 1 and
    u = 0 at solid cells (of `solid`, a shard's mask, where given). For Shan-Chen multiphase, u is the
    half-step-corrected u + F/(2rho) (step_multiphase.physical_velocity):
    bare moments would be off by F/(2rho) at every interface cell."""
    lat = problem.lattice
    solid = _solid(problem, device, solid)

    def fn(f: torch.Tensor):
        if problem.shan_chen:
            rho, u = step_multiphase.physical_velocity(problem, f)
        else:
            rho, u = physics.moments(lat, f[:lat.Q])
        if solid is not None:
            rho = torch.where(solid, 1.0, rho)
            u = torch.where(solid[None], 0.0, u)
        return rho, u

    return fn


def stability_fn(problem: Problem):
    """f -> bool scalar tensor: every population finite and |f| < 1e5."""
    def fn(f: torch.Tensor) -> torch.Tensor:
        return physics.is_stable(f)
    return fn


def max_velocity_fn(problem: Problem, device, solid=None):
    """f -> max |u| (solid cells report u = 0; `solid` as in fields_fn)."""
    lat = problem.lattice
    solid = _solid(problem, device, solid)

    def fn(f: torch.Tensor) -> torch.Tensor:
        return physics.max_velocity(lat, f[:lat.Q], solid)

    return fn


def temperature_fn(problem: Problem):
    """s -> the temperature field (ny, nx) of a thermal state."""
    def fn(s: torch.Tensor) -> torch.Tensor:
        return step_thermal.temperature(problem, s)
    return fn


def nusselt_fn(problem: Problem):
    """s -> the thermal trace's value (0-d) of a thermal state: the
    instantaneous Nusselt number between y walls, the scalar variance of
    the periodic passive scalar (tpulbm's Nu slot)."""
    trace = (step_thermal.nusselt if problem.walls_y
             else step_thermal.scalar_variance)

    def fn(s: torch.Tensor) -> torch.Tensor:
        return trace(problem, s)
    return fn
