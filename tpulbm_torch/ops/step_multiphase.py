"""The plain PyTorch Shan-Chen multiphase step: the oracle of the multiphase
slice and the plain version of the CUDA kernel csrc/step_multiphase.cu.

Port of tpulbm/ops/step_multiphase.py (shan_chen_force,
make_step_multiphase, physical_velocity). One step on f (9, ny, nx) in an
x-periodic channel with exact-mass walls in y:

  1. ψ = ρ0 (1 − e^(−ρ/ρ0)) of the pre-collision density;
  2. the interaction force F = −g ψ Σ_{i>0} w_i ψ(x + c_i) c_i, where a ψ
     pull across a wall reads the phantom wall ψ of ρ = init_rho;
  3. BGK toward equilibrium(ρ, u + τ F/ρ) (physics.collide_shan_chen);
  4. pull-stream with torch.roll (x and y wrap), then at a wall row the
     inward populations take the node's own post-collision opposite
     (full-way bounce-back, so the wall conserves mass exactly).

Runs in f32 and f64; every expression keeps tpulbm's operation order (the
rolls, the i order, the per-direction accumulation). tpulbm's padded
double-refresh steps (make_local_steps_multiphase) are for meshes and wait
for ROADMAP Queue 1 item 19.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import physics
from ..lattice import Lattice
from ..models.base import Problem


def _mp_parts(problem: Problem):
    if not problem.shan_chen:
        raise ValueError("step_multiphase needs problem.shan_chen = (g, rho0)")
    g, rho0 = problem.shan_chen
    return problem.lattice, float(g), float(rho0)


def check_geometry(problem: Problem) -> None:
    """Raise NotImplementedError for a layout other than the x-periodic
    channel with y walls, as tpulbm does."""
    if not problem.periodic_x or not problem.walls_y:
        raise NotImplementedError("multiphase v1 is an x-periodic channel")


def wall_psi(problem: Problem) -> float:
    """ψ of the phantom wall fluid (ρ = init_rho), a host float computed as
    tpulbm's step computes it: ψ of a float64 scalar."""
    _, _, rho0 = _mp_parts(problem)
    rho = torch.tensor(float(problem.init_rho), dtype=torch.float64)
    return float(physics.shan_chen_psi(rho, rho0))


def shan_chen_force(lat: Lattice, psi: torch.Tensor, g: float,
                    wall_psi: float) -> torch.Tensor:
    """(D, ny, nx) interaction force from a ψ field. Rolls wrap in both
    axes; x is periodic, and a y pull that crossed a wall is replaced by
    the phantom wall ψ."""
    ny = psi.shape[0]
    yy = torch.arange(ny, device=psi.device)[:, None]
    comps = [None, None]
    for i in range(1, lat.Q):
        cx, cy = int(lat.c[i, 0]), int(lat.c[i, 1])
        nb = torch.roll(psi, (-cy, -cx), (0, 1))
        if cy > 0:  # reads row y+1: beyond the top wall at y = ny-1
            nb = torch.where(yy == ny - 1, wall_psi, nb)
        elif cy < 0:
            nb = torch.where(yy == 0, wall_psi, nb)
        w = float(lat.w[i])
        for d, cd in ((0, cx), (1, cy)):
            if cd == 0:
                continue
            term = (w * cd) * nb
            comps[d] = term if comps[d] is None else comps[d] + term
    return (-g) * psi * torch.stack(comps)


def make_step_multiphase(problem: Problem,
                         device) -> Callable[[torch.Tensor], torch.Tensor]:
    """Oracle step on the (9, ny, nx) state on `device`."""
    lat, g, rho0 = _mp_parts(problem)
    check_geometry(problem)
    ny, nx = problem.spatial_shape
    inv_tau = 1.0 / problem.params.tau
    psi_wall = wall_psi(problem)
    opp = lat.opposite
    yy = torch.arange(ny, device=device)[:, None]

    def step(f: torch.Tensor) -> torch.Tensor:
        rho = torch.sum(f, dim=0)
        psi = physics.shan_chen_psi(rho, rho0)
        F = shan_chen_force(lat, psi, g, psi_wall)
        f_post = physics.collide_shan_chen(lat, f, inv_tau, F)
        planes = []
        for i in range(lat.Q):
            cx, cy = int(lat.c[i, 0]), int(lat.c[i, 1])
            planes.append(torch.roll(f_post[i], (cy, cx), (0, 1)))
        # exact-mass walls: the inward populations at a wall row are the
        # node's own post-collision outward values (the wrapped pulls
        # there are overwritten)
        for i in range(lat.Q):
            cy = int(lat.c[i, 1])
            if cy > 0:
                planes[i] = torch.where(yy == 0, f_post[int(opp[i])],
                                        planes[i])
            elif cy < 0:
                planes[i] = torch.where(yy == ny - 1, f_post[int(opp[i])],
                                        planes[i])
        return torch.stack(planes)

    return step


def physical_velocity(problem: Problem, f: torch.Tensor):
    """(rho, u_phys): the half-step-corrected velocity u + F/(2ρ), the
    measurable momentum of the forced system (Shan & Chen 1993)."""
    lat, g, rho0 = _mp_parts(problem)
    rho, u = physics.moments(lat, f)
    psi = physics.shan_chen_psi(rho, rho0)
    # tpulbm's host form here (NumPy's exp), as in its physical_velocity
    psi_wall = rho0 * (1.0 - float(np.exp(-problem.init_rho / rho0)))
    F = shan_chen_force(lat, psi, g, psi_wall)
    return rho, u + F / (2.0 * rho)
