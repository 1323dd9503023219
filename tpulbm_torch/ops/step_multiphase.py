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
rolls, the i order, the per-direction accumulation).

On a mesh of shards (parallel/): make_local_steps_multiphase, tpulbm's
double-refresh pair, steps a shard's block padded by a one-cell ring (the
plain tier refreshes the ring before each half); make_ring_step_multiphase,
the plain version of the kernel's ring build, steps a block from its
pre-collision rings two cells deep; physical_velocity_padded is
physical_velocity of a block padded by its neighbours' cells, with the
wall rule at the global wall rows.
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
                    wall_psi: float, walls: bool = True) -> torch.Tensor:
    """(D, ny, nx) interaction force from a ψ field. Rolls wrap in both
    axes; x is periodic, and with `walls` a y pull that crossed a wall is
    replaced by the phantom wall ψ. A padded block passes walls=False: its
    ring rows hold the ψ its centre reads (tpulbm's is_bottom and is_top
    off), and its outermost cells come out wrong."""
    ny = psi.shape[0]
    yy = torch.arange(ny, device=psi.device)[:, None]
    comps = [None, None]
    for i in range(1, lat.Q):
        cx, cy = int(lat.c[i, 0]), int(lat.c[i, 1])
        nb = torch.roll(psi, (-cy, -cx), (0, 1))
        if walls and cy > 0:  # reads row y+1: beyond the top wall
            nb = torch.where(yy == ny - 1, wall_psi, nb)
        elif walls and cy < 0:
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


def _outside_rows(problem: Problem, y0: int, rows: int, device):
    """(rows, 1) bool: the rows of a padded block whose first row is the
    global row y0 that lie beyond a y wall (global y < 0 or >= ny)."""
    gy = y0 + torch.arange(rows, device=device)[:, None]
    return (gy < 0) | (gy >= problem.params.ny)


def make_local_steps_multiphase(problem: Problem, origin: tuple[int, int],
                                local_shape: tuple[int, int]):
    """(collide(spad) -> spad', stream(spad) -> spad'): tpulbm's
    make_local_steps_multiphase for the shard whose block (9, *local_shape)
    starts at the global cell `origin` (y, x), on its block padded by a
    one-cell ring. The plain tier refreshes the ring before each: collide
    takes ψ of the padded block (whose physical-edge ring rows hold the
    frozen equilibrium ring, the phantom wall fluid) and writes the
    post-collision centre; stream pulls the centre from the padded
    post-collision block and applies the exact-mass walls at the global
    wall rows."""
    lat, g, rho0 = _mp_parts(problem)
    check_geometry(problem)
    nyl, nxl = local_shape
    y0 = origin[0]
    inv_tau = 1.0 / problem.params.tau
    psi_wall = wall_psi(problem)
    opp = lat.opposite
    is_bottom, is_top = y0 == 0, y0 + nyl == problem.params.ny
    center = (slice(1, -1), slice(1, -1))

    def collide(spad: torch.Tensor) -> torch.Tensor:
        rho = torch.sum(spad, dim=0)
        psi = physics.shan_chen_psi(rho, rho0)
        F = shan_chen_force(lat, psi, g, psi_wall, walls=False)
        f_post = physics.collide_shan_chen(lat, spad, inv_tau, F)
        out = spad.clone()
        out[(slice(None),) + center] = f_post[(slice(None),) + center]
        return out

    def stream(spad: torch.Tensor) -> torch.Tensor:
        rows = torch.arange(nyl, device=spad.device)[:, None]
        planes = []
        for i in range(lat.Q):
            cx, cy = int(lat.c[i, 0]), int(lat.c[i, 1])
            planes.append(spad[i, 1 - cy:1 - cy + nyl, 1 - cx:1 - cx + nxl])
        for i in range(lat.Q):
            cy = int(lat.c[i, 1])
            if cy > 0 and is_bottom:
                planes[i] = torch.where(rows == 0, spad[int(opp[i])][center],
                                        planes[i])
            elif cy < 0 and is_top:
                planes[i] = torch.where(rows == nyl - 1,
                                        spad[int(opp[i])][center], planes[i])
        out = spad.clone()
        out[(slice(None),) + center] = torch.stack(planes)
        return out

    return collide, stream


def make_ring_step_multiphase(problem: Problem, origin: tuple[int, int],
                              local_shape: tuple[int, int], device):
    """step(f, rb, rt, rl=None, rr=None) -> f': one Shan-Chen step of the
    shard whose block (9, *local_shape) starts at the global cell `origin`
    (y, x), from its pre-collision rings two cells deep (halo.exchange at
    depth 2; rl and rr None where the block spans every column): ψ of the
    block and its 2-cell ring, the phantom wall ψ on rows beyond a wall,
    the collision of the block and its 1-cell ring, the pull, the
    exact-mass walls at the global wall rows. The plain version of the
    multiphase kernel's ring build (ops/step_multiphase_cuda.py)."""
    from .step_rings_torch import assemble
    lat, g, rho0 = _mp_parts(problem)
    check_geometry(problem)
    nyl, nxl = local_shape
    y0 = origin[0]
    inv_tau = 1.0 / problem.params.tau
    psi_wall = wall_psi(problem)
    opp = lat.opposite
    eq_ring = problem.ghost_ring_values()
    outside = _outside_rows(problem, y0 - 2, nyl + 4, device)
    rows = torch.arange(nyl, device=device)[:, None]
    is_bottom, is_top = y0 == 0, y0 + nyl == problem.params.ny
    center = (slice(2, -2), slice(2, -2))

    def step(f, rb, rt, rl=None, rr=None) -> torch.Tensor:
        fpad = assemble(f, rb, rt, rl, rr, 2, True, eq_ring)
        psi = physics.shan_chen_psi(torch.sum(fpad, dim=0), rho0)
        psi = torch.where(outside, psi_wall, psi)
        F = shan_chen_force(lat, psi, g, psi_wall, walls=False)
        f_post = physics.collide_shan_chen(lat, fpad, inv_tau, F)
        planes = []
        for i in range(lat.Q):
            cx, cy = int(lat.c[i, 0]), int(lat.c[i, 1])
            plane = f_post[i, 2 - cy:2 - cy + nyl, 2 - cx:2 - cx + nxl]
            if cy > 0 and is_bottom:
                plane = torch.where(rows == 0, f_post[int(opp[i])][center],
                                    plane)
            elif cy < 0 and is_top:
                plane = torch.where(rows == nyl - 1,
                                    f_post[int(opp[i])][center], plane)
            planes.append(plane)
        return torch.stack(planes)

    return step


def host_wall_psi(problem: Problem) -> float:
    """ψ of the phantom wall fluid in tpulbm's host form (NumPy's exp), as
    its physical_velocity computes it."""
    _, _, rho0 = _mp_parts(problem)
    return rho0 * (1.0 - float(np.exp(-problem.init_rho / rho0)))


def physical_velocity(problem: Problem, f: torch.Tensor):
    """(rho, u_phys): the half-step-corrected velocity u + F/(2ρ), the
    measurable momentum of the forced system (Shan & Chen 1993)."""
    lat, g, rho0 = _mp_parts(problem)
    rho, u = physics.moments(lat, f)
    psi = physics.shan_chen_psi(rho, rho0)
    F = shan_chen_force(lat, psi, g, host_wall_psi(problem))
    return rho, u + F / (2.0 * rho)


def physical_velocity_padded(problem: Problem, fpad: torch.Tensor,
                             y0: int):
    """physical_velocity of a shard's block from the block padded by a
    one-cell ring of its neighbours' cells (halo.pad_block), whose first
    row is the global row y0 - 1: ψ of every padded cell, the phantom wall
    ψ (tpulbm's host form) on rows beyond a y wall, so the wall rule acts
    at the global wall rows only; (rho, u_phys) of the centre, the values
    physical_velocity gives those cells of the whole grid."""
    lat, g, rho0 = _mp_parts(problem)
    rho, u = physics.moments(lat, fpad)
    psi = physics.shan_chen_psi(rho, rho0)
    psi_wall = host_wall_psi(problem)
    psi = torch.where(_outside_rows(problem, y0 - 1, fpad.shape[-2],
                                    fpad.device), psi_wall, psi)
    F = shan_chen_force(lat, psi, g, psi_wall, walls=False)
    center = (slice(1, -1), slice(1, -1))
    u_phys = u + F / (2.0 * rho)
    return rho[center], u_phys[(slice(None),) + center]
