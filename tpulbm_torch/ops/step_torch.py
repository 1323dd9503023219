"""The plain PyTorch timestep: the port's oracle and the CUDA kernel's
plain version.

Port of tpulbm/ops/step_jax.py::make_step_rolled with the BGK branch of
_collide_block. Unpadded state (Q, ny, nx); streaming is a per-population
`torch.roll` (pull scheme) followed by the ghost sanitize at the
non-periodic edges, then the BC stack. Runs in f32 and f64.

Step order parity with the reference loop: collision -> streaming ->
boundary conditions.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import physics
from ..models.base import Problem
from . import boundaries


def collide_block(problem: Problem, f: torch.Tensor) -> torch.Tensor:
    """Post-collision populations. With obstacle_bc="equilibrium" solid
    cells hold the rest equilibrium, an exact BGK fixed point, so they need
    no special case here (apply_obstacle re-pins them every step)."""
    if problem.collision != "bgk":
        raise NotImplementedError(
            f"collision={problem.collision!r} is not ported")
    return physics.collide(problem.lattice, f, 1.0 / problem.params.tau)


def coords(problem: Problem, device) -> dict:
    """Broadcastable global coordinates, extents and the solid mask."""
    ny, nx = problem.spatial_shape
    solid = (None if problem.solid is None
             else torch.as_tensor(problem.solid, device=device))
    return {"yy": torch.arange(ny, device=device).reshape(ny, 1),
            "xx": torch.arange(nx, device=device).reshape(1, nx),
            "ny": ny, "nx": nx, "solid": solid}


def make_step_rolled(problem: Problem,
                     device) -> Callable[[torch.Tensor], torch.Tensor]:
    """Oracle step on the unpadded state (Q, ny, nx) on `device`.

    Ghost semantics (the reference's, verified against its compiled code):
    pulls that cross the x edges read ZERO (its east/west ghost columns are
    overwritten every step by never-received halo buffers), pulls that
    cross the y edges read the frozen initial equilibrium, and so do the
    corner ghosts (a diagonal pull at a wall row that crosses a corner).
    """
    if len(problem.spatial_shape) != 2:
        raise NotImplementedError("3-D steps are not ported")
    lat = problem.lattice
    c = lat.c
    eq_ring = problem.ghost_ring_values()
    cd = coords(problem, device)
    yy, xx = cd["yy"], cd["xx"]
    ny, nx = cd["ny"], cd["nx"]

    # per-direction edge masks, built once
    sanitize = []
    for i in range(lat.Q):
        cix, ciy = int(c[i, 0]), int(c[i, 1])
        x_out = (xx == 0) if cix > 0 else (xx == nx - 1) if cix < 0 else None
        y_out = (yy == 0) if ciy > 0 else (yy == ny - 1) if ciy < 0 else None
        only_x = None
        if x_out is not None:
            only_x = x_out if y_out is None else (x_out & ~y_out)
        sanitize.append((only_x, y_out, float(eq_ring[i])))

    def step(f: torch.Tensor) -> torch.Tensor:
        f_post = collide_block(problem, f)
        planes = []
        for i in range(lat.Q):
            # pull: f_new(x) = f_post(x - c_i) -> roll by +c_i per axis
            plane = torch.roll(f_post[i], (int(c[i, 1]), int(c[i, 0])), (0, 1))
            only_x, y_out, eq_i = sanitize[i]
            if only_x is not None:
                plane = torch.where(only_x, 0.0, plane)
            if y_out is not None:
                plane = torch.where(y_out, eq_i, plane)
            planes.append(plane)
        planes = boundaries.apply_all(problem, planes, cd)
        return torch.stack(planes)

    return step
