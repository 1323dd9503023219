"""The plain PyTorch timestep: the port's oracle and the CUDA kernel's
plain version.

Port of tpulbm/ops/step_jax.py::make_step_rolled with _collide_block's
collisions, the uniform body force, the force profile (_add_force_field),
the bounce-back and the Bouzidi obstacles, in 2-D (D2Q9) and 3-D
(D3Q19, D3Q27). Unpadded state (Q, *spatial); streaming is a
per-population `torch.roll` (pull scheme) followed by the ghost sanitize
at the non-periodic edges (x is left to wrap under periodic_x, y under
periodic_y, z under periodic_z), then the BC stack.
Runs in f32 and f64.

Step order parity with the reference loop: collision -> streaming ->
boundary conditions.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import physics
from ..models.base import Problem
from . import boundaries


def collision_mode(problem: Problem) -> str:
    """The collision a step of `problem` runs, in tpulbm's order of
    precedence (step_jax.py:_collide_block): trt, mrt, regularized and kbc
    by name, then the power law before Smagorinsky, then BGK."""
    if problem.collision in ("trt", "mrt", "regularized", "kbc"):
        return problem.collision
    if problem.collision != "bgk":
        raise ValueError(f"unknown collision {problem.collision!r}")
    if problem.power_law:
        return "power_law"
    if problem.smagorinsky:
        return "smagorinsky"
    return "bgk"


def _collide(problem: Problem, f: torch.Tensor) -> torch.Tensor:
    lat = problem.lattice
    inv_tau = 1.0 / problem.params.tau
    force = problem.body_force
    mode = collision_mode(problem)
    if mode == "trt":
        return physics.collide_trt(lat, f, inv_tau, force, problem.trt_magic)
    if mode == "mrt":
        return physics.collide_mrt(lat, f, inv_tau, force,
                                   overrides=dict(problem.mrt_rates) or None)
    if mode == "regularized":
        return physics.collide_regularized(lat, f, inv_tau, force)
    if mode == "kbc":
        return physics.collide_kbc(lat, f, inv_tau, force)
    if mode == "power_law":
        return physics.collide_power_law(lat, f, *problem.power_law, force)
    if mode == "smagorinsky":
        return physics.collide_smagorinsky(lat, f, inv_tau,
                                           problem.smagorinsky, force)
    return physics.collide(lat, f, inv_tau, force)


def collide_block(problem: Problem, f: torch.Tensor,
                  solid: torch.Tensor | None = None,
                  source: torch.Tensor | None = None) -> torch.Tensor:
    """Post-collision populations, the body force's source included. With
    obstacle_bc="equilibrium" solid cells are re-pinned to the rest
    equilibrium by apply_obstacle every step, so they need no special case
    here; with "bounce_back" and a `solid` mask they skip the collision
    (tpulbm's step_jax._collide_block) and keep their populations.
    `source` (force_source) is the force profile's, added after, on every
    cell (tpulbm's _add_force_field)."""
    f_post = _collide(problem, f)
    if solid is not None and problem.obstacle_bc == "bounce_back":
        f_post = torch.where(solid[None], f, f_post)
    if source is not None:
        f_post = f_post + source
    return f_post


def force_source(problem: Problem, cd: dict, dtype: torch.dtype,
                 device) -> torch.Tensor | None:
    """The force profile's source S_i at every cell of the block whose
    coordinates `cd` holds (coords' dict), broadcastable against its
    state: each cell takes the value at the coordinate of the cell that
    owns it, its own taken mod the extent (a halo cell of a periodic axis
    takes its owner's). None without a profile."""
    prof = problem.force_profile
    if prof is None:
        return None
    name = ("xx", "yy", "zz")[prof.index]
    n = cd["n" + name[0]]
    table = prof.table(problem.lattice, n, dtype, device)
    coord = cd[name]
    return table[:, coord.reshape(-1) % n].reshape(
        (problem.lattice.Q,) + tuple(coord.shape))


def coords(problem: Problem, device) -> dict:
    """Broadcastable global coordinates ('zz', 'yy', 'xx' over the spatial
    axes, 'zz' in 3-D only), the extents and the solid mask."""
    shape = problem.spatial_shape
    ndim = len(shape)
    cd = {}
    for d, (name, n) in enumerate(zip(("zz", "yy", "xx")[-ndim:], shape)):
        bshape = [1] * ndim
        bshape[d] = n
        cd[name] = torch.arange(n, device=device).reshape(bshape)
        cd["n" + name[0]] = n
    cd["solid"] = (None if problem.solid is None
                   else torch.as_tensor(problem.solid, device=device))
    return cd


def make_step_rolled(problem: Problem, device, cd: dict | None = None
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Oracle step on the unpadded state (Q, *spatial) on `device`.

    Ghost semantics (the reference's, verified against its compiled code):
    pulls whose source leaves only the x range read ZERO (its east/west
    ghost columns are overwritten every step by never-received halo
    buffers); pulls whose source leaves the y range, or the z range in 3-D,
    read the frozen initial equilibrium, and so do the corner ghosts (a
    diagonal pull at a wall that crosses a corner). Under periodic_x the x
    pulls wrap, under periodic_y the y pulls, under periodic_z the z
    pulls.

    cd: the coordinate dict of a block other than the whole grid (as
    `coords` gives it, its 'yy' and 'xx' the block's global coordinates;
    ops/step_rings_torch.py's padded shard, with its cut of the Bouzidi
    link table as 'bz_q'), so every edge rule keys on the domain's own
    edges; the roll then wraps the block's own edge, which leaves its
    outermost cells wrong.
    """
    lat = problem.lattice
    c = lat.c
    eq_ring = problem.ghost_ring_values()
    cd = coords(problem, device) if cd is None else cd
    ndim = len(problem.spatial_shape)
    xx, yy = cd["xx"], cd["yy"]

    def leaves(coord, n, comp):
        """Mask of cells whose pull source x - c leaves [0, n) on an axis."""
        return (coord == 0) if comp > 0 else \
            (coord == n - 1) if comp < 0 else None

    def either(a, b):
        return b if a is None else a if b is None else a | b

    # per-direction edge masks and roll shifts, built once
    plan = []
    for i in range(lat.Q):
        x_out = (None if problem.periodic_x
                 else leaves(xx, cd["nx"], int(c[i, 0])))
        y_out = (None if problem.periodic_y
                 else leaves(yy, cd["ny"], int(c[i, 1])))
        if ndim == 3 and not problem.periodic_z:
            y_out = either(y_out, leaves(cd["zz"], cd["nz"], int(c[i, 2])))
        only_x = None
        if x_out is not None:
            only_x = x_out if y_out is None else (x_out & ~y_out)
        # pull: f_new(x) = f_post(x - c_i) -> roll by +c_i per array axis
        shifts = tuple(int(c[i, d]) for d in range(lat.D))[::-1]
        plan.append((shifts, only_x, y_out, float(eq_ring[i])))
    dims = tuple(range(ndim))
    dtype = torch.float64 if problem.dtype == np.float64 else torch.float32
    source = force_source(problem, cd, dtype, device)
    bouzidi = problem.obstacle_bc == "bouzidi" and cd["solid"] is not None
    if bouzidi:
        # tpulbm's float32 table, read in the state's dtype
        table = cd.get("bz_q")
        if table is None:
            from .bouzidi import device_table
            table = device_table(problem, device)
        cd = {**cd, "bz_q": table.to(dtype)}

    def step(f: torch.Tensor) -> torch.Tensor:
        f_post = collide_block(problem, f, cd["solid"], source)
        if bouzidi:
            cd["f_post"] = list(f_post)
        planes = []
        for i, (shifts, only_x, y_out, eq_i) in enumerate(plan):
            plane = torch.roll(f_post[i], shifts, dims)
            if only_x is not None:
                plane = torch.where(only_x, 0.0, plane)
            if y_out is not None:
                plane = torch.where(y_out, eq_i, plane)
            planes.append(plane)
        planes = boundaries.apply_all(problem, planes, cd)
        return torch.stack(planes)

    return step
