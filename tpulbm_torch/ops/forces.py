"""Momentum-exchange force on the obstacle.

Port of tpulbm/ops/forces.py for the voxel obstacle:

    F = Σ_i 2 c_i Σ_x f_post_i(x) · fluid(x) · solid(x + c_i)

on the post-collision populations (the reference records forces after
collision, before streaming); under the bounce-back obstacle the solid
cells skip that collision, as in the step.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.base import Problem
from . import step_torch


def shifted_masks(problem: Problem, solid: torch.Tensor) -> list:
    """[(i, fluid(x) & solid(x + c_i))] for the moving directions i: the
    links the momentum exchange sums over. A solid cell at a domain edge
    must not pair with fluid on the opposite edge, so the rolled mask is
    cleared there, except along a periodic x axis, where the wrap is a real
    neighbour."""
    lat = problem.lattice
    ndim = solid.dim()
    fluid = ~solid
    masks = []
    for i in range(1, lat.Q):
        # solid neighbour at x + c_i: roll solid by -c_i (array axes are
        # ([z,] y, x), velocity components (x, y[, z]))
        shifts = tuple(-int(lat.c[i, k]) for k in range(lat.D))[::-1]
        solid_shift = torch.roll(solid, shifts, tuple(range(ndim)))
        for axis, s in enumerate(shifts):
            if s == 0 or (axis == ndim - 1 and problem.periodic_x):
                continue
            idx = [slice(None)] * ndim
            idx[axis] = 0 if s > 0 else -1
            solid_shift[tuple(idx)] = False
        masks.append((i, fluid & solid_shift))
    return masks


def momentum_exchange(problem: Problem, f_post: torch.Tensor,
                      solid: torch.Tensor, masks: list | None = None,
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """Force vector (D,) on the obstacle from post-collision populations;
    `masks` are shifted_masks(problem, solid), built here if not given.
    The sums run in float64 and the vector comes back in `dtype` (default
    f_post's): a
    float32 sum over a large obstacle's links rounds by the order of its
    terms (at 4096x2048 the lift of the symmetric start came out 1e-5 and
    -2e-6 from two orders), so a mesh's sum over its shards
    (parallel/sharded_step.Diagnostics) meets one device's only in
    float64."""
    lat = problem.lattice
    if masks is None:
        masks = shifted_masks(problem, solid)
    comps = []
    for d in range(lat.D):
        total = torch.zeros((), dtype=torch.float64, device=f_post.device)
        for i, link in masks:
            cid = int(lat.c[i, d])
            if cid == 0:
                continue
            contrib = torch.sum(torch.where(link, f_post[i], 0.0),
                                dtype=torch.float64)
            total = total + 2.0 * cid * contrib
        comps.append(total)
    return torch.stack(comps).to(dtype or f_post.dtype)


def force_coefficients(problem: Problem,
                       force: np.ndarray) -> tuple[float, float]:
    """C_D, C_L from force[0] and force[1]. 2-D: the reference's
    normalization q = ½ ρ U² D per unit span, D = 2 * int(cylinder_radius *
    ny) cells. 3-D (sphere): q = ½ ρ U² π r², the frontal area, as in
    tpulbm."""
    p = problem.params
    U = p.inlet_velocity
    r = float(p.get_cylinder_radius_cells())
    area = np.pi * r * r if problem.lattice.D == 3 else 2.0 * r
    q = 0.5 * 1.0 * U * U * area
    if q <= 1e-12:
        return 0.0, 0.0
    return float(force[0] / q), float(force[1] / q)


def forces_fn(problem: Problem, device, solid=None, masks=None,
              dtype=None):
    """f -> force vector (D,) on `device`: collide (solid cells skip it
    under the bounce-back obstacle, as in the step), then momentum exchange
    (the reference's call point: post-collision, pre-streaming). The link
    masks are built once here, not at every call. On a mesh, `solid` and
    `masks` are a shard's cut of the global ones and `dtype` float64, the
    partial sums a mesh adds up (parallel/sharded_step.Diagnostics)."""
    if solid is None:
        solid = torch.as_tensor(problem.solid, device=device)
    if masks is None:
        masks = shifted_masks(problem, solid)

    def fn(f: torch.Tensor) -> torch.Tensor:
        f_post = step_torch.collide_block(problem, f, solid)
        return momentum_exchange(problem, f_post, solid, masks, dtype=dtype)

    return fn
