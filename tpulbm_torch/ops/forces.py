"""Momentum-exchange force on the obstacle.

Port of tpulbm/ops/forces.py: the cut-link form of the Bouzidi obstacle
(bouzidi_momentum_exchange) and, for the voxel obstacle,

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


def bouzidi_momentum_exchange(problem: Problem, f_post: torch.Tensor,
                              table: torch.Tensor, inner=None,
                              dtype: torch.dtype | None = None
                              ) -> torch.Tensor:
    """Force vector (D,) on a Bouzidi obstacle: tpulbm's
    bouzidi_momentum_exchange_fn (forces.py:83-126), the momentum exchange
    over the cut links F = Σ_links c_i (f̂_i + f_j^new), where f_j^new is
    the population the closure writes (ops/bouzidi.py; at q = 1/2 it is
    f̂_i, the voxel form 2 c_i f̂_i). Each link's term is computed in
    f_post's dtype, as tpulbm computes it, and summed in float64, as
    momentum_exchange sums (so a mesh's partial sums add up to one
    device's). The q < 1/2 term reads f̂_i at the upstream node x_f + c_j,
    a roll of f_post: on a shard, f_post and `table` are its block padded
    by one cell of its neighbours' post-collision populations and table,
    and `inner` (slices of the spatial axes) the block itself, over which
    the links are summed. The vector comes back in `dtype` (default
    f_post's)."""
    lat = problem.lattice
    opp = lat.opposite
    dt = f_post.dtype
    moving = table.shape[0] == 2 * lat.Q
    dims = tuple(range(f_post.dim() - 1))
    comps = [torch.zeros((), dtype=torch.float64, device=f_post.device)
             for _ in range(lat.D)]
    for j in range(1, lat.Q):
        i = int(opp[j])
        qj = table[j].to(dt)
        has = qj >= 0.0
        ltm = qj < 0.5
        inv2q = 1.0 / (2.0 * torch.clamp_min(qj, 0.5))
        a = torch.where(ltm, 2.0 * qj, inv2q)
        b = torch.where(ltm, 1.0 - 2.0 * qj, 0.0)
        cc = torch.where(ltm, 0.0, 1.0 - inv2q)
        fi = f_post[i]
        # the upstream node x_f + c_j; where b > 0 link_q made sure it is
        # fluid in the domain, so a wrapped value is multiplied by 0
        shifts = tuple(-int(v) for v in lat.c[j])[::-1]
        fup = torch.roll(fi, shifts, dims)
        fj_new = a * fi + b * fup + cc * f_post[j]
        if moving:
            tw = table[lat.Q + j].to(dt)
            fj_new = fj_new + torch.where(ltm, 6.0 * tw, (6.0 * inv2q) * tw)
        flux = torch.where(has, fi + fj_new, 0.0)
        if inner is not None:
            flux = flux[inner]
        total = torch.sum(flux, dtype=torch.float64)
        for d in range(lat.D):
            cid = int(lat.c[i, d])
            if cid:
                comps[d] = comps[d] + cid * total
    return torch.stack(comps).to(dtype or dt)


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
              dtype=None, table=None, inner=None):
    """f -> force vector (D,) on `device`: collide (solid cells skip it
    under the bounce-back obstacle, as in the step), then momentum exchange
    (the reference's call point: post-collision, pre-streaming); under the
    Bouzidi obstacle the cut-link form (bouzidi_momentum_exchange) on the
    link table, `table` or the whole grid's. The link masks are built once
    here, not at every call. On a mesh, `solid` and `masks` are a shard's
    cut of the global ones and `dtype` float64, the partial sums a mesh
    adds up (parallel/sharded_step.Diagnostics); under the Bouzidi
    obstacle f is the shard's block padded by one cell, `table` its cut of
    the link table and `inner` the block."""
    if problem.obstacle_bc == "bouzidi":
        if table is None:
            from .bouzidi import device_table
            table = device_table(problem, device)

        def fn_bz(f: torch.Tensor) -> torch.Tensor:
            f_post = step_torch.collide_block(problem, f)
            return bouzidi_momentum_exchange(problem, f_post, table, inner,
                                             dtype=dtype)

        return fn_bz
    if solid is None:
        solid = torch.as_tensor(problem.solid, device=device)
    if masks is None:
        masks = shifted_masks(problem, solid)

    def fn(f: torch.Tensor) -> torch.Tensor:
        f_post = step_torch.collide_block(problem, f, solid)
        return momentum_exchange(problem, f_post, solid, masks, dtype=dtype)

    return fn
