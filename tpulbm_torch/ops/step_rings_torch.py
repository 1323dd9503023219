"""The plain PyTorch step of one shard of a mesh: the plain version of the
ring kernels and the plain tier (--backend jax) on a mesh.

Port of tpulbm/ops/step_jax.py::make_local_step_padded for D2Q9, D3Q19 and
D3Q27. A shard's block with its rings around it (parallel/halo.py) is a
padded block whose cells carry their global coordinates (a 3-D block
keeps all nz planes, z is never cut, so its z roll wraps or edges it as
on one device): step_torch.make_step_rolled, given
those coordinates, steps it as it steps the whole grid, and the ghost
rule and every boundary condition key on the global coordinates, so they
act only on the domain's own edges, never on a shard's edge (tpulbm's
flags mark those edges physical). A step leaves
the block's outermost cells wrong (their pulls leave the padded block);
N steps from rings N cells deep leave the block itself right.
"""
from __future__ import annotations

import torch

from ..models.base import Problem
from . import step_torch


def make_step_padded(problem: Problem, origin: tuple[int, int],
                     padded_shape: tuple[int, int],
                     solid_pad: torch.Tensor | None, device, table=None):
    """step(fpad) -> fpad': one step of the padded block (Q, [nz,]
    *padded_shape) whose row 0, column 0 is the global cell `origin` (y, x):
    step_torch.make_step_rolled on the block's global coordinates.
    solid_pad: the block's bool solid mask, or None without an obstacle.
    Under the Bouzidi obstacle the block reads its cut of the link table,
    rings included: `table`, default bouzidi.table_block's.
    The cells of a ring `k` cells deep come out right where the input is
    right `k + 1` cells deep (the plain step of a shard: tpulbm's
    make_local_step_padded writes only the centre, with a 1-cell ring)."""
    p = problem.params
    y0, x0 = origin
    nyp, nxp = padded_shape
    lead = tuple(problem.spatial_shape[:-2])     # (nz,) in 3-D
    one = (1,) * len(lead)
    cd = {"yy": (y0 + torch.arange(nyp, device=device)).reshape(
              one + (nyp, 1)),
          "xx": (x0 + torch.arange(nxp, device=device)).reshape(
              one + (1, nxp)),
          "ny": p.ny, "nx": p.nx, "solid": solid_pad}
    if lead:
        cd["zz"] = torch.arange(lead[0], device=device).reshape(-1, 1, 1)
        cd["nz"] = lead[0]
    if problem.obstacle_bc == "bouzidi" and solid_pad is not None:
        if table is None:
            from .bouzidi import table_block
            table = table_block(problem, (0,) * len(lead) + (y0, x0),
                                lead + tuple(padded_shape))
        cd["bz_q"] = torch.as_tensor(table, device=device)
    return step_torch.make_step_rolled(problem, device, cd)


def assemble(f: torch.Tensor, rb: torch.Tensor, rt: torch.Tensor,
             rl: torch.Tensor | None, rr: torch.Tensor | None,
             depth: int, periodic_x: bool, eq_ring) -> torch.Tensor:
    """The padded block (Q, [nz,] nyl + 2 depth, nxl + 2 depth) of f and
    its rings. Without x rings (rl, rr None: the block spans every column,
    rb and rt are nxl wide) the x rings are the block's own other edge
    under a periodic x and the frozen ghost equilibrium otherwise, as
    halo.ring_cols gives them on one x shard."""
    if rl is None:
        if periodic_x:
            rl, rr = f[..., -depth:], f[..., :depth]
            rb = torch.cat([rb[..., -depth:], rb, rb[..., :depth]], dim=-1)
            rt = torch.cat([rt[..., -depth:], rt, rt[..., :depth]], dim=-1)
        else:
            eq = torch.as_tensor(eq_ring, dtype=f.dtype,
                                 device=f.device).reshape(
                (-1,) + (1,) * (f.dim() - 1))
            rl = rr = eq.expand(f.shape[:-1] + (depth,))
            side = eq.expand(f.shape[:-2] + (depth, depth))
            rb = torch.cat([side, rb, side], dim=-1)
            rt = torch.cat([side, rt, side], dim=-1)
    return torch.cat([rb, torch.cat([rl, f, rr], dim=-1), rt], dim=-2)


def make_ring_step(problem: Problem, origin: tuple[int, int],
                   local_shape: tuple[int, int], depth: int,
                   solid_pad: torch.Tensor | None, device, table=None):
    """step(f, rb, rt, rl, rr) -> f': `depth` steps of the shard whose
    block (Q, *local_shape), local_shape ([nz,] nyl, nxl), starts at the
    global cell `origin` (y, x), from
    its rings `depth` cells deep (rl, rr None where the block spans every
    column); solid_pad is its solid mask padded by `depth`, or None, and
    `table` its padded cut of the Bouzidi link table (default
    bouzidi.table_block's). The plain version of the ring kernels
    (ops/step_cuda.py)."""
    nyl, nxl = local_shape[-2:]
    y0, x0 = origin
    one = make_step_padded(problem, (y0 - depth, x0 - depth),
                           (nyl + 2 * depth, nxl + 2 * depth), solid_pad,
                           device, table)
    eq_ring = problem.ghost_ring_values()

    def step(f, rb, rt, rl=None, rr=None) -> torch.Tensor:
        fpad = assemble(f, rb, rt, rl, rr, depth, problem.periodic_x,
                        eq_ring)
        for _ in range(depth):
            fpad = one(fpad)
        return fpad[..., depth:depth + nyl, depth:depth + nxl].contiguous()

    return step
