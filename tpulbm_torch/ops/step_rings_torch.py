"""The plain PyTorch step of one shard of a mesh: the plain version of the
ring kernels and the plain tier (--backend jax) on a mesh.

Port of tpulbm/ops/step_jax.py::make_local_step_padded for D2Q9. A shard's
block with its rings around it (parallel/halo.py) is a padded block whose
cells carry their global coordinates: step_torch.make_step_rolled, given
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
                     solid_pad: torch.Tensor | None, device):
    """step(fpad) -> fpad': one step of the padded block (Q, *padded_shape)
    whose cell [0, 0] is the global cell `origin` (y, x):
    step_torch.make_step_rolled on the block's global coordinates.
    solid_pad: the block's bool solid mask, or None without an obstacle.
    The cells of a ring `k` cells deep come out right where the input is
    right `k + 1` cells deep (the plain step of a shard: tpulbm's
    make_local_step_padded writes only the centre, with a 1-cell ring)."""
    p = problem.params
    y0, x0 = origin
    nyp, nxp = padded_shape
    cd = {"yy": (y0 + torch.arange(nyp, device=device)).reshape(nyp, 1),
          "xx": (x0 + torch.arange(nxp, device=device)).reshape(1, nxp),
          "ny": p.ny, "nx": p.nx, "solid": solid_pad}
    return step_torch.make_step_rolled(problem, device, cd)


def assemble(f: torch.Tensor, rb: torch.Tensor, rt: torch.Tensor,
             rl: torch.Tensor | None, rr: torch.Tensor | None,
             depth: int, periodic_x: bool, eq_ring) -> torch.Tensor:
    """The padded block (Q, nyl + 2 depth, nxl + 2 depth) of f and its
    rings. Without x rings (rl, rr None: the block spans every column, rb
    and rt are nxl wide) the x rings are the block's own other edge under
    a periodic x and the frozen ghost equilibrium otherwise, as
    halo.ring_cols gives them on one x shard."""
    if rl is None:
        if periodic_x:
            rl, rr = f[..., -depth:], f[..., :depth]
            rb = torch.cat([rb[..., -depth:], rb, rb[..., :depth]], dim=-1)
            rt = torch.cat([rt[..., -depth:], rt, rt[..., :depth]], dim=-1)
        else:
            eq = torch.as_tensor(eq_ring, dtype=f.dtype,
                                 device=f.device).reshape(-1, 1, 1)
            rl = rr = eq.expand(f.shape[0], f.shape[1], depth)
            side = eq.expand(f.shape[0], depth, depth)
            rb = torch.cat([side, rb, side], dim=-1)
            rt = torch.cat([side, rt, side], dim=-1)
    return torch.cat([rb, torch.cat([rl, f, rr], dim=-1), rt], dim=-2)


def make_ring_step(problem: Problem, origin: tuple[int, int],
                   local_shape: tuple[int, int], depth: int,
                   solid_pad: torch.Tensor | None, device):
    """step(f, rb, rt, rl, rr) -> f': `depth` steps of the shard whose
    block (Q, *local_shape) starts at the global cell `origin` (y, x), from
    its rings `depth` cells deep (rl, rr None where the block spans every
    column); solid_pad is its solid mask padded by `depth`, or None. The
    plain version of the ring kernels (ops/step_cuda.py)."""
    nyl, nxl = local_shape
    y0, x0 = origin
    one = make_step_padded(problem, (y0 - depth, x0 - depth),
                           (nyl + 2 * depth, nxl + 2 * depth), solid_pad,
                           device)
    eq_ring = problem.ghost_ring_values()

    def step(f, rb, rt, rl=None, rr=None) -> torch.Tensor:
        fpad = assemble(f, rb, rt, rl, rr, depth, problem.periodic_x,
                        eq_ring)
        for _ in range(depth):
            fpad = one(fpad)
        return fpad[:, depth:depth + nyl, depth:depth + nxl].contiguous()

    return step
