"""Halo ("ghost ring") exchange between the shards of a mesh.

Port of tpulbm/parallel/halo.py. A sharded state is the (my, mx) grid of
local blocks, (Q, nyl, nxl) in 2-D and (Q, nz, nyl, nxl) in 3-D (z is
never cut), shard (iy, ix) on mesh.device(iy, ix) (parallel/mesh.py).
Every ring is rank-generic, as tpulbm's (ring_rows_3d and its kin are
aliases there): rows and columns are the last two axes, and a leading z
axis rides along, so a 3-D ring row holds all nz planes. tpulbm's
`lax.ppermute` becomes a slice of the neighbour's edge copied to this
shard's device: between two
cards PyTorch's copy orders itself after the producing kernel on the
source card's current stream and before later work on the destination
card's current stream (it records and waits on events on both), so the
rings need no synchronize of their own.

At physical domain edges the rings hold the frozen ghost equilibrium
(eq_ring); a periodic axis wraps instead. The rings hold PRE-collision
populations: each shard re-collides its halo cells (tpulbm's design note).
Where tpulbm pads the x rings to its 128-lane width H, the port's rings
are exactly `depth` wide: H is the depth.
"""
from __future__ import annotations

import numpy as np
import torch

Grid = list  # [[Tensor, ...] per mesh row]: (Q, nyl, nxl) per shard


_EQ_BLOCKS: dict = {}


def _eq_block(eq_ring: np.ndarray, like: torch.Tensor,
              shape: tuple[int, ...]) -> torch.Tensor:
    """(Q,) frozen ghost equilibrium broadcast to `shape`, contiguous, on
    like's device and in its dtype. The rings of a physical edge never
    change, so each block is built once and shared (callers only read
    it): a copy from pageable host memory at every exchange would make
    the host wait for the card to drain before each launch."""
    eq = np.asarray(eq_ring)
    key = (eq.tobytes(), eq.dtype.str, like.dtype, like.device, tuple(shape))
    block = _EQ_BLOCKS.get(key)
    if block is None:
        if len(_EQ_BLOCKS) >= 64:
            _EQ_BLOCKS.clear()
        block = torch.as_tensor(eq, dtype=like.dtype, device=like.device)
        block = block.reshape((shape[0],) + (1,) * (len(shape) - 1)).expand(
            shape).contiguous()
        _EQ_BLOCKS[key] = block
    return block


def _send(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """t as a contiguous tensor on `device` (the receiver's)."""
    return t.to(device).contiguous()


def _shape(shards: Grid) -> tuple[int, int]:
    return len(shards), len(shards[0])


def ring_rows(shards: Grid, *, eq_ring: np.ndarray, depth: int = 1,
              periodic_y: bool = False) -> Grid:
    """y-halo rows for the full-width kernels: grid of (rb, rt), each
    (Q, depth, nxl), the neighbour shards' edge rows (rb from the shard
    below, rt from the one above); frozen ghost equilibrium at physical y
    edges, the wrapped neighbour under periodic_y. mesh_x must be 1
    (x-sharded meshes use ring_cols + ring_rows_ext)."""
    my, mx = _shape(shards)
    if mx != 1:
        raise ValueError("ring_rows requires mesh_x == 1")
    out = []
    for iy in range(my):
        f = shards[iy][0]
        eq = None
        if not periodic_y and (iy == 0 or iy == my - 1):
            eq = _eq_block(eq_ring, f, f.shape[:-2] + (depth, f.shape[-1]))
        below = shards[(iy - 1) % my][0]
        above = shards[(iy + 1) % my][0]
        rb = (eq if not periodic_y and iy == 0
              else _send(below[..., below.shape[-2] - depth:, :], f.device))
        rt = (eq if not periodic_y and iy == my - 1
              else _send(above[..., 0:depth, :], f.device))
        out.append([(rb, rt)])
    return out


def ring_cols(shards: Grid, *, eq_ring: np.ndarray, depth: int,
              periodic_x: bool) -> Grid:
    """x-halo columns for the x-tiled kernels: grid of (rl, rr), each
    (Q, nyl, depth) raw pre-collision populations, rl the left
    neighbour's last columns and rr the right neighbour's first ones;
    frozen ghost equilibrium at physical x edges (the kernels' ghost rule
    owns those columns), the wrapped neighbour (the shard's own other edge
    on one x shard) under periodic_x."""
    my, mx = _shape(shards)
    out = []
    for iy in range(my):
        row = []
        for ix in range(mx):
            f = shards[iy][ix]
            nxl = f.shape[-1]
            if not periodic_x and (ix == 0 or ix == mx - 1):
                eq = _eq_block(eq_ring, f, f.shape[:-1] + (depth,))
            west = shards[iy][(ix - 1) % mx]
            east = shards[iy][(ix + 1) % mx]
            rl = (eq if not periodic_x and ix == 0
                  else _send(west[..., nxl - depth:nxl], f.device))
            rr = (eq if not periodic_x and ix == mx - 1
                  else _send(east[..., 0:depth], f.device))
            row.append((rl, rr))
        out.append(row)
    return out


def ring_rows_ext(shards: Grid, cols: Grid, *, eq_ring: np.ndarray,
                  depth: int, periodic_y: bool = False) -> Grid:
    """y-halo rows extended across the x rings: grid of (rb, rt), each
    (Q, depth, nxl + 2H) with H the width of cols' rings (ring_cols).

    The two-phase composition (x columns first, then rows built from the
    block and its columns) fills the corners with the diagonal
    neighbours' data. Physical y edges hold the frozen ghost equilibrium
    across the whole width; periodic_y wraps."""
    my, mx = _shape(shards)
    ext_bottom, ext_top = [], []
    for iy in range(my):
        bot, top = [], []
        for ix in range(mx):
            f = shards[iy][ix]
            rl, rr = cols[iy][ix]
            nyl = f.shape[-2]
            bot.append(torch.cat([rl[..., 0:depth, :], f[..., 0:depth, :],
                                  rr[..., 0:depth, :]], dim=-1))
            top.append(torch.cat([rl[..., nyl - depth:, :],
                                  f[..., nyl - depth:, :],
                                  rr[..., nyl - depth:, :]], dim=-1))
        ext_bottom.append(bot)
        ext_top.append(top)
    out = []
    for iy in range(my):
        row = []
        for ix in range(mx):
            dev = shards[iy][ix].device
            width = ext_top[iy][ix].shape[-1]
            if not periodic_y and (iy == 0 or iy == my - 1):
                f = shards[iy][ix]
                eq = _eq_block(eq_ring, f, f.shape[:-2] + (depth, width))
            rb = (eq if not periodic_y and iy == 0
                  else _send(ext_top[(iy - 1) % my][ix], dev))
            rt = (eq if not periodic_y and iy == my - 1
                  else _send(ext_bottom[(iy + 1) % my][ix], dev))
            row.append((rb, rt))
        out.append(row)
    return out


def exchange(shards: Grid, *, eq_ring: np.ndarray, depth: int,
             periodic_x: bool, x_rings: bool,
             periodic_y: bool = False) -> Grid:
    """The rings of every shard for a launch at `depth`: grid of
    (rb, rt, rl, rr). x_rings: ring_cols then ring_rows_ext (rb and rt
    nxl + 2 depth wide); else ring_rows (nxl wide) and no x rings (None),
    for blocks that span every column. periodic_y wraps the ring rows."""
    if not x_rings:
        rows = ring_rows(shards, eq_ring=eq_ring, depth=depth,
                         periodic_y=periodic_y)
        return [[(rb, rt, None, None) for rb, rt in r] for r in rows]
    cols = ring_cols(shards, eq_ring=eq_ring, depth=depth,
                     periodic_x=periodic_x)
    rows = ring_rows_ext(shards, cols, eq_ring=eq_ring, depth=depth,
                         periodic_y=periodic_y)
    return [[rows[iy][ix] + cols[iy][ix] for ix in range(len(cols[iy]))]
            for iy in range(len(cols))]


def pad_block(shards: Grid, *, eq_ring: np.ndarray, depth: int,
              periodic_x: bool, periodic_y: bool = False) -> Grid:
    """Every shard with its rings around it, (Q, nyl + 2 depth,
    nxl + 2 depth): the block a depth-`depth` step of a shard reads."""
    rings = exchange(shards, eq_ring=eq_ring, depth=depth,
                     periodic_x=periodic_x, x_rings=True,
                     periodic_y=periodic_y)
    return [[torch.cat([rb, torch.cat([rl, shards[iy][ix], rr], dim=-1),
                        rt], dim=-2)
             for ix, (rb, rt, rl, rr) in enumerate(row)]
            for iy, row in enumerate(rings)]


def make_padded(f_local: torch.Tensor, eq_ring: np.ndarray) -> torch.Tensor:
    """A padded local block (Q, [nz,] nyl + 2, nxl + 2): the ring of rows
    and columns pre-filled with the frozen ghost equilibrium and the centre
    f_local (a 3-D block keeps its nz planes: z is never cut, and the
    plain step wraps or edges it as on one device)."""
    shape = f_local.shape
    fpad = _eq_block(eq_ring, f_local,
                     shape[:-2] + (shape[-2] + 2, shape[-1] + 2)).clone()
    fpad[..., 1:-1, 1:-1] = f_local
    return fpad


def refresh_ring(fpads: Grid, *, eq_ring: np.ndarray, periodic_x: bool,
                 periodic_y: bool = False) -> Grid:
    """Refresh, in place, the 1-wide ring of every padded local block
    (make_padded) of the grid: x columns first, then the rows across the
    full padded width (the corners carry the diagonal neighbours' data);
    returns the grid."""
    centers = [[fp[..., 1:-1, 1:-1] for fp in row] for row in fpads]
    rings = exchange(centers, eq_ring=eq_ring, depth=1,
                     periodic_x=periodic_x, x_rings=True,
                     periodic_y=periodic_y)
    for row, ring_row in zip(fpads, rings):
        for fp, (rb, rt, rl, rr) in zip(row, ring_row):
            fp[..., 1:-1, 0:1] = rl
            fp[..., 1:-1, -1:] = rr
            fp[..., 0:1, :] = rb
            fp[..., -1:, :] = rt
    return fpads


def pad_mask(solids: Grid, *, periodic_x: bool, depth: int = 1,
             periodic_y: bool = False) -> Grid:
    """Every shard's bool solid mask, (nyl, nxl) or (nz, nyl, nxl), padded
    by `depth` rows and columns with its neighbours' mask values (fluid,
    False, past physical edges): the bounce-back obstacle needs it, as a
    shard skips the collision on halo cells its neighbour holds solid."""
    planes = [[s.to(torch.float32)[None] for s in row] for row in solids]
    padded = pad_block(planes, eq_ring=np.zeros(1, np.float32), depth=depth,
                       periodic_x=periodic_x, periodic_y=periodic_y)
    return [[p[0] > 0.5 for p in row] for row in padded]
