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

Across several processes (parallel/multihost.py) a grid holds None for
another process's shard, the caller passes the grid's mesh, whose map
alone says which process holds each shard, and the rings are built for
this process's shards only. Each ring is a move of a piece of a
neighbour's block, planned once per mesh, depth and periodicity (_plan):
a local neighbour's piece is copied as above, a remote one is a message
(multihost.send_recv, one torch.distributed.batch_isend_irecv a phase,
every process listing the moves in the same order). A physical edge's
frozen equilibrium stays local. The two phases of an x-cut mesh (columns,
then rows across the received columns) are two batches, so a ring is
bitwise the ring one process builds.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

Grid = list  # [[Tensor | None, ...] per mesh row]: (Q, nyl, nxl) per shard


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


def _owners(shards: Grid, mesh) -> tuple:
    """(the process of each shard, this process's index): the mesh's map;
    without a mesh, this process holds every shard of the grid."""
    if mesh is not None:
        return mesh.processes, mesh.rank
    if any(b is None for row in shards for b in row):
        raise ValueError("a grid of several processes' shards needs its "
                         "mesh (mesh=...)")
    my, mx = _shape(shards)
    return ((0,) * mx,) * my, 0


def _takes(kind: str, depth: int) -> tuple:
    """The pieces a phase moves, (to the low side's ring, to the high
    side's): "rows" the source block's top or bottom rows (rb, rt), "cols"
    its last or first columns (rl, rr), "ext" the (bottom, top) rows
    ring_rows_ext builds across a block's columns."""
    if kind == "rows":
        return (lambda b: b[..., b.shape[-2] - depth:, :],
                lambda b: b[..., 0:depth, :])
    if kind == "cols":
        return (lambda b: b[..., b.shape[-1] - depth:],
                lambda b: b[..., 0:depth])
    return (lambda e: e[1], lambda e: e[0])


@functools.lru_cache(maxsize=256)
def _plan(kind: str, owners: tuple, rank: int, depth: int,
          periodic: bool) -> tuple:
    """The moves of one phase that this process takes part in, built once
    per phase kind, process map, depth and periodicity (not at every
    exchange): (key, source cell, destination cell, take, role, peer,
    tag). key (side, iy, ix), side 0 the ring from the low neighbour (rb
    or rl), 1 from the high one (rt or rr); role "copy" where this process
    holds both shards, else "send" or "recv" with the other process as
    peer; tag the move's place in the phase's order, the same on every
    process."""
    my, mx = len(owners), len(owners[0])
    low, high = _takes(kind, depth)
    moves = []
    for iy in range(my):
        for ix in range(mx):
            if kind == "cols":
                lo, hi = (iy, (ix - 1) % mx), (iy, (ix + 1) % mx)
                first, last = ix == 0, ix == mx - 1
            else:
                lo, hi = ((iy - 1) % my, ix), ((iy + 1) % my, ix)
                first, last = iy == 0, iy == my - 1
            if periodic or not first:
                moves.append(((0, iy, ix), lo, (iy, ix), low))
            if periodic or not last:
                moves.append(((1, iy, ix), hi, (iy, ix), high))
    plan = []
    for tag, (key, (sy, sx), (dy, dx), take) in enumerate(moves):
        src, dst = owners[sy][sx], owners[dy][dx]
        if dst == rank:
            role, peer = ("copy", rank) if src == rank else ("recv", src)
        elif src == rank:
            role, peer = "send", dst
        else:
            continue
        plan.append((key, (sy, sx), (dy, dx), take, role, peer, tag))
    return tuple(plan)


def _phase(kind: str, src: Grid, dst: Grid, mesh, depth: int,
           periodic: bool) -> dict:
    """{key: piece on its destination's device} of every ring of the
    phase whose shard this process holds: a local pair's piece copied, the
    remote ones received in one multihost.send_recv (none in one process).
    src's entries are blocks or, for "ext", pairs of a block's edge rows;
    each has the shape of the others, so a received piece's shape is
    take(a local entry)'s."""
    owners, rank = _owners(dst, mesh)
    out, ops, keys = {}, [], []
    for key, (sy, sx), (dy, dx), take, role, peer, tag in _plan(
            kind, owners, rank, depth, periodic):
        if role == "copy":
            out[key] = _send(take(src[sy][sx]), dst[dy][dx].device)
        elif role == "send":
            ops.append(("send", take(src[sy][sx]), peer, tag))
        else:
            piece = take(next(e for row in src for e in row if e is not None))
            ops.append(("recv", (piece.shape, piece.dtype,
                                 dst[dy][dx].device), peer, tag))
            keys.append(key)
    from . import multihost
    out.update(zip(keys, multihost.send_recv(ops)))
    return out


def ring_rows(shards: Grid, *, eq_ring: np.ndarray, depth: int = 1,
              periodic_y: bool = False, mesh=None) -> Grid:
    """y-halo rows for the full-width kernels: grid of (rb, rt), each
    (Q, depth, nxl), the neighbour shards' edge rows (rb from the shard
    below, rt from the one above); frozen ghost equilibrium at physical y
    edges, the wrapped neighbour under periodic_y. mesh_x must be 1
    (x-sharded meshes use ring_cols + ring_rows_ext). mesh: the grid's
    (parallel/mesh.py), which says which process holds each shard; needed
    where the grid spans processes."""
    my, mx = _shape(shards)
    if mx != 1:
        raise ValueError("ring_rows requires mesh_x == 1")
    got = _phase("rows", shards, shards, mesh, depth, periodic_y)
    out = []
    for iy in range(my):
        f = shards[iy][0]
        if f is None:
            out.append([None])
            continue
        eq = None
        if not periodic_y and (iy == 0 or iy == my - 1):
            eq = _eq_block(eq_ring, f, f.shape[:-2] + (depth, f.shape[-1]))
        out.append([(got.get((0, iy, 0), eq), got.get((1, iy, 0), eq))])
    return out


def ring_cols(shards: Grid, *, eq_ring: np.ndarray, depth: int,
              periodic_x: bool, mesh=None) -> Grid:
    """x-halo columns for the x-tiled kernels: grid of (rl, rr), each
    (Q, nyl, depth) raw pre-collision populations, rl the left
    neighbour's last columns and rr the right neighbour's first ones;
    frozen ghost equilibrium at physical x edges (the kernels' ghost rule
    owns those columns), the wrapped neighbour (the shard's own other edge
    on one x shard) under periodic_x."""
    my, mx = _shape(shards)
    got = _phase("cols", shards, shards, mesh, depth, periodic_x)
    out = []
    for iy in range(my):
        row = []
        for ix in range(mx):
            f = shards[iy][ix]
            if f is None:
                row.append(None)
                continue
            eq = None
            if not periodic_x and (ix == 0 or ix == mx - 1):
                eq = _eq_block(eq_ring, f, f.shape[:-1] + (depth,))
            row.append((got.get((0, iy, ix), eq), got.get((1, iy, ix), eq)))
        out.append(row)
    return out


def ring_rows_ext(shards: Grid, cols: Grid, *, eq_ring: np.ndarray,
                  depth: int, periodic_y: bool = False, mesh=None) -> Grid:
    """y-halo rows extended across the x rings: grid of (rb, rt), each
    (Q, depth, nxl + 2H) with H the width of cols' rings (ring_cols).

    The two-phase composition (x columns first, then rows built from the
    block and its columns) fills the corners with the diagonal
    neighbours' data. Physical y edges hold the frozen ghost equilibrium
    across the whole width; periodic_y wraps."""
    my, mx = _shape(shards)
    ext = []
    for iy in range(my):
        row = []
        for ix in range(mx):
            f = shards[iy][ix]
            if f is None:
                row.append(None)
                continue
            rl, rr = cols[iy][ix]
            nyl = f.shape[-2]
            # (bottom, top): the block's edge rows across its columns
            row.append((torch.cat([rl[..., 0:depth, :], f[..., 0:depth, :],
                                   rr[..., 0:depth, :]], dim=-1),
                        torch.cat([rl[..., nyl - depth:, :],
                                   f[..., nyl - depth:, :],
                                   rr[..., nyl - depth:, :]], dim=-1)))
        ext.append(row)
    got = _phase("ext", ext, shards, mesh, depth, periodic_y)
    out = []
    for iy in range(my):
        row = []
        for ix in range(mx):
            f = shards[iy][ix]
            if f is None:
                row.append(None)
                continue
            width = ext[iy][ix][0].shape[-1]
            eq = None
            if not periodic_y and (iy == 0 or iy == my - 1):
                eq = _eq_block(eq_ring, f, f.shape[:-2] + (depth, width))
            row.append((got.get((0, iy, ix), eq), got.get((1, iy, ix), eq)))
        out.append(row)
    return out


def exchange(shards: Grid, *, eq_ring: np.ndarray, depth: int,
             periodic_x: bool, x_rings: bool,
             periodic_y: bool = False, mesh=None) -> Grid:
    """The rings of every shard for a launch at `depth`: grid of
    (rb, rt, rl, rr). x_rings: ring_cols then ring_rows_ext (rb and rt
    nxl + 2 depth wide); else ring_rows (nxl wide) and no x rings (None),
    for blocks that span every column. periodic_y wraps the ring rows.
    mesh: the grid's, where it spans processes (ring_rows)."""
    if not x_rings:
        rows = ring_rows(shards, eq_ring=eq_ring, depth=depth,
                         periodic_y=periodic_y, mesh=mesh)
        return [[None if ring is None else ring + (None, None)
                 for ring in r] for r in rows]
    cols = ring_cols(shards, eq_ring=eq_ring, depth=depth,
                     periodic_x=periodic_x, mesh=mesh)
    rows = ring_rows_ext(shards, cols, eq_ring=eq_ring, depth=depth,
                         periodic_y=periodic_y, mesh=mesh)
    return [[None if cols[iy][ix] is None else rows[iy][ix] + cols[iy][ix]
             for ix in range(len(cols[iy]))] for iy in range(len(cols))]


def pad_block(shards: Grid, *, eq_ring: np.ndarray, depth: int,
              periodic_x: bool, periodic_y: bool = False, mesh=None) -> Grid:
    """Every shard with its rings around it, (Q, nyl + 2 depth,
    nxl + 2 depth): the block a depth-`depth` step of a shard reads."""
    rings = exchange(shards, eq_ring=eq_ring, depth=depth,
                     periodic_x=periodic_x, x_rings=True,
                     periodic_y=periodic_y, mesh=mesh)
    return [[None if ring is None else torch.cat(
        [ring[0], torch.cat([ring[2], shards[iy][ix], ring[3]], dim=-1),
         ring[1]], dim=-2) for ix, ring in enumerate(row)]
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
                 periodic_y: bool = False, mesh=None) -> Grid:
    """Refresh, in place, the 1-wide ring of every padded local block
    (make_padded) of the grid: x columns first, then the rows across the
    full padded width (the corners carry the diagonal neighbours' data);
    returns the grid."""
    centers = [[None if fp is None else fp[..., 1:-1, 1:-1] for fp in row]
               for row in fpads]
    rings = exchange(centers, eq_ring=eq_ring, depth=1,
                     periodic_x=periodic_x, x_rings=True,
                     periodic_y=periodic_y, mesh=mesh)
    for row, ring_row in zip(fpads, rings):
        for fp, ring in zip(row, ring_row):
            if fp is None:
                continue
            rb, rt, rl, rr = ring
            fp[..., 1:-1, 0:1] = rl
            fp[..., 1:-1, -1:] = rr
            fp[..., 0:1, :] = rb
            fp[..., -1:, :] = rt
    return fpads


def pad_mask(solids: Grid, *, periodic_x: bool, depth: int = 1,
             periodic_y: bool = False, mesh=None) -> Grid:
    """Every shard's bool solid mask, (nyl, nxl) or (nz, nyl, nxl), padded
    by `depth` rows and columns with its neighbours' mask values (fluid,
    False, past physical edges): the bounce-back obstacle needs it, as a
    shard skips the collision on halo cells its neighbour holds solid."""
    planes = [[None if s is None else s.to(torch.float32)[None] for s in row]
              for row in solids]
    padded = pad_block(planes, eq_ring=np.zeros(1, np.float32), depth=depth,
                       periodic_x=periodic_x, periodic_y=periodic_y,
                       mesh=mesh)
    return [[None if p is None else p[0] > 0.5 for p in row]
            for row in padded]
