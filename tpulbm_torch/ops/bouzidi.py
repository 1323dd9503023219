"""Bouzidi interpolated (curved-wall) bounce-back.

Port of tpulbm/ops/bouzidi.py. The voxel mask still decides which cells
are solid; a per-link intersection fraction q moves the wall from the
voxel face to the obstacle's true surface (Bouzidi, Firdaouss &
Lallemand 2001, linear variant). With pull streaming every term of the
closure sits at the boundary cell itself: for the unknown direction j at
a fluid cell x_f (its pull source x_f − c_j is solid), i = opp(j), and
f̂ the post-collision values,

    q < 1/2:  f_j(x_f) ← 2q f̂_i(x_f) + (1−2q) f_i^stream(x_f)
    q ≥ 1/2:  f_j(x_f) ← 1/(2q) f̂_i(x_f) + (1 − 1/(2q)) f̂_j(x_f)

where f_i^stream(x_f) = f̂_i(x_f − c_i) is plane i after the stream. A
moving wall (Problem.obstacle_velocity) adds 6 w_j (c_j · u_w) (q < 1/2)
or (3/q) w_j (c_j · u_w) (q ≥ 1/2) at the intersection point; the scalar
w_j (c_j · u_w) rides a second block of Q planes stacked under q.

The table is built once on the host in NumPy from the problem's analytic
signed distance (Problem.obstacle_sdf), by 40 bisections along each cut
link in float64, and stored in float32, exactly as tpulbm builds it, so
the two packages read byte-identical tables. apply_bouzidi is the select
on torch planes; the CUDA kernels apply the same arithmetic cell by cell
(csrc/d2q9_common.cuh, d3q19_common.cuh).
"""
from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice
from ..models.base import Problem

_BISECT_ITERS = 40      # |interval| = 2^-40: exact to f32 for unit links
_Q_MIN = 1e-4           # clamp: a wall exactly through a fluid node


def _shift_bool(mask: np.ndarray, shift_xy: np.ndarray,
                periodic_x: bool) -> np.ndarray:
    """mask's value at (cell − shift): np.roll by +shift per array axis
    ([z,] y, x order), the wrapped band False on a non-periodic axis
    (out-of-domain neighbours are never links)."""
    ndim = mask.ndim
    comps = [int(v) for v in shift_xy]            # (cx, cy[, cz])
    assert len(comps) == ndim
    per_axis = comps[::-1]                        # ([cz,] cy, cx)
    out = np.roll(mask, per_axis, axis=tuple(range(ndim)))
    for ax, s in enumerate(per_axis):
        if s == 0:
            continue
        if ax == ndim - 1 and periodic_x:
            continue
        sl = [slice(None)] * ndim
        sl[ax] = slice(0, s) if s > 0 else slice(mask.shape[ax] + s, None)
        out[tuple(sl)] = False
    return out


def _link_points(grids: list, cells: tuple, ndim: int) -> np.ndarray:
    """The cells' coordinates in (x, y[, z]) order, float64."""
    return np.stack([grids[ndim - 1][cells], grids[ndim - 2][cells]]
                    + ([grids[0][cells]] if ndim == 3 else []), axis=-1)


def link_q(problem: Problem) -> np.ndarray:
    """(Q, *spatial) float32 table of the wall-intersection fractions:
    q[j, cell] ∈ [1e-4, 1] where the cell is fluid and its pull source
    cell − c_j solid (the wall cuts that link at fraction q from the fluid
    cell along opp(j)), exactly 0.5 where the q < 1/2 branch would need an
    upstream node x_f + c_j that is not in-domain fluid, −1 elsewhere."""
    lat = problem.lattice
    solid = problem.solid
    if solid is None:
        return np.full((lat.Q,) + tuple(problem.spatial_shape), -1.0,
                       np.float32)
    shape = solid.shape
    if len(shape) != lat.D:
        raise ValueError(f"solid mask rank {len(shape)} != lattice "
                         f"dimension {lat.D}")
    q = np.full((lat.Q,) + tuple(shape), -1.0, np.float32)
    sdf = problem.obstacle_sdf
    if sdf is None:
        raise ValueError(
            "obstacle_bc='bouzidi' needs Problem.obstacle_sdf (analytic "
            "surface geometry); this problem's obstacle has none")
    fluid = ~solid
    ndim = solid.ndim
    grids = np.meshgrid(*[np.arange(n, dtype=np.float64) for n in shape],
                        indexing="ij")
    for j in range(lat.Q):
        cj = lat.c[j]
        if not cj.any():
            continue
        mask = fluid & _shift_bool(solid, cj, problem.periodic_x)
        if not mask.any():
            continue
        cells = np.nonzero(mask)
        p0 = _link_points(grids, cells, ndim)
        ci = -cj.astype(np.float64)                # i = opp(j), into the wall
        lo = np.zeros(len(p0[..., 0]))
        hi = np.ones_like(lo)
        for _ in range(_BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            s = np.asarray(sdf(p0 + mid[:, None] * ci[None, :]), np.float64)
            outside = s > 0.0
            lo = np.where(outside, mid, lo)
            hi = np.where(outside, hi, mid)
        qv = np.clip(0.5 * (lo + hi), _Q_MIN, 1.0)
        # the q < 1/2 branch reads f_i^stream, valid only where x_f + c_j is
        # an in-domain fluid node: elsewhere the half-way fallback
        up_fluid = _shift_bool(fluid, -cj, problem.periodic_x)
        qv = np.where((qv < 0.5) & ~up_fluid[cells], 0.5, qv)
        q[j][cells] = qv.astype(np.float32)
    return q


def link_tables(problem: Problem) -> np.ndarray:
    """The table the steps read: link_q's (Q, *spatial), with a second
    block of Q planes of the moving-wall scalars w_j (c_j · u_w) at the
    wall points under it when the obstacle moves (2Q planes then).
    Memoized on the Problem, as tpulbm memoizes it: the step, the kernels
    and the force each need it, and the bisection is done once."""
    cached = getattr(problem, "_bouzidi_tables", None)
    if cached is not None:
        return cached
    table = _link_tables_uncached(problem)
    object.__setattr__(problem, "_bouzidi_tables", table)  # frozen dataclass
    return table


def _link_tables_uncached(problem: Problem) -> np.ndarray:
    q = link_q(problem)
    uw_fn = problem.obstacle_velocity
    if uw_fn is None:
        return q
    lat = problem.lattice
    shape = problem.solid.shape
    ndim = len(shape)
    tw = np.zeros_like(q)
    grids = np.meshgrid(*[np.arange(n, dtype=np.float64) for n in shape],
                        indexing="ij")
    for j in range(lat.Q):
        cells = np.nonzero(q[j] >= 0)
        if len(cells[0]) == 0:
            continue
        p0 = _link_points(grids, cells, ndim)
        ci = -lat.c[j].astype(np.float64)          # into the wall
        xw = p0 + q[j][cells][:, None] * ci[None, :]
        uw = np.asarray(uw_fn(xw), np.float64)     # (n, D)
        cj = lat.c[j].astype(np.float64)
        tw[j][cells] = (float(lat.w[j]) * (uw @ cj)).astype(np.float32)
    return np.concatenate([q, tw], axis=0)


def device_table(problem: Problem, device) -> torch.Tensor:
    """link_tables on `device`, float32, copied there once and memoized on
    the Problem as the host table is: every kernel chunk, the plain step
    and the force sample of a run share it (at 256³ it is 1.27 GB, 2.55
    GB spinning, a copy from pageable host memory of a second or more)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cache = getattr(problem, "_bouzidi_device_tables", None)
    if cache is None:
        cache = {}
        object.__setattr__(problem, "_bouzidi_device_tables", cache)
    table = cache.get(device)
    if table is None:
        table = torch.as_tensor(link_tables(problem), device=device)
        cache[device] = table
    return table


def active_directions(problem: Problem) -> tuple:
    """Whether direction j has any cut link anywhere in the domain, from
    the memoized table: the select skips link-free directions. Memoized
    on the Problem beside the table it was read from (the plain step asks
    every step, and at 256³ the scan reads the whole 1.27 GB table)."""
    table = link_tables(problem)
    cached = getattr(problem, "_bouzidi_active", None)
    if cached is not None and cached[0] is table:
        return cached[1]
    active = tuple(bool((table[j] >= 0).any())
                   for j in range(problem.lattice.Q))
    object.__setattr__(problem, "_bouzidi_active", (table, active))
    return active


def table_block(problem: Problem, origin: tuple[int, ...],
                shape: tuple[int, ...]) -> np.ndarray:
    """(P, *shape) cut of link_tables at the block whose first cell is the
    global `origin` ([z,] y, x), the cells outside the domain −1 in the q
    planes and 0 in the wall planes, a periodic axis wrapped: a shard's
    table, with rings around it where the block reaches past the shard.
    A block that wraps no axis is one slice of the table copied into the
    fill (at 256³ a shard's cut is 80 M floats)."""
    table = link_tables(problem)
    q = problem.lattice.Q
    full = problem.spatial_shape
    periodic = [False] * len(full)
    periodic[-1] = problem.periodic_x
    periodic[-2] = problem.periodic_y
    fill = np.where(np.arange(table.shape[0]) < q, -1.0, 0.0).astype(
        np.float32).reshape((-1,) + (1,) * len(shape))
    if not any(p and (o < 0 or o + n > m)
               for p, o, n, m in zip(periodic, origin, shape, full)):
        block = np.empty((table.shape[0],) + tuple(shape), np.float32)
        block[...] = fill
        src = tuple(slice(max(o, 0), min(o + n, m))
                    for o, n, m in zip(origin, shape, full))
        dst = tuple(slice(s.start - o, s.stop - o)
                    for s, o in zip(src, origin))
        if all(s.stop > s.start for s in src):
            block[(slice(None), *dst)] = table[(slice(None), *src)]
        return block
    idx, inside = [], np.ones(shape, bool)
    for ax, (o, n, m) in enumerate(zip(origin, shape, full)):
        g = o + np.arange(n)
        ok = np.ones(n, bool) if periodic[ax] else (g >= 0) & (g < m)
        bshape = [1] * len(shape)
        bshape[ax] = n
        inside &= ok.reshape(bshape)
        idx.append(np.mod(g, m).reshape(bshape))
    block = table[(slice(None), *idx)]
    return np.ascontiguousarray(np.where(inside[None], block, fill))


def link_cells(table: np.ndarray, q: int) -> np.ndarray:
    """Bool (*spatial) mask of the cells with at least one cut link."""
    return (table[:q] >= 0).any(axis=0)


def apply_bouzidi(lat: Lattice, planes: list, f_post: list,
                  table: torch.Tensor, active: tuple | None = None) -> None:
    """Overwrite every cut-link population of `planes` (post-stream, after
    the edge rules) from the link table (module docstring), in place.
    `f_post` are the post-collision planes at the same cells, `table` the
    (Q or 2Q, *spatial) link table in the planes' dtype; `active`
    (active_directions) skips link-free directions. Every rewrite reads
    the planes as they stood on entry."""
    opp = lat.opposite
    moving = table.shape[0] == 2 * lat.Q
    snap = list(planes)
    for j in range(lat.Q):
        if active is not None and not active[j]:
            continue
        i = int(opp[j])
        qv = table[j]
        lt = (qv >= 0.0) & (qv < 0.5)
        ge = qv >= 0.5
        val_lt = 2.0 * qv * f_post[i] + (1.0 - 2.0 * qv) * snap[i]
        inv2q = 1.0 / (2.0 * torch.clamp_min(qv, 0.5))
        val_ge = inv2q * f_post[i] + (1.0 - inv2q) * f_post[j]
        if moving:
            tw = table[lat.Q + j]
            val_lt = val_lt + 6.0 * tw
            val_ge = val_ge + (6.0 * inv2q) * tw   # = (3/q) w_j c_j·u_w
        planes[j] = torch.where(lt, val_lt,
                                torch.where(ge, val_ge, planes[j]))
