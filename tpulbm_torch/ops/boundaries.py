"""Boundary conditions as masked per-population ("plane") updates.

Port of tpulbm/ops/boundaries.py for the BC stacks of the 2-D cylinder,
the body-forced channel, the lid-driven cavity, the 3-D sphere in a duct
and the 3-D duct, the Bouzidi curved wall (ops/bouzidi.py) and the
thermal scalar's Dirichlet wall. Every BC is a `torch.where` over
coordinate masks on a mutable list of Q planes, applied
in the reference order (y walls with the moving lid, z walls, x walls with
the cavity corners, inlet, outlet, the optional clean Zou-He corners,
obstacle), so the read-after-write chains at edge and corner cells carry
over: the inlet's Zou-He reads f6 after the bottom wall rewrote it, a z
wall reads what a y wall rewrote, and the zero-gradient outlet copies its
neighbour column after the walls and before the obstacle.

D2Q9 index convention:
    0:(0,0) 1:(1,0) 2:(0,1) 3:(-1,0) 4:(0,-1) 5:(1,1) 6:(-1,1) 7:(-1,-1) 8:(1,-1)
"""
from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice
from ..models.base import Problem
from .. import physics


def _not_solid(mask, solid):
    return mask if solid is None else mask & ~solid


def apply_walls(lat: Lattice, planes: list, wall_mask, axis_component: int,
                sign: int, solid) -> None:
    """Bounce-back at a flat wall: every direction i whose velocity component
    along `axis_component` has the given sign takes f_opposite(i). D2Q9
    bottom (sign=+1 on y): f2<-f4, f5<-f7, f6<-f8; top (sign=-1):
    f4<-f2, f7<-f5, f8<-f6."""
    m = _not_solid(wall_mask, solid)
    opp = lat.opposite
    for i in range(lat.Q):
        if int(np.sign(lat.c[i, axis_component])) == sign:
            planes[i] = torch.where(m, planes[int(opp[i])], planes[i])


def apply_moving_wall(lat: Lattice, planes: list, wall_mask,
                      axis_component: int, sign: int,
                      u_wall: tuple[float, ...], solid) -> None:
    """Bounce-back at a flat wall moving tangentially with u_wall (the
    cavity's lid): every direction i pointing into the domain takes
    f_opp(i) + 6 w_i rho_w (c_i·u_wall), with the wall density rho_w from
    the known populations only, Σ_{c·n=0} f + 2 Σ_{outgoing} f (summed in
    index order), so that the closed box stays degree-1 homogeneous in f.
    With u_wall = 0 this is apply_walls."""
    m = _not_solid(wall_mask, solid)
    opp = lat.opposite
    rho_w = None
    for i in range(lat.Q):
        s = int(np.sign(lat.c[i, axis_component]))
        if s == sign:
            continue                      # unknown inward population
        term = planes[i] if s == 0 else 2.0 * planes[i]
        rho_w = term if rho_w is None else rho_w + term
    uw = np.zeros(lat.D)
    uw[:len(u_wall)] = u_wall
    snap = list(planes)
    for i in range(lat.Q):
        if int(np.sign(lat.c[i, axis_component])) == sign:
            cu = float(lat.c[i].astype(np.float64) @ uw)
            val = snap[int(opp[i])]
            if cu:
                val = val + (6.0 * float(lat.w[i]) * cu) * rho_w
            planes[i] = torch.where(m, val, planes[i])


def apply_thermal_wall(lat_g: Lattice, planes_g: list, wall_mask,
                       axis_component: int, sign: int, t_wall: float,
                       solid) -> None:
    """Fixed-temperature (Dirichlet) wall for the thermal scalar:
    anti-bounce-back. Every direction i pointing into the domain (the sign
    of its `axis_component` velocity is `sign`) takes

        g_i <- (w_i + w_opp(i)) · T_wall − g_opp(i)

    from the planes as they stand on entry, so that the half-link
    temperature between g_i and g_opp is T_wall."""
    m = _not_solid(wall_mask, solid)
    opp = lat_g.opposite
    snap = list(planes_g)
    for i in range(lat_g.Q):
        if int(np.sign(lat_g.c[i, axis_component])) == sign:
            val = (float(lat_g.w[i] + lat_g.w[int(opp[i])]) * t_wall
                   - snap[int(opp[i])])
            planes_g[i] = torch.where(m, val, planes_g[i])


def apply_zou_he_inlet(planes: list, inlet_mask, u_in: float, solid) -> None:
    """Zou-He velocity inlet on the x=0 column.

    rho_bc = (f0+f2+f4 + 2(f3+f6+f7)) / (1 - u_in)
    f1 = f3 + 2/3 rho u;  f5 = f7 - (f2-f4)/2 + rho u/6;  f8 = f6 + (f2-f4)/2 + rho u/6
    """
    m = _not_solid(inlet_mask, solid)
    p = planes
    rho_bc = (p[0] + p[2] + p[4] + 2.0 * (p[3] + p[6] + p[7])) / (1.0 - u_in)
    ru = rho_bc * u_in
    half_trans = 0.5 * (p[2] - p[4])
    planes[1] = torch.where(m, p[3] + (2.0 / 3.0) * ru, p[1])
    new5 = p[7] - half_trans + (1.0 / 6.0) * ru
    new8 = p[6] + half_trans + (1.0 / 6.0) * ru
    planes[5] = torch.where(m, new5, p[5])
    planes[8] = torch.where(m, new8, p[8])


def apply_zou_he_outlet(planes: list, outlet_mask, solid) -> None:
    """Zou-He pressure outlet (rho=1) on the x=nx-1 column.

    u_out = -1 + (f0+f2+f4 + 2(f1+f5+f8)) / rho_out
    f3 = f1 - 2/3 u; f6 = f8 - (f2-f4)/2 - u/6; f7 = f5 + (f2-f4)/2 - u/6
    """
    m = _not_solid(outlet_mask, solid)
    p = planes
    u_out = -1.0 + (p[0] + p[2] + p[4] + 2.0 * (p[1] + p[5] + p[8]))
    half_trans = 0.5 * (p[2] - p[4])
    new3 = p[1] - (2.0 / 3.0) * u_out
    new6 = p[8] - half_trans - (1.0 / 6.0) * u_out
    new7 = p[5] + half_trans - (1.0 / 6.0) * u_out
    planes[3] = torch.where(m, new3, p[3])
    planes[6] = torch.where(m, new6, p[6])
    planes[7] = torch.where(m, new7, p[7])


def apply_equilibrium_inlet(lat: Lattice, planes: list, inlet_mask,
                            eq_in: np.ndarray, solid) -> None:
    """Equilibrium inlet on the x=0 plane (3-D model): every population takes
    the frozen inlet equilibrium."""
    m = _not_solid(inlet_mask, solid)
    for i in range(lat.Q):
        planes[i] = torch.where(m, float(eq_in[i]), planes[i])


def apply_zero_gradient_outlet(lat: Lattice, planes: list, outlet_mask,
                               solid) -> None:
    """Zero-gradient outlet on the x=nx-1 plane (3-D model): every population
    copies the x-1 neighbour as it stands at this point of the stack."""
    m = _not_solid(outlet_mask, solid)
    for i in range(lat.Q):
        shifted = torch.roll(planes[i], 1, dims=-1)  # value from x-1
        planes[i] = torch.where(m, shifted, planes[i])


def apply_zou_he_corners(planes: list, yy, xx, ny: int, nx: int,
                         solid) -> None:
    """Clean corner closure (Zou & He 1997 corner nodes) at the four
    wall∩inlet/outlet cells, the opt-in alternative to the reference's
    emergent corner chain (zou_he_corners="clean").

    Each corner enforces u = v = 0: the three wall-tangential unknowns
    bounce back and the remaining diagonal pair splits the density residual
    equally. rho* is the density of the node one row inward on the same
    column at the inlet corners (after the inlet's update, before the
    corners') and the outlet's fixed rho = 1 at the outlet corners."""
    p = list(planes)
    rho = sum(p)
    rho_above = torch.roll(rho, -1, dims=-2)   # value at y+1
    rho_below = torch.roll(rho, 1, dims=-2)    # value at y-1
    bl = (yy == 0) & (xx == 0)
    br = (yy == 0) & (xx == nx - 1)
    tl = (yy == ny - 1) & (xx == 0)
    tr = (yy == ny - 1) & (xx == nx - 1)
    # (dst <- src) bounce-backs; the leftover diagonal pair gets the residual
    one = torch.ones((), dtype=rho.dtype, device=rho.device)
    _set_corner(planes, p, bl, [(1, 3), (2, 4), (5, 7)], (6, 8), rho_above,
                solid)
    _set_corner(planes, p, br, [(3, 1), (2, 4), (6, 8)], (5, 7), one, solid)
    _set_corner(planes, p, tl, [(1, 3), (4, 2), (8, 6)], (5, 7), rho_below,
                solid)
    _set_corner(planes, p, tr, [(3, 1), (4, 2), (7, 5)], (6, 8), one, solid)


def _set_corner(planes: list, p: list, mask, assigns, pair, rho_star,
                solid) -> None:
    """One corner node of a closure: the (dst <- src) bounce-backs, and the
    diagonal pair takes the residual 0.5 (rho* - p0) - (known - p0)."""
    m = _not_solid(mask, solid)
    known = sum(p[i] for i in ([0] + [src for _, src in assigns]))
    resid = 0.5 * (rho_star - p[0]) - (known - p[0])
    for dst, src in assigns:
        planes[dst] = torch.where(m, p[src], planes[dst])
    for i in pair:
        planes[i] = torch.where(m, resid, planes[i])


def apply_cavity_corners(planes: list, yy, xx, ny: int, nx: int,
                         solid) -> None:
    """Corner closure of a wall-bounded box (the cavity), after the wall
    passes: at a wall∩wall corner the two edge-diagonal populations are
    mutually unknown, so the plain reflections would copy ghost values into
    each other and drain the box. The three unknowns with known opposites
    bounce back and the diagonal pair splits the density residual against
    rho* of the diagonally inward neighbour, as the Zou-He corner nodes do;
    the rest state is a fixed point. The lid's momentum term is not applied
    at the top corners."""
    p = list(planes)
    rho = sum(p)
    # diagonally inward neighbour's density per corner
    rho_ne = torch.roll(rho, (-1, -1), dims=(-2, -1))   # value at (y+1, x+1)
    rho_nw = torch.roll(rho, (-1, 1), dims=(-2, -1))    # value at (y+1, x-1)
    rho_se = torch.roll(rho, (1, -1), dims=(-2, -1))    # value at (y-1, x+1)
    rho_sw = torch.roll(rho, (1, 1), dims=(-2, -1))     # value at (y-1, x-1)
    bl = (yy == 0) & (xx == 0)
    br = (yy == 0) & (xx == nx - 1)
    tl = (yy == ny - 1) & (xx == 0)
    tr = (yy == ny - 1) & (xx == nx - 1)
    _set_corner(planes, p, bl, [(1, 3), (2, 4), (5, 7)], (6, 8), rho_ne, solid)
    _set_corner(planes, p, br, [(3, 1), (2, 4), (6, 8)], (5, 7), rho_nw, solid)
    _set_corner(planes, p, tl, [(1, 3), (4, 2), (8, 6)], (5, 7), rho_se, solid)
    _set_corner(planes, p, tr, [(3, 1), (4, 2), (7, 5)], (6, 8), rho_sw, solid)


def apply_obstacle(lat: Lattice, planes: list, solid, mode: str,
                   rest: np.ndarray) -> None:
    """The obstacle rule at solid cells, after every edge BC.

    "equilibrium" (reference parity): pin solid cells to the rest
    equilibrium w_i. The reference's collision skips solids and its
    streaming reads cells that keep their initial rest equilibrium, so
    fluid neighbours always pull w_i from the cylinder.

    "bounce_back" (full-way): solid cells store the populations streamed in
    this step, reversed; the collision skips them (collide_block), so the
    next step's pull hands them back to the fluid."""
    if solid is None:
        return
    if mode == "equilibrium":
        for i in range(lat.Q):
            planes[i] = torch.where(solid, float(rest[i]), planes[i])
    elif mode == "bounce_back":
        snapshot = list(planes)
        for i in range(lat.Q):
            planes[i] = torch.where(solid, snapshot[int(lat.opposite[i])],
                                    planes[i])
    else:
        raise ValueError(f"unknown obstacle_bc mode: {mode}")


def apply_all(problem: Problem, planes: list, coords: dict) -> list:
    """Apply the problem's BC stack in reference order.

    `coords` holds broadcastable global-coordinate tensors 'yy' and 'xx'
    (and 'zz' in 3-D), the extents 'ny' and 'nx' (and 'nz'), and 'solid'
    (bool mask or None); under the Bouzidi obstacle also 'f_post' (the
    post-collision planes) and 'bz_q' (the link table of the block,
    ops/bouzidi.py)."""
    lat = problem.lattice
    solid = coords.get("solid")
    yy, xx = coords["yy"], coords["xx"]
    ny, nx = coords["ny"], coords["nx"]
    if problem.walls_y:
        apply_walls(lat, planes, yy == 0, 1, +1, solid)
        if problem.lid_u:
            apply_moving_wall(lat, planes, yy == ny - 1, 1, -1,
                              (problem.lid_u,), solid)
        else:
            apply_walls(lat, planes, yy == ny - 1, 1, -1, solid)
    if problem.walls_z and lat.D == 3:
        zz, nz = coords["zz"], coords["nz"]
        apply_walls(lat, planes, zz == 0, 2, +1, solid)
        apply_walls(lat, planes, zz == nz - 1, 2, -1, solid)
    if problem.walls_x:
        apply_walls(lat, planes, xx == 0, 0, +1, solid)
        apply_walls(lat, planes, xx == nx - 1, 0, -1, solid)
        if problem.walls_y and lat.D == 2:
            apply_cavity_corners(planes, yy, xx, ny, nx, solid)
    if problem.inlet_zou_he:
        apply_zou_he_inlet(planes, xx == 0, problem.init_u[0], solid)
    if problem.inlet_equilibrium:
        apply_equilibrium_inlet(lat, planes, xx == 0,
                                problem.ghost_ring_values(), solid)
    if problem.outlet_zou_he:
        apply_zou_he_outlet(planes, xx == nx - 1, solid)
    if problem.outlet_zero_grad:
        apply_zero_gradient_outlet(lat, planes, xx == nx - 1, solid)
    if problem.clean_corners and lat.D == 2:
        apply_zou_he_corners(planes, yy, xx, ny, nx, solid)
    rest = physics.rest_equilibrium(lat, problem.dtype)
    if problem.obstacle_bc == "bouzidi" and solid is not None:
        # the curved-wall rewrite of the cut links (the post-collision
        # planes and the link table the step put in coords), then the
        # rest-equilibrium pin of the solid cells
        from . import bouzidi
        bouzidi.apply_bouzidi(lat, planes, coords["f_post"], coords["bz_q"],
                              active=bouzidi.active_directions(problem))
        apply_obstacle(lat, planes, solid, "equilibrium", rest)
    else:
        apply_obstacle(lat, planes, solid, problem.obstacle_bc, rest)
    return planes
