"""The plain PyTorch thermal (double-population) step: the oracle of the
thermal slice and the plain version of the CUDA kernel
csrc/step_thermal.cu.

Port of tpulbm/ops/step_thermal.py (collide_thermal, make_step_thermal,
temperature, nusselt, scalar_variance). One step of the coupled Boussinesq
system on the stacked state s = [f (9 planes); g (5 planes)], (14, ny, nx):

  1. moments: rho, u from f; T = Σ g
  2. collide f: BGK toward equilibrium(rho, u), at the per-cell rate of the
     Smagorinsky closure where problem.smagorinsky > 0, plus the buoyancy
     source 3 w_i c_i,axis · buoyancy·(T − t_ref) on the buoyancy axis
  3. collide g: BGK toward w_i T (1 + 3 c·u) at rate 1/tau_g
  4. pull-stream every plane with torch.roll (x wraps; y pulls across a
     wall read frozen ghost rows: rest equilibrium for f, w_i·T_wall for g)
  5. boundaries, in tpulbm's order: with x walls (the cavity), every plane
     with c_x != 0 at an edge column takes the node's own post-collision
     opposite; then the y walls: inward f planes take the node's own
     post-collision opposite (full-way bounce-back), inward g planes
     (w_i + w_opp)·T_wall − g_opp against the just-streamed opposite
     (boundaries.apply_thermal_wall).

Without y walls (the passive scalar: walls_y off, periodic_y) every pull
wraps and steps 4's ghost rows and 5's wall rules are skipped. Runs in f32
and f64; every expression keeps tpulbm's operation order.

On a mesh of shards (parallel/): make_step_padded_thermal, tpulbm's
make_local_step_padded_thermal, steps a shard's block padded by a
one-cell ring (the plain tier), and make_ring_step_thermal, the plain
version of the kernel's ring build, steps a block from its rings. A
reduction over the grid (nusselt_sums, variance_sums) is summed from
per-shard float64 partials there.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import physics
from ..models.base import Problem
from ..models.rayleigh_benard import effective_height
from . import boundaries


def _thermal_parts(problem: Problem):
    lat, th = problem.lattice, problem.thermal
    if th is None:
        raise ValueError("the thermal step needs problem.thermal")
    return lat, th.lattice, th


def collide_thermal(problem: Problem, s: torch.Tensor) -> torch.Tensor:
    """Post-collision stacked state (pointwise)."""
    lat, lg, th = _thermal_parts(problem)
    Qf = lat.Q
    f, g = s[:Qf], s[Qf:]
    inv_tau = 1.0 / problem.params.tau
    rho, u = physics.moments(lat, f)
    T = torch.sum(g, dim=0)
    feq = physics.equilibrium(lat, rho, u)
    if problem.smagorinsky:
        devs = f - feq
        inv_t = physics.smagorinsky_inv_tau(lat, 1.0 / rho, devs, inv_tau,
                                            problem.smagorinsky)
        f_post = f - inv_t[None] * devs
    else:
        f_post = f - inv_tau * (f - feq)
    if th.buoyancy:
        fy = th.buoyancy * (T - th.t_ref)
        ca = lat.c[:, th.buoyancy_axis]
        planes = []
        for i in range(Qf):
            cia = int(ca[i])
            if cia == 0:
                planes.append(f_post[i])
            else:
                planes.append(f_post[i]
                              + (3.0 * float(lat.w[i]) * cia) * fy)
        f_post = torch.stack(planes)
    geq = physics.thermal_equilibrium(lg, T, u)
    g_post = g - (1.0 / th.tau_g) * (g - geq)
    return torch.cat([f_post, g_post], dim=0)


def ghost_rows(problem: Problem) -> tuple[np.ndarray, np.ndarray]:
    """(bottom, top): the frozen ghost value of each of the 14 planes
    pulled through the y walls: rest equilibrium for f (resting walls),
    w_i·T_wall for g."""
    lat, lg, th = _thermal_parts(problem)
    dt = problem.dtype
    f_ghost = physics.rest_equilibrium(lat, dt)
    bottom = np.concatenate([f_ghost, (lg.w * th.t_bottom).astype(dt)])
    top = np.concatenate([f_ghost, (lg.w * th.t_top).astype(dt)])
    return bottom, top


def check_geometry(problem: Problem) -> None:
    """Raise tpulbm's NotImplementedError for the thermal layouts it
    refuses: x neither periodic nor walled, y neither walled nor
    periodic."""
    if not problem.periodic_x and not problem.walls_x:
        raise NotImplementedError("thermal models are periodic in x or "
                                  "x-walled (side-heated cavity)")
    if not problem.walls_y and not problem.periodic_y:
        raise NotImplementedError("thermal models need y walls or "
                                  "periodic_y")


def make_step_thermal(problem: Problem,
                      device) -> Callable[[torch.Tensor], torch.Tensor]:
    """Oracle step on the stacked state (14, ny, nx) on `device`."""
    lat, lg, th = _thermal_parts(problem)
    check_geometry(problem)
    Qf, Qs = lat.Q, problem.state_q
    ny, nx = problem.spatial_shape
    c_all = np.concatenate([lat.c, lg.c], axis=0)
    opp_all = np.concatenate([lat.opposite, Qf + lg.opposite])
    ghost_bottom, ghost_top = ghost_rows(problem)
    yy = torch.arange(ny, device=device)[:, None]
    xx = torch.arange(nx, device=device)[None, :]
    walls_x, walls_y = problem.walls_x, problem.walls_y

    def step(s: torch.Tensor) -> torch.Tensor:
        s_post = collide_thermal(problem, s)
        planes = []
        for i in range(Qs):
            cix, ciy = int(c_all[i, 0]), int(c_all[i, 1])
            plane = torch.roll(s_post[i], (ciy, cix), (0, 1))
            # pulls that crossed a wall read the frozen ghost row
            if walls_y and ciy > 0:
                plane = torch.where(yy == 0, float(ghost_bottom[i]), plane)
            elif walls_y and ciy < 0:
                plane = torch.where(yy == ny - 1, float(ghost_top[i]), plane)
            planes.append(plane)
        f_planes, g_planes = planes[:Qf], planes[Qf:]
        if walls_x:
            # adiabatic no-slip x walls: f and g both take the node's own
            # post-collision opposite (zero momentum and heat flux)
            for i in range(Qs):
                cix = int(c_all[i, 0])
                tgt, k = (f_planes, i) if i < Qf else (g_planes, i - Qf)
                if cix > 0:
                    tgt[k] = torch.where(xx == 0, s_post[int(opp_all[i])],
                                         tgt[k])
                elif cix < 0:
                    tgt[k] = torch.where(xx == nx - 1,
                                         s_post[int(opp_all[i])], tgt[k])
        if not walls_y:
            return torch.stack(f_planes + g_planes)
        # no-slip y walls for f: full-way bounce-back with the node's own
        # post-collision outward values (exact wall mass)
        opp = lat.opposite
        for i in range(Qf):
            ciy = int(lat.c[i, 1])
            if ciy > 0:
                f_planes[i] = torch.where(yy == 0, s_post[int(opp[i])],
                                          f_planes[i])
            elif ciy < 0:
                f_planes[i] = torch.where(yy == ny - 1, s_post[int(opp[i])],
                                          f_planes[i])
        # fixed-T walls for g: the heat flux through them is the Nusselt
        # number
        boundaries.apply_thermal_wall(lg, g_planes, yy == 0, 1, +1,
                                      th.t_bottom, None)
        boundaries.apply_thermal_wall(lg, g_planes, yy == ny - 1, 1, -1,
                                      th.t_top, None)
        return torch.stack(f_planes + g_planes)

    return step


def make_step_padded_thermal(problem: Problem, origin: tuple[int, int],
                             local_shape: tuple[int, int], device):
    """step(spad) -> spad': one thermal step of the shard whose block
    (14, *local_shape) starts at the global cell `origin` (y, x), on its
    block padded by a one-cell ring (14, nyl + 2, nxl + 2), which holds its
    neighbours' pre-collision populations (halo.refresh_ring). Port of
    tpulbm's make_local_step_padded_thermal: the whole padded block
    collides, a physical y edge's ring row becomes its frozen ghost row,
    the centre pulls from the padded block, and the walls act where the
    shard holds a physical edge (its origin says which): with x walls the
    bounce at the global edge columns, then the f bounce-back and the g
    anti-bounce-back at the global wall rows. The ring of the result keeps
    the post-collision values; only the centre is the next state."""
    lat, lg, th = _thermal_parts(problem)
    check_geometry(problem)
    Qf, Qs = lat.Q, problem.state_q
    nyl, nxl = local_shape
    y0, x0 = origin
    p = problem.params
    c_all = np.concatenate([lat.c, lg.c], axis=0)
    opp_all = np.concatenate([lat.opposite, Qf + lg.opposite])
    bottom, top = ghost_rows(problem)
    is_bottom = problem.walls_y and y0 == 0
    is_top = problem.walls_y and y0 + nyl == p.ny
    is_left = problem.walls_x and x0 == 0
    is_right = problem.walls_x and x0 + nxl == p.nx
    rows = torch.arange(nyl, device=device)[:, None]
    cols = torch.arange(nxl, device=device)[None, :]
    bot, top_row = rows == 0, rows == nyl - 1
    left, right = cols == 0, cols == nxl - 1
    center = (slice(1, -1), slice(1, -1))

    def step(spad: torch.Tensor) -> torch.Tensor:
        s_post = collide_thermal(problem, spad)
        if is_bottom:
            s_post[:, 0, :] = torch.as_tensor(
                bottom, dtype=spad.dtype, device=spad.device)[:, None]
        if is_top:
            s_post[:, -1, :] = torch.as_tensor(
                top, dtype=spad.dtype, device=spad.device)[:, None]
        planes = []
        for i in range(Qs):
            cix, ciy = int(c_all[i, 0]), int(c_all[i, 1])
            planes.append(s_post[i, 1 - ciy:1 - ciy + nyl,
                                 1 - cix:1 - cix + nxl])
        for i in range(Qf):
            ciy = int(lat.c[i, 1])
            if ciy > 0 and is_bottom:
                planes[i] = torch.where(bot, s_post[int(lat.opposite[i])]
                                        [center], planes[i])
            elif ciy < 0 and is_top:
                planes[i] = torch.where(top_row, s_post[int(lat.opposite[i])]
                                        [center], planes[i])
        for i in range(Qs):
            cix = int(c_all[i, 0])
            if cix > 0 and is_left:
                planes[i] = torch.where(left, s_post[int(opp_all[i])]
                                        [center], planes[i])
            elif cix < 0 and is_right:
                planes[i] = torch.where(right, s_post[int(opp_all[i])]
                                        [center], planes[i])
        g_planes = planes[Qf:]
        if is_bottom:
            boundaries.apply_thermal_wall(lg, g_planes, bot, 1, +1,
                                          th.t_bottom, None)
        if is_top:
            boundaries.apply_thermal_wall(lg, g_planes, top_row, 1, -1,
                                          th.t_top, None)
        out = spad.clone()
        out[:, 1:-1, 1:-1] = torch.stack(planes[:Qf] + g_planes)
        return out

    return step


def make_ring_step_thermal(problem: Problem, origin: tuple[int, int],
                           local_shape: tuple[int, int], device):
    """step(s, rb, rt, rl=None, rr=None) -> s': one thermal step of the
    shard whose block (14, *local_shape) starts at the global cell `origin`
    (y, x), from its one-cell rings (halo.exchange at depth 1; rl and rr
    None where the block spans every column): the plain version of the
    thermal kernel's ring build (ops/step_thermal_cuda.py)."""
    from .step_rings_torch import assemble
    one = make_step_padded_thermal(problem, origin, local_shape, device)
    eq_ring = problem.ghost_ring_values()

    def step(s, rb, rt, rl=None, rr=None) -> torch.Tensor:
        spad = assemble(s, rb, rt, rl, rr, 1, problem.periodic_x, eq_ring)
        return one(spad)[:, 1:-1, 1:-1].contiguous()

    return step


def temperature(problem: Problem, s: torch.Tensor) -> torch.Tensor:
    """T field (ny, nx) from the stacked state."""
    return torch.sum(s[problem.lattice.Q:], dim=0)


def scalar_variance(problem: Problem, s: torch.Tensor) -> torch.Tensor:
    """The scalar's variance <(T - <T>)²>, a 0-d tensor: the periodic
    passive scalar's mixing measure, which diffusion destroys and stirring
    speeds up (its trace takes the Nusselt number's place)."""
    T = temperature(problem, s)
    return torch.mean((T - torch.mean(T)) ** 2)


def nusselt(problem: Problem, s: torch.Tensor) -> torch.Tensor:
    """Instantaneous Nusselt number, a 0-d tensor: the mean vertical heat
    flux over the conductive flux,

        Nu = 1 + <u_y T> · H / (alpha ΔT)

    (1 in the conductive state, above 1 once convection sets in)."""
    lat, lg, th = _thermal_parts(problem)
    _, u = physics.moments(lat, s[:lat.Q])
    T = temperature(problem, s)
    h = effective_height(problem.params)
    dt_wall = th.t_bottom - th.t_top
    adv = torch.mean(u[1] * T)
    return 1.0 + adv * h / (th.alpha * dt_wall)
