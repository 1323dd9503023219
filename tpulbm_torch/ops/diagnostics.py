"""On-device diagnostics: macroscopic fields, stability, max velocity, the
thermal problems' temperature and Nusselt number (the passive scalar's
variance; on a mesh from per-shard partial sums), Reynolds-statistics
samples and point probes.

Port of tpulbm/ops/diagnostics.py (fields_fn, stats_sample_fn,
stats_pair_names, stability_fn, max_velocity_fn, probe_cells, probes_fn;
max |u| takes the bare moments for every problem, as in tpulbm). Each
*_fn returns a function of the state tensor whose
result stays on the device until the caller fetches it. The moments are
taken of f[:lattice.Q]: a thermal state stacks its 5 temperature planes
under the 9 flow planes, and they must not enter rho.
"""
from __future__ import annotations

import math

import torch

from .. import physics
from ..models.base import Problem
from ..models.rayleigh_benard import effective_height
from . import step_multiphase, step_thermal


def _solid(problem: Problem, device, solid=None):
    """`solid` (a shard's mask on a mesh), else the problem's on `device`
    (None without an obstacle)."""
    if solid is not None or problem.solid is None:
        return solid
    return torch.as_tensor(problem.solid, device=device)


def fields_fn(problem: Problem, device, solid=None, padded_y0=None):
    """f -> (rho, u) with the reference's solid-cell overrides: rho = 1 and
    u = 0 at solid cells (of `solid`, a shard's mask, where given). For Shan-Chen multiphase, u is the
    half-step-corrected u + F/(2rho) (step_multiphase.physical_velocity):
    bare moments would be off by F/(2rho) at every interface cell. Its
    force reads the neighbours' ψ, so on a mesh f is a shard's block padded
    by a one-cell ring (halo.pad_block) whose centre starts at the global
    row `padded_y0` (step_multiphase.physical_velocity_padded)."""
    lat = problem.lattice
    solid = _solid(problem, device, solid)

    def fn(f: torch.Tensor):
        if problem.shan_chen and padded_y0 is not None:
            rho, u = step_multiphase.physical_velocity_padded(problem, f,
                                                              padded_y0)
        elif problem.shan_chen:
            rho, u = step_multiphase.physical_velocity(problem, f)
        else:
            rho, u = physics.moments(lat, f[:lat.Q])
        if solid is not None:
            rho = torch.where(solid, 1.0, rho)
            u = torch.where(solid[None], 0.0, u)
        return rho, u

    return fn


def stats_sample_fn(problem: Problem, device, solid=None, padded_y0=None):
    """f -> (rho, u, uu): one Reynolds-statistics sample, the fields of
    fields_fn and the products u_i u_j packed as the upper triangle, row by
    row (2-D [uu, uv, vv]; 3-D [uu, uv, uw, vv, vw, ww]). The Runner sums
    them on the device once per output interval (parallel/sharded_step.py's
    Stats), so a time average costs no extra host round trip. padded_y0
    as in fields_fn."""
    base = fields_fn(problem, device, solid, padded_y0)
    d = problem.lattice.D
    pairs = [(i, j) for i in range(d) for j in range(i, d)]

    def fn(f: torch.Tensor):
        rho, u = base(f)
        return rho, u, torch.stack([u[i] * u[j] for i, j in pairs])

    return fn


def stats_pair_names(d: int) -> list[str]:
    """The labels of stats_sample_fn's packed products: "uxux", "uxuy", ..."""
    ax = "xyz"[:d]
    return [f"u{ax[i]}u{ax[j]}" for i in range(d) for j in range(i, d)]


def probe_cells(problem: Problem) -> tuple:
    """The ([z,] y, x) cell of each of params.probe_points, given as domain
    fractions in (x, y[, z]) order (as cylinder_x and cylinder_y): the
    fraction times the extent, floored, at most the last cell. Raises
    ValueError for a point of the wrong dimension or outside [0, 1]."""
    p = problem.params
    cells = []
    for pt in p.probe_points:
        if len(pt) != (3 if p.is_3d else 2):
            raise ValueError(f"probe point {pt} has wrong dimensionality")
        if any(not (0.0 <= v <= 1.0) for v in pt):
            raise ValueError(f"probe point {pt} must be domain fractions "
                             f"in [0, 1]")
        x = min(int(pt[0] * p.nx), p.nx - 1)
        y = min(int(pt[1] * p.ny), p.ny - 1)
        cells.append((min(int(pt[2] * p.nz), p.nz - 1), y, x) if p.is_3d
                     else (y, x))
    return tuple(cells)


def probe_values(problem: Problem, col: torch.Tensor) -> torch.Tensor:
    """[rho, u..., (T)] of one cell's populations `col` (state_q,): the
    bare moments, the temperature appended for a thermal state."""
    lat = problem.lattice
    fcol = col[:lat.Q]
    rho = torch.sum(fcol)
    c = torch.as_tensor(lat.c.astype("float64"), dtype=fcol.dtype,
                        device=fcol.device)
    parts = [rho[None], (c.T @ fcol) / rho]
    if problem.thermal is not None:
        parts.append(torch.sum(col[lat.Q:])[None])
    return torch.cat(parts)


def probes_fn(problem: Problem):
    """f -> (n_probes, 1 + D [+ 1]) of [rho, u..., (T)] at the probe cells
    (probe_cells): single-cell indexing, left on the device to ride the
    diagnostics' round trip to the host (probes.csv)."""
    cells = probe_cells(problem)

    def fn(f: torch.Tensor) -> torch.Tensor:
        return torch.stack([probe_values(problem, f[(slice(None),) + idx])
                            for idx in cells])

    return fn


def stability_fn(problem: Problem):
    """f -> bool scalar tensor: every population finite and |f| < 1e5."""
    def fn(f: torch.Tensor) -> torch.Tensor:
        return physics.is_stable(f)
    return fn


def max_velocity_fn(problem: Problem, device, solid=None):
    """f -> max |u| (solid cells report u = 0; `solid` as in fields_fn)."""
    lat = problem.lattice
    solid = _solid(problem, device, solid)

    def fn(f: torch.Tensor) -> torch.Tensor:
        return physics.max_velocity(lat, f[:lat.Q], solid)

    return fn


def temperature_fn(problem: Problem):
    """s -> the temperature field (ny, nx) of a thermal state."""
    def fn(s: torch.Tensor) -> torch.Tensor:
        return step_thermal.temperature(problem, s)
    return fn


def nusselt_fn(problem: Problem):
    """s -> the thermal trace's value (0-d) of a thermal state: the
    instantaneous Nusselt number between y walls, the scalar variance of
    the periodic passive scalar (tpulbm's Nu slot)."""
    trace = (step_thermal.nusselt if problem.walls_y
             else step_thermal.scalar_variance)

    def fn(s: torch.Tensor) -> torch.Tensor:
        return trace(problem, s)
    return fn


def thermal_trace_of_blocks(problem: Problem, blocks: list,
                            device, collect) -> torch.Tensor:
    """nusselt_fn's value (0-d, in the blocks' dtype, on `device`) of a
    thermal state cut into `blocks` (a mesh's shards, row by row): each
    mean over the grid taken as float64 partial sums per block, reduced on
    `device`. The Nusselt number sums u_y T; the variance sums T for the
    mean first, then (T - <T>)². collect(parts): every shard's partial,
    row by row, from these blocks' (this process's; the others' gathered:
    parallel/sharded_step.Diagnostics._on_first)."""
    cells = math.prod(problem.spatial_shape)
    dtype = blocks[0].dtype

    def total(parts):
        out = None
        for part in collect(list(parts)):
            part = part.to(device)
            out = part if out is None else out + part
        return out

    if problem.walls_y:
        lat, th = problem.lattice, problem.thermal
        flux = []
        for s in blocks:
            _, u = physics.moments(lat, s[:lat.Q])
            flux.append(torch.sum(u[1] * step_thermal.temperature(problem, s),
                                  dtype=torch.float64))
        adv = total(flux) / cells
        dt_wall = th.t_bottom - th.t_top
        return (1.0 + adv * effective_height(problem.params)
                / (th.alpha * dt_wall)).to(dtype)
    temps = [step_thermal.temperature(problem, s) for s in blocks]
    mean = total(torch.sum(t, dtype=torch.float64) for t in temps) / cells
    var = total(torch.sum((t.double() - mean.to(t.device)) ** 2)
                for t in temps) / cells
    return var.to(dtype)
