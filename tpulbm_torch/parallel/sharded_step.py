"""The chunked time stepper on a mesh of shards.

Port of tpulbm/parallel/sharded_step.py, the generic single-phase part:
in 2-D the D2Q9 problems (the cylinder with any obstacle rule, the Bouzidi
curved wall included, and either corner rule, the periodic channel and
the solid-slab channel under any obstacle rule, the
cavity, the periodic boxes with or without Kolmogorov's force profile)
under every collision the D2Q9 kernels hold; in 3-D (D3Q19 or D3Q27) the
sphere in a duct with any obstacle rule, the
body-forced duct and the fully periodic boxes with 3-D Kolmogorov's z
force, under every collision the 3-D kernels hold; the thermal problems
(Rayleigh-Bénard, the side-heated cavity, the periodic passive scalar,
under BGK or the Smagorinsky closure) and Shan-Chen multiphase.
Under a periodic y the ring rows wrap (tpulbm's ring_kw) and no shard owns
a physical y edge. A sharded state is the (my, mx) grid of local blocks,
(Q, nyl, nxl) in 2-D and (Q, nz, nyl, nxl) in 3-D (the mesh cuts y and x,
z stays whole: tpulbm's P(None, None, "y", "x")), shard (iy, ix) on
mesh.device(iy, ix) (parallel/mesh.py); one process drives every shard,
as `shard_map` does. Each launch's rings come from parallel/halo.py and
each shard steps through the ring builds of the kernels
(ops/step_cuda.collide_stream_rings, in 3-D collide_stream_rings_3d) or,
for a CPU tensor, their plain version (ops/step_rings_torch.py).

The 2-D dispatch is tpulbm's (:228-393):
* TPULBM_HALO_OVERLAP on a mesh that does not cut x: each N steps as an
  interior launch that reads no ring plus two edge launches that read the
  exchanged rings (the ranged N-step kernel, tpulbm's body_pallas_overlapN,
  at the first N of 4, 3, 2 that divides the chunk; else the ranged 1-step
  kernel, body_pallas_overlap, which tpulbm builds without force_fn: a
  force profile then takes the full-width kernels below);
* a mesh that does not cut x: the full-width kernels with ring rows
  (body_pallas, rows 1-3);
* a mesh that cuts x, or TPULBM_FORCE_TILED: the x rings too (the x-tiled
  kernel, body_pallas_tiled, row 5) at the first N of 4, 3, 2 that divides
  the chunk, else depth 1.
The 3-D dispatch is tpulbm's too (:147-227, body_pallas3d_tiled
:447-536): the depth-3 split of the chunk, else the depth-2 split
(stepper.blocking_split), each segment at its own depth through the ring
builds of both D3Q19 kernels (row 7, make_local_step_pallas3d_tiled), with
x rings on a mesh that cuts x (or TPULBM_FORCE_XHALO), else [(1, n)]
(plan_3d).
TPULBM_SUBSTEPS forces a depth and TPULBM_NO_FUSED2 turns blocking off, as
in tpulbm. The thermal problems and multiphase step once a launch, as
tpulbm's body_thermal_pallas and body_multiphase_pallas (:921-1010): the
ring builds of the thermal kernel (rings one cell deep) and of the
multiphase kernel (pre-collision rings two cells deep), with x rings on a
mesh that cuts x (multiphase also under TPULBM_FORCE_XHALO).
A (1,1) mesh without TPULBM_FORCE_TILED or TPULBM_HALO_OVERLAP
(in 3-D and for multiphase TPULBM_FORCE_XHALO; a thermal problem always)
runs the one-device stepper (stepper.make_chunk_fn) unchanged.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .. import physics, stepper
from ..models.base import Problem
from ..ops import bouzidi as bouzidi_mod
from ..ops import diagnostics
from ..ops import forces as forces_mod
from ..ops import (step_cuda, step_multiphase, step_multiphase_cuda,
                   step_rings_torch, step_thermal, step_thermal_cuda)
from . import halo
from .mesh import Mesh

Grid = halo.Grid


def origin(mesh: Mesh, local_shape: tuple[int, ...], iy: int,
           ix: int) -> tuple[int, int]:
    """Global (y, x) of shard (iy, ix)'s first cell; local_shape is the
    block's ([nz,] nyl, nxl)."""
    return iy * local_shape[-2], ix * local_shape[-1]


def block_shape(problem: Problem, mesh: Mesh) -> tuple[int, ...]:
    """A shard's block of the spatial grid, ([nz,] nyl, nxl): the mesh cuts
    the last two axes."""
    shape = tuple(problem.spatial_shape)
    return shape[:-2] + mesh.local_shape(shape[-2:])


def split(mesh: Mesh, x, dtype=None) -> Grid:
    """A global (..., ny, nx) host array or tensor cut into the mesh's
    blocks, each a contiguous copy on its shard's device: tpulbm's
    shard_state placement."""
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    nyl, nxl = mesh.local_shape(tuple(x.shape[-2:]))
    # copies, never views: a chunk reuses its input blocks as buffers
    return [[x[..., iy * nyl:(iy + 1) * nyl, ix * nxl:(ix + 1) * nxl]
             .to(mesh.device(iy, ix), dtype=dtype, copy=True).contiguous()
             for ix in range(mesh.shape[1])] for iy in range(mesh.shape[0])]


def gather(shards: Grid, device=None) -> torch.Tensor:
    """The global tensor of a sharded one, on `device` (default: the first
    shard's); the block itself on a (1,1) mesh."""
    device = shards[0][0].device if device is None else torch.device(device)
    if len(shards) == 1 and len(shards[0]) == 1:
        return shards[0][0].to(device)
    return torch.cat([torch.cat([s.to(device) for s in row], dim=-1)
                      for row in shards], dim=-2)


def shard_mask(mesh: Mesh, mask) -> Grid:
    """A global (ny, nx) mask placed per shard."""
    return split(mesh, mask)


def shard_state(mesh: Mesh, f, solid=None):
    """(sharded f, sharded solid or None) from global arrays."""
    return split(mesh, f), (None if solid is None else shard_mask(mesh, solid))


def shard_initial_state(problem: Problem, mesh: Mesh):
    """The sharded initial state, each block built on its own device (the
    uniform equilibrium and the solid cells' rest equilibrium, as
    problem.initial_state() has them), and the sharded solid mask or None:
    only the mask crosses from the host (tpulbm's fresh start,
    runner.py:326-333). A start at an analytic field (init_fields: the
    periodic boxes), a density map (multiphase) or a thermal profile is
    built on the host and cut."""
    if (problem.init_fields is not None or problem.init_rho_map is not None
            or problem.thermal is not None):
        return split(mesh, problem.initial_state()), None
    local = block_shape(problem, mesh)
    q = problem.lattice.Q
    feq = problem.ghost_ring_values()[:q]
    rest = physics.rest_equilibrium(problem.lattice, problem.dtype)
    dtype = torch.float64 if problem.dtype == np.float64 else torch.float32
    solid = (None if problem.solid is None
             else shard_mask(mesh, problem.solid))
    shards = []
    for iy in range(mesh.shape[0]):
        row = []
        for ix in range(mesh.shape[1]):
            dev = mesh.device(iy, ix)
            ones = (1,) * len(local)
            f = torch.as_tensor(feq, dtype=dtype, device=dev).reshape(
                (q,) + ones).expand((q,) + local).contiguous()
            if solid is not None:
                r = torch.as_tensor(rest, dtype=dtype, device=dev)
                f = torch.where(solid[iy][ix][None], r.reshape((q,) + ones),
                                f)
            row.append(f)
        shards.append(row)
    return shards, solid


def _solid_grid(problem: Problem, mesh: Mesh) -> Grid:
    solid = (np.zeros(problem.spatial_shape, bool) if problem.solid is None
             else problem.solid)
    return shard_mask(mesh, solid)


def _fits(local_shape: tuple[int, ...], depth: int) -> bool:
    """Whether a shard of local_shape ([nz,] nyl, nxl) takes rings `depth`
    deep. Replaces tpulbm's TPU layout conditions (the VMEM fit, 128-lane
    widths, the slab counts n_ty >= N + 1, in 3-D H = 8 halo rows and
    tile_height >= 4 halo_height) with the port's own: a neighbour must
    hold the `depth` rows or columns a ring carries, a 2-D corner rule
    reads two cells inward, and the 3-D zero-gradient outlet reads x =
    nx-3 .. nx-1, which the shard at the right edge must hold."""
    return min(local_shape[-2:]) >= max(depth, 3)


def plan(problem: Problem, mesh: Mesh, chunk_len: int) -> tuple[str, int]:
    """(mode, depth) of a kernel chunk on `mesh`, tpulbm's dispatch order
    (:228-393): "overlap" (TPULBM_HALO_OVERLAP on a mesh that does not cut
    x), "rows" (a mesh that does not cut x), "tiled" (one that does, or
    TPULBM_FORCE_TILED), at the blocking depth N (1 for no blocking).
    Under the Bouzidi obstacle "tiled" runs at depth 1 only (tpulbm's
    make_local_step_tiled returns None for it at N > 1,
    step_pallas_tiled.py:137-142) and the overlap mode only at N > 1 (its
    1-step ranged kernel excludes it, sharded_step.py:326-327): without a
    depth that divides the chunk it takes "rows".
    Raises ValueError where no depth fits the shards."""
    local = mesh.local_shape(problem.spatial_shape)
    bouzidi = problem.obstacle_bc == "bouzidi" and problem.solid is not None
    x_sharded = mesh.shape[1] != 1 or bool(os.environ.get(
        "TPULBM_FORCE_TILED"))
    forced = os.environ.get("TPULBM_SUBSTEPS")
    no_fused = bool(os.environ.get("TPULBM_NO_FUSED2"))
    candidates = [int(forced)] if forced else [4, 3, 2]
    for n in candidates:
        if n > 1:
            step_cuda.check_depth(n)
    if not _fits(local, 1):
        raise ValueError(f"shards of {local} cells are too small for the "
                         "ring kernels (at least 3 rows and columns)")
    if os.environ.get("TPULBM_HALO_OVERLAP") and not x_sharded:
        # the edge ranges are N + 1 rows (a launch reads depth + 1 rows past
        # the rows it writes), so the interior range reads no ring; three
        # ranges of N + 1 rows replace tpulbm's n_ty >= 3 (N + 1) slabs
        if not no_fused:
            for n in candidates:
                if (n >= 2 and chunk_len % n == 0 and _fits(local, n)
                        and local[0] >= 3 * (n + 1)):
                    return "overlap", n
        # tpulbm builds its 1-step ranged kernel without force_fn
        # (step_pallas.py:1276-1277) and takes the full-width kernels
        if (local[0] >= 3 * 2 and problem.force_profile is None
                and not bouzidi):
            return "overlap", 1
    mode = "tiled" if x_sharded else "rows"
    if not no_fused and not (bouzidi and mode == "tiled"):
        for n in candidates:
            if n != 1 and chunk_len % n == 0 and _fits(local, n):
                return mode, n
    return mode, 1


def plan_3d(problem: Problem, mesh: Mesh,
            chunk_len: int) -> tuple[str, list]:
    """(mode, [(depth, iters), ...]) of a 3-D kernel chunk on `mesh`,
    tpulbm's dispatch (sharded_step.py:175-227): "tiled" with x rings (a
    mesh that cuts x, or TPULBM_FORCE_XHALO: tpulbm's x_sharded3d,
    :163-164), else "rows", and the segments of the first of the
    depth-3 and depth-2 splits (stepper.plan_3d, TPULBM_SUBSTEPS and
    TPULBM_NO_FUSED2 as there) whose every depth fits the shards (_fits),
    else [(1, chunk_len)]. Under the Bouzidi obstacle with x rings every
    chunk runs at depth 1 (tpulbm's tiled builder declines it at n_sub > 1
    in x_halo mode, step_pallas3d.py:845-851). Where tpulbm leaves its
    kernels for its jax tier for a TPU-only reason (the box with x rings
    at depth 1: its zc scratch has no x-piece DMAs, :823-830) the port
    runs its ring build at depth 1. Raises ValueError where no depth fits
    the shards."""
    local = block_shape(problem, mesh)
    if not _fits(local, 1):
        raise ValueError(f"shards of {local} cells are too small for the "
                         "ring kernels (at least 3 rows and columns)")
    x_rings = mesh.shape[1] != 1 or bool(os.environ.get(
        "TPULBM_FORCE_XHALO"))
    bouzidi = problem.obstacle_bc == "bouzidi" and problem.solid is not None
    segments = stepper.plan_3d(
        chunk_len, local[0],
        lambda depth: _fits(local, depth) and not (
            bouzidi and x_rings and depth > 1))
    return ("tiled" if x_rings else "rows"), segments or [(1, chunk_len)]


def _streams(devices):
    """{device: side stream} for the CUDA devices among `devices` (none on
    the CPU)."""
    return {d: torch.cuda.Stream(d) for d in set(devices) if d.type == "cuda"}


def make_chunk_fn(problem: Problem, mesh: Mesh, chunk_len: int,
                  backend: str = "pallas"):
    """fn(shards) -> shards advanced by chunk_len steps.

    backend="pallas": the ring builds of the kernels (their plain
    version on CPU shards) as `plan` dispatches; backend="jax": the plain
    tier, tpulbm's body_jax: each step refreshes every padded block's
    1-wide ring of rows and columns (halo.refresh_ring) and steps it
    (step_rings_torch.make_step_padded; the thermal step's
    make_step_padded_thermal; for multiphase a refresh before each of
    make_local_steps_multiphase's two halves). fn.mode is the plan's mode
    ("overlap", "rows", "tiled", "plain" or "one-device"), fn.substeps the
    depth N (tpulbm's pallas_substeps; 1 for the plain tier) and fn.plan
    [(N, launches per shard)], each shard's launches at each call (three
    per N steps in the overlap mode). The input blocks are donated: their
    storage is reused as ping-pong buffers."""
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    if backend not in ("pallas", "jax"):
        raise ValueError(f"unknown backend {backend!r}")
    three_d = problem.lattice.D == 3
    thermal = problem.thermal is not None
    # the switches that send one shard through the ring kernels, as
    # tpulbm's (its thermal kernel takes x rings only where the mesh cuts
    # x; multiphase's mp_xh reads TPULBM_FORCE_XHALO)
    if thermal:
        forced_path = None
    elif three_d or problem.shan_chen:
        forced_path = os.environ.get("TPULBM_FORCE_XHALO")
    else:
        forced_path = (os.environ.get("TPULBM_FORCE_TILED")
                       or os.environ.get("TPULBM_HALO_OVERLAP"))
    if mesh.size == 1 and (backend == "jax" or not forced_path):
        one = stepper.make_chunk_fn(problem, mesh.device(0, 0), chunk_len,
                                    backend=backend)

        def chunk_one(shards: Grid) -> Grid:
            return [[one(shards[0][0])]]

        chunk_one.mode = "one-device"
        chunk_one.substeps = one.substeps
        chunk_one.plan = one.plan
        chunk_one.pallas3d_depths = one.pallas3d_depths
        return chunk_one
    if backend == "jax":
        return _plain_chunk(problem, mesh, chunk_len)
    if problem.params.precision != "f32":
        raise NotImplementedError(
            "the CUDA kernel runs float32 only, as tpulbm's Pallas kernels "
            "do; use backend='jax' for f64")
    if three_d:
        return _kernel_chunk_3d(problem, mesh, chunk_len)
    if thermal or problem.shan_chen:
        return _kernel_chunk_coupled(problem, mesh, chunk_len)
    return _kernel_chunk(problem, mesh, chunk_len)


def _plain_chunk(problem: Problem, mesh: Mesh, chunk_len: int):
    local = block_shape(problem, mesh)
    eq_ring = problem.ghost_ring_values()
    has_solid = problem.solid is not None
    pads = (halo.pad_mask(_solid_grid(problem, mesh),
                          periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y)
            if has_solid else None)

    def halves(iy: int, ix: int) -> tuple:
        """The padded steps of shard (iy, ix) that make one step, each
        after a ring refresh: tpulbm's body_jax refreshes once a step, and
        twice for multiphase, whose collision reads the neighbours' ψ and
        whose pull their post-collision edges."""
        o, dev = origin(mesh, local, iy, ix), mesh.device(iy, ix)
        if problem.thermal is not None:
            return (step_thermal.make_step_padded_thermal(problem, o, local,
                                                          dev),)
        if problem.shan_chen:
            return step_multiphase.make_local_steps_multiphase(problem, o,
                                                               local)
        return (step_rings_torch.make_step_padded(
            problem, tuple(v - 1 for v in o),
            (local[-2] + 2, local[-1] + 2),
            pads[iy][ix] if has_solid else None, dev),)

    steps = [[halves(iy, ix) for ix in range(mesh.shape[1])]
             for iy in range(mesh.shape[0])]

    def chunk(shards: Grid) -> Grid:
        fpads = [[halo.make_padded(f, eq_ring) for f in row]
                 for row in shards]
        for _ in range(chunk_len):
            for k in range(len(steps[0][0])):
                halo.refresh_ring(fpads, eq_ring=eq_ring,
                                  periodic_x=problem.periodic_x,
                                  periodic_y=problem.periodic_y)
                fpads = [[srow[ix][k](fp) for ix, fp in enumerate(frow)]
                         for srow, frow in zip(steps, fpads)]
        return [[fp[..., 1:-1, 1:-1].contiguous() for fp in row]
                for row in fpads]

    chunk.mode = "plain"
    chunk.substeps = 1
    chunk.plan = [(1, chunk_len)]
    chunk.pallas3d_depths = None
    return chunk


def kernel_shards(problem: Problem, mesh: Mesh, depth: int, x_rings: bool,
                  masks: Grid | None = None) -> Grid:
    """The grid of step_cuda.Shard the ring kernels take at `depth`: each
    shard's place and its kernel mask padded by `depth` rows and columns
    (`masks`, the bool halo.pad_mask grid, built here if not given), with,
    under the Bouzidi obstacle, the link bits and its cut of the link
    table padded the same way (bouzidi.table_block): the padded cut, taken
    once, in place of tpulbm's exchanged q ring rows."""
    local = block_shape(problem, mesh)
    lead = (0,) * (len(local) - 2)
    if masks is None:
        masks = halo.pad_mask(_solid_grid(problem, mesh),
                              periodic_x=problem.periodic_x,
                              periodic_y=problem.periodic_y, depth=depth)
    bouzidi = problem.obstacle_bc == "bouzidi" and problem.solid is not None
    out = []
    for iy in range(mesh.shape[0]):
        row = []
        for ix in range(mesh.shape[1]):
            dev = mesh.device(iy, ix)
            o = origin(mesh, local, iy, ix)
            mask, links = masks[iy][ix].to(torch.uint8).contiguous(), None
            if bouzidi:
                table = bouzidi_mod.table_block(
                    problem, lead + (o[0] - depth, o[1] - depth),
                    tuple(mask.shape))
                mask = torch.as_tensor(step_cuda.kernel_mask(
                    problem, mask.cpu().numpy().astype(bool), table),
                    device=dev)
                links = torch.as_tensor(table, device=dev)
            row.append(step_cuda.Shard(
                index=(iy, ix), origin=o, local_shape=local,
                grid=tuple(problem.spatial_shape), depth=depth,
                x_rings=x_rings, mask=mask, links=links))
        out.append(row)
    return out


def _kernel_chunk(problem: Problem, mesh: Mesh, chunk_len: int):
    mode, depth = plan(problem, mesh, chunk_len)
    local = mesh.local_shape(problem.spatial_shape)
    nyl = local[0]
    eq_ring = problem.ghost_ring_values()
    x_rings = mode == "tiled"
    # one kernel library per collision, domain, source and obstacle rule,
    # as on one device (its StepConstants); the rings builds serve every
    # shard
    consts = step_cuda.kernel_constants(problem)
    has_solid = problem.solid is not None
    masks = halo.pad_mask(_solid_grid(problem, mesh),
                          periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, depth=depth)
    shards_geo = kernel_shards(problem, mesh, depth, x_rings, masks)
    plains = [[step_rings_torch.make_ring_step(
        problem, origin(mesh, local, iy, ix), local, depth,
        masks[iy][ix] if has_solid else None, mesh.device(iy, ix))
        if mesh.device(iy, ix).type == "cpu" else None
        for ix in range(mesh.shape[1])] for iy in range(mesh.shape[0])]
    cells = mesh.shards()
    edge = depth + 1
    sides = _streams([mesh.device(iy, ix) for iy, ix in cells])

    def exchange(cur: Grid) -> Grid:
        return halo.exchange(cur, eq_ring=eq_ring, depth=depth,
                             periodic_x=problem.periodic_x,
                             periodic_y=problem.periodic_y, x_rings=x_rings)

    def launch(cur, out, rings, iy, ix, rows=None):
        step_cuda.collide_stream_rings(
            cur[iy][ix], out[iy][ix], rings, shards_geo[iy][ix], consts,
            depth, rows=rows, plain=plains[iy][ix])

    def whole(cur: Grid, out: Grid) -> None:
        rings = exchange(cur)
        for iy, ix in cells:
            launch(cur, out, rings[iy][ix], iy, ix)

    def overlapped(cur: Grid, out: Grid) -> None:
        # the ring copies on each card's side stream, after the state they
        # read; the interior launches on the compute streams meanwhile;
        # the edge launches after an event that marks the rings ready
        for dev, side in sides.items():
            side.wait_stream(torch.cuda.current_stream(dev))
        with contextlib.ExitStack() as stack:
            for side in sides.values():
                stack.enter_context(torch.cuda.stream(side))
            rings = exchange(cur)
            ready = {dev: side.record_event() for dev, side in sides.items()}
        for iy, ix in cells:
            launch(cur, out, (None, None, None, None), iy, ix,
                   rows=(edge, nyl - edge))
        for iy, ix in cells:
            dev = mesh.device(iy, ix)
            if dev in sides:
                compute = torch.cuda.current_stream(dev)
                compute.wait_event(ready[dev])
                for ring in rings[iy][ix]:
                    if ring is not None:
                        ring.record_stream(compute)
            launch(cur, out, rings[iy][ix], iy, ix, rows=(0, edge))
            launch(cur, out, rings[iy][ix], iy, ix, rows=(nyl - edge, nyl))

    step = overlapped if mode == "overlap" else whole
    n_launch = chunk_len // depth
    if n_launch * depth != chunk_len:
        raise AssertionError(f"depth {depth} does not divide {chunk_len}")

    def chunk(shards: Grid) -> Grid:
        spare = [[torch.empty_like(f) for f in row] for row in shards]
        cur = shards
        for _ in range(n_launch):
            step(cur, spare)
            cur, spare = spare, cur
        return cur

    chunk.mode = mode
    chunk.substeps = depth
    chunk.plan = [(depth, n_launch * (3 if mode == "overlap" else 1))]
    chunk.pallas3d_depths = None
    return chunk


def _kernel_chunk_coupled(problem: Problem, mesh: Mesh, chunk_len: int):
    """The thermal problems and Shan-Chen multiphase on a mesh, tpulbm's
    body_thermal_pallas and body_multiphase_pallas (:921-1010): one launch
    a step and shard of the ring build of the thermal kernel (rings one
    cell deep) or of the multiphase kernel (pre-collision rings two cells
    deep: ψ's stencil reads one, the pull the other), with x rings where
    the mesh cuts x (for multiphase also under TPULBM_FORCE_XHALO, tpulbm's
    mp_xh). Where tpulbm warns and takes its jax tier (a ValueError of its
    builder), the port raises."""
    thermal = problem.thermal is not None
    depth = 1 if thermal else step_multiphase_cuda.DEPTH
    local = block_shape(problem, mesh)
    if not _fits(local, depth):
        raise ValueError(f"shards of {local} cells are too small for the "
                         f"ring kernels (at least {max(depth, 3)} rows and "
                         "columns)")
    x_rings = mesh.shape[1] != 1 or (
        not thermal and bool(os.environ.get("TPULBM_FORCE_XHALO")))
    eq_ring = problem.ghost_ring_values()
    if thermal:
        step_thermal.check_geometry(problem)
        consts = step_thermal_cuda.ThermalConstants.of(problem)
        launch = step_thermal_cuda.collide_stream_thermal_rings
        make_plain = step_thermal.make_ring_step_thermal
    else:
        step_multiphase_cuda.check_problem(problem)
        consts = step_multiphase_cuda.MultiphaseConstants.of(problem)
        launch = step_multiphase_cuda.collide_stream_multiphase_rings
        make_plain = step_multiphase.make_ring_step_multiphase
    cells = mesh.shards()
    geo = {(iy, ix): step_cuda.Shard(
        index=(iy, ix), origin=origin(mesh, local, iy, ix),
        local_shape=local, grid=tuple(problem.spatial_shape), depth=depth,
        x_rings=x_rings) for iy, ix in cells}
    plains = {cell: make_plain(problem, geo[cell].origin, local,
                               mesh.device(*cell))
              for cell in cells if mesh.device(*cell).type == "cpu"}

    def chunk(shards: Grid) -> Grid:
        spare = [[torch.empty_like(f) for f in row] for row in shards]
        cur = shards
        for _ in range(chunk_len):
            rings = halo.exchange(cur, eq_ring=eq_ring, depth=depth,
                                  periodic_x=problem.periodic_x,
                                  periodic_y=problem.periodic_y,
                                  x_rings=x_rings)
            for iy, ix in cells:
                launch(cur[iy][ix], spare[iy][ix], rings[iy][ix],
                       geo[iy, ix], consts, plain=plains.get((iy, ix)))
            cur, spare = spare, cur
        return cur

    chunk.mode = "tiled" if x_rings else "rows"
    chunk.substeps = 1
    chunk.plan = [(1, chunk_len)]
    chunk.pallas3d_depths = None
    return chunk


def _kernel_chunk_3d(problem: Problem, mesh: Mesh, chunk_len: int):
    mode, segments = plan_3d(problem, mesh, chunk_len)
    x_rings = mode == "tiled"
    local = block_shape(problem, mesh)
    eq_ring = problem.ghost_ring_values()
    # the library of the collision, domain, source, force profile, obstacle
    # rule and velocity set, as on one device; its ring builds serve every
    # shard
    consts = step_cuda.kernel_constants(problem, q=19)
    has_solid = problem.solid is not None
    cells = mesh.shards()
    # each segment its own depth: its rings, padded masks and link tables
    # (tpulbm's run_segment, :467-532)
    runs = []
    for depth, iters in segments:
        masks = halo.pad_mask(_solid_grid(problem, mesh),
                              periodic_x=problem.periodic_x,
                              periodic_y=problem.periodic_y, depth=depth)
        geo = kernel_shards(problem, mesh, depth, x_rings, masks)
        plains = {(iy, ix): step_rings_torch.make_ring_step(
            problem, origin(mesh, local, iy, ix), local, depth,
            masks[iy][ix] if has_solid else None, mesh.device(iy, ix))
            for iy, ix in cells if mesh.device(iy, ix).type == "cpu"}
        runs.append((depth, iters, geo, plains))

    def chunk(shards: Grid) -> Grid:
        spare = [[torch.empty_like(f) for f in row] for row in shards]
        cur = shards
        for depth, iters, geo, plains in runs:
            for _ in range(iters):
                rings = halo.exchange(cur, eq_ring=eq_ring, depth=depth,
                                      periodic_x=problem.periodic_x,
                                      periodic_y=problem.periodic_y,
                                      x_rings=x_rings)
                for iy, ix in cells:
                    step_cuda.collide_stream_rings_3d(
                        cur[iy][ix], spare[iy][ix], rings[iy][ix],
                        geo[iy][ix], consts, depth,
                        plain=plains.get((iy, ix)))
                cur, spare = spare, cur
        return cur

    chunk.mode = mode
    chunk.substeps = segments[0][0]
    chunk.plan = list(segments)
    chunk.pallas3d_depths = [depth for depth, _ in segments]
    return chunk


class Diagnostics:
    """The per-interval diagnostics of a sharded state: the one-device
    functions (ops/diagnostics.py, ops/forces.forces_fn) on each shard
    with its cut of the solid mask, reduced on the first shard's device:
    the force a sum of float64 partials, the maximum velocity a max,
    stability an all, the mass a sum; the fields gathered. The momentum
    exchange's link masks are built once from the global solid mask and
    cut per shard, so a link across a shard edge counts where its fluid
    cell lies, with no ring. The Bouzidi obstacle's force reads f̂_i at the
    upstream node of a link, which may lie on a neighbour: each shard's
    force takes its block with a one-cell ring (halo.pad_block) and its
    cut of the link table padded the same way, and sums the links of its
    own cells. A probe reads its cell on the shard that owns it; a
    statistics sample is cell-local, one per shard, but the Shan-Chen
    physical velocity (its fields and samples) reads the neighbours' ψ:
    each shard's takes its block with a one-cell ring. The thermal trace
    (the Nusselt number, the scalar variance) is a mean over the grid,
    summed from float64 partials per shard
    (diagnostics.thermal_trace_of_blocks). On a (1,1) mesh every result is
    the one-device function's, bit for bit."""

    def __init__(self, problem: Problem, mesh: Mesh):
        self.problem, self.mesh = problem, mesh
        self.device = mesh.device(0, 0)
        solids = (None if problem.solid is None
                  else shard_mask(mesh, problem.solid))
        # the Bouzidi force on a mesh of several shards reads padded blocks
        self._padded = (solids is not None and mesh.size > 1
                        and problem.obstacle_bc == "bouzidi")
        if solids is not None and mesh.size > 1 and not self._padded:
            cut = [(i, split(mesh, m)) for i, m in forces_mod.shifted_masks(
                problem, torch.as_tensor(problem.solid))]
        local = block_shape(problem, mesh)
        lead = (0,) * (len(local) - 2)
        # the Shan-Chen fields read the neighbours' ψ: padded blocks
        self._mp_padded = bool(problem.shan_chen) and mesh.size > 1
        inner = (slice(None),) * len(lead) + (slice(1, -1), slice(1, -1))
        self._fns = {}
        for iy, ix in mesh.shards():
            dev = mesh.device(iy, ix)
            solid = None if solids is None else solids[iy][ix]
            force = None
            if self._padded:
                y0, x0 = origin(mesh, local, iy, ix)
                table = torch.as_tensor(bouzidi_mod.table_block(
                    problem, lead + (y0 - 1, x0 - 1),
                    local[:-2] + (local[-2] + 2, local[-1] + 2)), device=dev)
                force = forces_mod.forces_fn(
                    problem, dev, dtype=torch.float64, table=table,
                    inner=inner)
            elif solid is not None:
                links = (None if mesh.size == 1
                         else [(i, g[iy][ix]) for i, g in cut])
                force = forces_mod.forces_fn(problem, dev, solid, links,
                                             dtype=torch.float64)
            y0 = (origin(mesh, local, iy, ix)[0] if self._mp_padded
                  else None)
            self._fns[iy, ix] = (
                force, diagnostics.max_velocity_fn(problem, dev, solid),
                diagnostics.fields_fn(problem, dev, solid, y0),
                diagnostics.stats_sample_fn(problem, dev, solid, y0))
        # each probe's shard and its cell there
        nyl, nxl = mesh.local_shape(problem.spatial_shape[-2:])
        self._probes = [((y // nyl, x // nxl),
                         idx[:-2] + (y % nyl, x % nxl))
                        for idx in diagnostics.probe_cells(problem)
                        for y, x in [idx[-2:]]]
        thermal = problem.thermal is not None
        self._nusselt = diagnostics.nusselt_fn(problem) if thermal else None
        self._temp = diagnostics.temperature_fn(problem) if thermal else None

    def _per_shard(self, which: int, shards: Grid) -> list:
        return [self._fns[iy, ix][which](f)
                for iy, row in enumerate(shards) for ix, f in enumerate(row)]

    def _on_first(self, parts: list) -> list:
        return [p.to(self.device) for p in parts]

    def force(self, shards: Grid) -> torch.Tensor:
        """The obstacle's force (D,) (zeros without an obstacle)."""
        ref = shards[0][0]
        if self.problem.solid is None:
            return ref.new_zeros(self.problem.lattice.D)
        if self._padded:
            shards = halo.pad_block(
                shards, eq_ring=self.problem.ghost_ring_values(), depth=1,
                periodic_x=self.problem.periodic_x,
                periodic_y=self.problem.periodic_y)
        parts = self._on_first(self._per_shard(0, shards))
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total.to(ref.dtype)

    def max_velocity(self, shards: Grid) -> torch.Tensor:
        parts = self._on_first(self._per_shard(1, shards))
        return parts[0] if len(parts) == 1 else torch.max(torch.stack(parts))

    def stable(self, shards: Grid) -> torch.Tensor:
        parts = self._on_first([physics.is_stable(f) for row in shards
                                for f in row])
        return parts[0] if len(parts) == 1 else torch.all(torch.stack(parts))

    def mass(self, shards: Grid) -> torch.Tensor:
        parts = self._on_first([torch.sum(f) for row in shards for f in row])
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    def nusselt(self, shards: Grid) -> torch.Tensor:
        """The thermal trace (0-d): the Nusselt number between y walls, the
        passive scalar's variance."""
        if self.mesh.size == 1:
            return self._nusselt(shards[0][0])
        return diagnostics.thermal_trace_of_blocks(
            self.problem, [f for row in shards for f in row], self.device)

    def _field_blocks(self, shards: Grid) -> Grid:
        """The blocks the fields functions take: with a one-cell ring for
        the Shan-Chen physical velocity on a mesh."""
        if not self._mp_padded:
            return shards
        return halo.pad_block(shards, eq_ring=self.problem.ghost_ring_values(),
                              depth=1, periodic_x=self.problem.periodic_x)

    def probes(self, shards: Grid) -> torch.Tensor:
        """(n_probes, 1 + D [+ 1]) of [rho, u..., (T)] at the probe cells
        (diagnostics.probe_cells), each from the shard that owns it, on the
        first device."""
        return torch.stack([
            diagnostics.probe_values(
                self.problem, shards[iy][ix][(slice(None),) + local]
            ).to(self.device)
            for (iy, ix), local in self._probes])

    def stats_samples(self, shards: Grid) -> list:
        """One Reynolds-statistics sample (rho, u, uu) per shard, row by
        row (diagnostics.stats_sample_fn on each shard's block)."""
        return self._per_shard(3, self._field_blocks(shards))

    def sample(self, shards: Grid) -> torch.Tensor:
        """[fx, fy, max |u|, stable] (then Nu for a thermal problem and the
        probes' values, row by row) as one tensor on the first device: one
        host fetch."""
        force = self.force(shards)[:2]
        parts = [force, self.max_velocity(shards)[None],
                 self.stable(shards)[None].to(force.dtype)]
        if self._nusselt is not None:
            parts.append(self.nusselt(shards)[None])
        if self._probes:
            parts.append(self.probes(shards).reshape(-1).to(force.dtype))
        return torch.cat(parts)

    def fields(self, shards: Grid):
        """(rho, u) of the global grid on the first device, with the
        reference's solid-cell overrides (diagnostics.fields_fn)."""
        per = self._per_shard(2, self._field_blocks(shards))
        mx = len(shards[0])
        rows = [per[i:i + mx] for i in range(0, len(per), mx)]
        return (gather([[r for r, _ in row] for row in rows], self.device),
                gather([[u for _, u in row] for row in rows], self.device))

    def temperature(self, shards: Grid) -> torch.Tensor | None:
        """The temperature field of a thermal state (None otherwise)."""
        if self._temp is None:
            return None
        return gather([[self._temp(f) for f in row] for row in shards],
                      self.device)


def make_super_chunk_fn(problem: Problem, mesh: Mesh, interval_len: int,
                        n_intervals: int, backend: str = "pallas",
                        with_fields: bool = False):
    """fn(shards, sample=None) -> (shards', diags):
    stepper.make_super_chunk_fn on a mesh (that function itself where the
    chunk is the one-device one). diags is ONE flat tensor on the first
    shard's device, in stepper.super_layout's layout; fn.unpack splits it
    into forces (K, 2), max_vel (K,), stable (K,), with probe points
    probes (K, n_probes, 1 + D) and, with with_fields, rho (K, ny, nx) and
    u (K, 2, ny, nx), each taken at an interval's starting state.
    sample(j, shards), if given, sees the starting state of interval j
    (the Runner's statistics: Stats.sampler)."""
    chunk = make_chunk_fn(problem, mesh, interval_len, backend=backend)
    if chunk.mode == "one-device":
        one = stepper.make_super_chunk_fn(
            problem, mesh.device(0, 0), interval_len, n_intervals,
            backend=backend, with_fields=with_fields)

        def fn_one(shards: Grid, sample=None):
            f, flat = one(shards[0][0], None if sample is None else
                          (lambda j, f: sample(j, [[f]])))
            return [[f]], flat

        fn_one.unpack = one.unpack
        return fn_one
    diag = Diagnostics(problem, mesh)
    size, unpack = stepper.super_layout(problem, n_intervals, with_fields)

    def fn(shards: Grid, sample=None):
        flat = torch.empty(size, dtype=shards[0][0].dtype,
                           device=diag.device)
        views = unpack(flat)
        for j in range(n_intervals):
            if sample is not None:
                sample(j, shards)
            views["forces"][j] = diag.force(shards)[:2]
            views["max_vel"][j] = diag.max_velocity(shards)
            views["stable"][j] = diag.stable(shards)
            if "nusselt" in views:
                views["nusselt"][j] = diag.nusselt(shards)
            if "probes" in views:
                views["probes"][j] = diag.probes(shards)
            if with_fields:
                views["rho"][j], views["u"][j] = diag.fields(shards)
                if "temp" in views:
                    views["temp"][j] = diag.temperature(shards)
            shards = chunk(shards)
        return shards, flat

    fn.unpack = unpack
    return fn


class Stats:
    """The Reynolds-statistics accumulators of a run (tpulbm's
    (count, s_rho, s_u, s_uu)): `count` a 0-d tensor in the state's dtype
    on the first shard's device, the sums s_rho (*block), s_u
    (D, *block), s_uu (D(D+1)/2, *block) a grid of blocks, each on its
    shard's device, so a sample is cell-local and a mesh sums the bits one
    device sums. `first` is the first sampled step (None before any).

    tpulbm adds w·x with a weight w of 0 or 1 (0 for the intervals of a
    window before stats_from); s + 1·x is s + x and s + 0·x is s, so
    add() adds x and a skipped interval adds nothing."""

    NAMES = ("s_rho", "s_u", "s_uu")

    def __init__(self, diag: Diagnostics, dtype: torch.dtype,
                 saved: dict | None = None):
        self.diag = diag
        problem, mesh = diag.problem, diag.mesh
        d = problem.lattice.D
        shape = problem.spatial_shape
        local = shape[:-2] + mesh.local_shape(shape[-2:])
        self.first = None
        if saved is None:
            self.count = torch.zeros((), dtype=dtype, device=diag.device)
            self.sums = {name: [[torch.zeros(lead + local, dtype=dtype,
                                             device=mesh.device(iy, ix))
                                 for ix in range(mesh.shape[1])]
                                for iy in range(mesh.shape[0])]
                         for name, lead in zip(self.NAMES, (
                             (), (d,), (d * (d + 1) // 2,)))}
            return
        self.count = torch.tensor(float(np.asarray(saved["count"])),
                                  dtype=dtype, device=diag.device)
        first = int(np.asarray(saved.get("first", -1)))
        self.first = None if first < 0 else first
        # a single .npz holds global arrays, a per-shard directory a grid
        self.sums = {name: [[torch.as_tensor(b).to(mesh.device(iy, ix),
                                                   dtype=dtype)
                             for ix, b in enumerate(row)]
                            for iy, row in enumerate(saved[name])]
                     if isinstance(saved[name], list)
                     else split(mesh, saved[name], dtype=dtype)
                     for name in self.NAMES}

    def add(self, shards: Grid) -> None:
        """One sample of the state `shards`."""
        blocks = self.diag.stats_samples(shards)
        mx = self.diag.mesh.shape[1]
        for k, sample in enumerate(blocks):
            iy, ix = divmod(k, mx)
            for name, x in zip(self.NAMES, sample):
                grid = self.sums[name]
                grid[iy][ix] = grid[iy][ix] + x
        self.count = self.count + 1.0

    def sampler(self, t: int, freq: int, skip: int):
        """sample(j, shards) for a super-chunk window that starts at step
        t: a sample at each interval j >= skip, its first step noted."""
        def sample(j: int, shards: Grid) -> None:
            if j >= skip:
                if self.first is None:
                    self.first = t + j * freq
                self.add(shards)
        return sample

    def means(self):
        """(mean rho, mean u, Reynolds stresses <u_i u_j> - <u_i><u_j> in
        stats_sample_fn's packing), computed on each shard's device and
        gathered on the first: tpulbm's _write_stats arithmetic."""
        d = self.diag.problem.lattice.D
        pairs = [(i, j) for i in range(d) for j in range(i, d)]
        out = ([], [], [])
        for s_rho, s_u, s_uu in zip(*(
                [b for row in self.sums[name] for b in row]
                for name in self.NAMES)):
            cnt = self.count.to(s_rho.device)
            mu = s_u / cnt
            out[0].append(s_rho / cnt)
            out[1].append(mu)
            out[2].append(s_uu / cnt - torch.stack(
                [mu[i] * mu[j] for i, j in pairs]))
        mx = self.diag.mesh.shape[1]
        return tuple(gather([parts[i:i + mx]
                             for i in range(0, len(parts), mx)],
                            self.diag.device) for parts in out)
