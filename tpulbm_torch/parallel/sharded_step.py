"""The chunked time stepper on a mesh of shards.

Port of tpulbm/parallel/sharded_step.py, the generic 2-D part: the D2Q9
single-phase problems (the cylinder with any obstacle rule, the Bouzidi
curved wall included, and either corner rule, the periodic channel, the
cavity, the periodic boxes with or without Kolmogorov's force profile)
under every collision the D2Q9 kernels hold.
Under a periodic y the ring rows wrap (tpulbm's ring_kw) and no shard owns
a physical y edge. A sharded state is the (my, mx) grid of local blocks
(Q, nyl, nxl), shard (iy, ix) on mesh.device(iy, ix) (parallel/mesh.py);
one process drives every shard, as `shard_map` does. Each launch's rings
come from parallel/halo.py and each shard steps through the ring builds of
the D2Q9 kernels (ops/step_cuda.collide_stream_rings) or, for a CPU
tensor, their plain version (ops/step_rings_torch.py).

The dispatch is tpulbm's (:228-393):
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
TPULBM_SUBSTEPS forces a depth and TPULBM_NO_FUSED2 turns blocking off, as
in tpulbm. A (1,1) mesh without TPULBM_FORCE_TILED or TPULBM_HALO_OVERLAP
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
from ..ops import step_cuda, step_rings_torch
from . import halo
from .mesh import Mesh

Grid = halo.Grid


def check_mesh_problem(problem: Problem, mesh: Mesh) -> None:
    """Raise NotImplementedError for a problem this slice does not run on
    a mesh of more than one shard, naming its ROADMAP item."""
    if mesh.size == 1:
        return
    if problem.lattice.D == 3:
        raise NotImplementedError(
            f"a 3-D problem on mesh {mesh.shape} is not ported to "
            "tpulbm_torch yet (ROADMAP Queue 1 item 19, several devices: 3-D "
            "meshes)")
    if problem.thermal is not None or problem.shan_chen:
        raise NotImplementedError(
            f"the {'thermal' if problem.thermal else 'multiphase'} step on "
            f"mesh {mesh.shape} is not ported to tpulbm_torch yet (ROADMAP "
            "Queue 1 item 19, several devices)")


def origin(mesh: Mesh, local_shape: tuple[int, int], iy: int,
           ix: int) -> tuple[int, int]:
    """Global (y, x) of shard (iy, ix)'s first cell."""
    return iy * local_shape[0], ix * local_shape[1]


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
    only the mask crosses from the host. A start at an analytic field
    (init_fields: the periodic boxes) is built on the host and cut."""
    if problem.init_fields is not None:
        return split(mesh, problem.initial_state()), None
    local = mesh.local_shape(problem.spatial_shape)
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
            f = torch.as_tensor(feq, dtype=dtype, device=dev).reshape(
                q, 1, 1).expand((q,) + local).contiguous()
            if solid is not None:
                r = torch.as_tensor(rest, dtype=dtype, device=dev)
                f = torch.where(solid[iy][ix][None], r.reshape(q, 1, 1), f)
            row.append(f)
        shards.append(row)
    return shards, solid


def _solid_grid(problem: Problem, mesh: Mesh) -> Grid:
    solid = (np.zeros(problem.spatial_shape, bool) if problem.solid is None
             else problem.solid)
    return shard_mask(mesh, solid)


def _fits(local_shape: tuple[int, int], depth: int) -> bool:
    """Whether a shard of local_shape takes rings `depth` deep. Replaces
    tpulbm's TPU layout conditions (the VMEM fit, 128-lane widths and the
    slab counts n_ty >= N + 1) with the port's own: a neighbour must hold
    the `depth` rows or columns a ring carries, and a corner rule reads
    two cells inward."""
    return min(local_shape) >= max(depth, 3)


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


def _streams(devices):
    """{device: side stream} for the CUDA devices among `devices` (none on
    the CPU)."""
    return {d: torch.cuda.Stream(d) for d in set(devices) if d.type == "cuda"}


def make_chunk_fn(problem: Problem, mesh: Mesh, chunk_len: int,
                  backend: str = "pallas"):
    """fn(shards) -> shards advanced by chunk_len steps.

    backend="pallas": the ring builds of the D2Q9 kernels (their plain
    version on CPU shards) as `plan` dispatches; backend="jax": the plain
    tier, tpulbm's body_jax: each step refreshes every padded block's
    1-wide ring (halo.refresh_ring_2d) and steps it
    (step_rings_torch.make_step_padded). fn.mode is the plan's mode
    ("overlap", "rows", "tiled", "plain" or "one-device"), fn.substeps the
    depth N (tpulbm's pallas_substeps; 1 for the plain tier) and fn.plan
    [(N, launches per shard)], each shard's launches at each call (three
    per N steps in the overlap mode). The input blocks are donated: their
    storage is reused as ping-pong buffers."""
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    check_mesh_problem(problem, mesh)
    if backend not in ("pallas", "jax"):
        raise ValueError(f"unknown backend {backend!r}")
    forced_path = (os.environ.get("TPULBM_FORCE_TILED")
                   or os.environ.get("TPULBM_HALO_OVERLAP"))
    if mesh.size == 1 and (backend == "jax" or not forced_path
                           or problem.lattice.D != 2 or problem.thermal
                           is not None or problem.shan_chen):
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
    return _kernel_chunk(problem, mesh, chunk_len)


def _plain_chunk(problem: Problem, mesh: Mesh, chunk_len: int):
    local = mesh.local_shape(problem.spatial_shape)
    eq_ring = problem.ghost_ring_values()
    has_solid = problem.solid is not None
    pads = (halo.pad_mask(_solid_grid(problem, mesh),
                          periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y)
            if has_solid else None)
    steps = [[step_rings_torch.make_step_padded(
        problem, tuple(o - 1 for o in origin(mesh, local, iy, ix)),
        (local[0] + 2, local[1] + 2), pads[iy][ix] if has_solid else None,
        mesh.device(iy, ix))
        for ix in range(mesh.shape[1])] for iy in range(mesh.shape[0])]

    def chunk(shards: Grid) -> Grid:
        fpads = [[halo.make_padded(f, eq_ring) for f in row]
                 for row in shards]
        for _ in range(chunk_len):
            halo.refresh_ring_2d(fpads, eq_ring=eq_ring,
                                 periodic_x=problem.periodic_x,
                                 periodic_y=problem.periodic_y)
            fpads = [[step(fp) for step, fp in zip(srow, frow)]
                     for srow, frow in zip(steps, fpads)]
        return [[fp[:, 1:-1, 1:-1].contiguous() for fp in row]
                for row in fpads]

    chunk.mode = "plain"
    chunk.substeps = 1
    chunk.plan = [(1, chunk_len)]
    chunk.pallas3d_depths = None
    return chunk


def kernel_shards(problem: Problem, mesh: Mesh, depth: int, x_rings: bool,
                  masks: Grid | None = None) -> Grid:
    """The grid of step_cuda.Shard the ring kernels take at `depth`: each
    shard's place and its kernel mask padded by `depth` (`masks`, the
    bool halo.pad_mask grid, built here if not given), with, under the
    Bouzidi obstacle, the link bits and its cut of the link table padded
    the same way (bouzidi.table_block)."""
    local = mesh.local_shape(problem.spatial_shape)
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
                    problem, (o[0] - depth, o[1] - depth),
                    tuple(mask.shape))
                mask = torch.as_tensor(step_cuda.kernel_mask(
                    problem, mask.cpu().numpy().astype(bool), table),
                    device=dev)
                links = torch.as_tensor(table, device=dev)
            row.append(step_cuda.Shard(
                index=(iy, ix), origin=o, local_shape=local,
                grid=problem.spatial_shape, depth=depth, x_rings=x_rings,
                mask=mask, links=links))
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
    own cells. On a (1,1) mesh every result is the
    one-device function's, bit for bit; the Nusselt number needs the
    whole thermal state, which only a (1,1) mesh holds
    (check_mesh_problem)."""

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
        local = (mesh.local_shape(problem.spatial_shape) if self._padded
                 else None)
        self._fns = {}
        for iy, ix in mesh.shards():
            dev = mesh.device(iy, ix)
            solid = None if solids is None else solids[iy][ix]
            force = None
            if self._padded:
                y0, x0 = origin(mesh, local, iy, ix)
                table = torch.as_tensor(bouzidi_mod.table_block(
                    problem, (y0 - 1, x0 - 1),
                    (local[0] + 2, local[1] + 2)), device=dev)
                force = forces_mod.forces_fn(
                    problem, dev, dtype=torch.float64, table=table,
                    inner=(slice(1, -1), slice(1, -1)))
            elif solid is not None:
                links = (None if mesh.size == 1
                         else [(i, g[iy][ix]) for i, g in cut])
                force = forces_mod.forces_fn(problem, dev, solid, links,
                                             dtype=torch.float64)
            self._fns[iy, ix] = (
                force, diagnostics.max_velocity_fn(problem, dev, solid),
                diagnostics.fields_fn(problem, dev, solid))
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
        (f,), = shards
        return self._nusselt(f)

    def sample(self, shards: Grid) -> torch.Tensor:
        """[fx, fy, max |u|, stable] (and Nu for a thermal problem) as one
        tensor on the first device: one host fetch."""
        force = self.force(shards)[:2]
        parts = [force, self.max_velocity(shards)[None],
                 self.stable(shards)[None].to(force.dtype)]
        if self._nusselt is not None:
            parts.append(self.nusselt(shards)[None])
        return torch.cat(parts)

    def fields(self, shards: Grid):
        """(rho, u) of the global grid on the first device, with the
        reference's solid-cell overrides (diagnostics.fields_fn)."""
        per = self._per_shard(2, shards)
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
    """fn(shards) -> (shards', diags): stepper.make_super_chunk_fn on a
    mesh (that function itself where the chunk is the one-device one).
    diags is ONE flat tensor on the first shard's device, in
    stepper.super_layout's layout; fn.unpack splits it into forces (K, 2),
    max_vel (K,), stable (K,) and, with with_fields, rho (K, ny, nx) and
    u (K, 2, ny, nx), each taken at an interval's starting state."""
    chunk = make_chunk_fn(problem, mesh, interval_len, backend=backend)
    if chunk.mode == "one-device":
        one = stepper.make_super_chunk_fn(
            problem, mesh.device(0, 0), interval_len, n_intervals,
            backend=backend, with_fields=with_fields)

        def fn_one(shards: Grid):
            f, flat = one(shards[0][0])
            return [[f]], flat

        fn_one.unpack = one.unpack
        return fn_one
    diag = Diagnostics(problem, mesh)
    size, unpack = stepper.super_layout(problem, n_intervals, with_fields)

    def fn(shards: Grid):
        flat = torch.empty(size, dtype=shards[0][0].dtype,
                           device=diag.device)
        views = unpack(flat)
        for j in range(n_intervals):
            views["forces"][j] = diag.force(shards)[:2]
            views["max_vel"][j] = diag.max_velocity(shards)
            views["stable"][j] = diag.stable(shards)
            if with_fields:
                views["rho"][j], views["u"][j] = diag.fields(shards)
            shards = chunk(shards)
        return shards, flat

    fn.unpack = unpack
    return fn
