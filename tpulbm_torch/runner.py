"""Run orchestration: banners, chunked time stepping, force and Nusselt
(or scalar variance) recording, point probes, Reynolds statistics,
diagnostics, VTK frames, the stability abort and the final artifacts, on
one device or on a mesh of shards.

Port of tpulbm/runner.py. Cadence parity with the
reference loop: forces (problems with an obstacle) and the Nusselt number
(thermal problems) are recorded at every t ≡ 0 (mod output_frequency),
t = 0 included, forces from the post-collision state; max-velocity prints
and VTK frames happen at those t > 0. These diagnostics stay on the device
until the host fetches them: _SUPER_K output intervals per fetch on the
fast path (parallel/sharded_step.make_super_chunk_fn, stepper's on one
device), one per interval on the tail.
Probes (params.probe_points) ride the same fetch (probes.csv). Reynolds
statistics (params.stats_from >= 0) are summed on the device, one sample
per output interval from stats_from on, inside the super-chunk as
tpulbm's fn_stats sums them (parallel/sharded_step.Stats), and written
once at the end (stats_fields.npz).
NaN/Inf persist under LBM arithmetic, so a check per interval aborts as
surely as one per step. Checkpoints are tpulbm's single-.npz format,
written at chunk boundaries and resumed by run(resume=True), the
statistics' accumulators with them; a mesh of several shards
(params.mesh_shape, parallel/) writes tpulbm's per-shard directories and
resumes either kind, and its artifacts are gathered to the host once per
write, the counterpart of tpulbm's rank-0 I/O. Across several processes
(parallel/multihost.py) every process runs the loop over its own shards
and takes part in every gather, and process 0 alone prints and writes
(tpulbm/runner.py:63-64); on resume process 0 decides and broadcasts
(step, failed, kind) before any process reads a checkpoint, so a bad
checkpoint raises on every process.
"""
from __future__ import annotations

import dataclasses
import os
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .config import SimulationParams
from .convert import split_state, state_from_numpy_block
from .geometry import solid_cell_count
from .models import make_problem
from .models.base import Problem
from .models.rayleigh_benard import effective_height
from .ops import diagnostics
from .ops import forces as forces_mod
from .parallel import multihost, sharded_step
from .parallel.mesh import Mesh, make_mesh, visible_devices
from .utils import checkpoint as ckpt
from .utils import io as io_mod
from .utils.profiling import ThroughputMeter

# output intervals batched per host round trip (tpulbm/runner.py:38)
_SUPER_K = 8


@dataclasses.dataclass
class RunResult:
    success: bool
    final_step: int
    mlups: float
    wall_seconds: float
    forces_path: str | None
    stats: dict | None = None
    host_fetches: int = 0   # device-to-host round trips in the loop


def check_runner_slice(params: SimulationParams) -> None:
    """Raise NotImplementedError for run options the port lacks so far."""
    if params.backend == "pallas" and params.precision != "f32":
        raise NotImplementedError(
            "the CUDA kernel (--backend pallas) runs float32 only, as "
            "tpulbm's Pallas kernels do; use --backend jax for f64")


def runner_mesh(params: SimulationParams, device="cuda",
                devices=None) -> Mesh:
    """The mesh of a run: params.mesh_shape over `devices` (one per shard
    in row-by-row order, a device may repeat: four shards on one card),
    else over the first my*mx visible cards (an explicit mesh larger than
    the visible cards raises, as tpulbm's make_mesh does), or over the host
    CPU where `device` asks for it. Across several processes this
    process's shards run on `devices` (its own shards'), by default on
    multihost.local_device()."""
    n = params.mesh_shape[0] * params.mesh_shape[1]
    if multihost.process_count() > 1:
        if devices is None and (torch.device(device).type
                                != multihost.local_device().type):
            raise ValueError(f"device {device!r} is not this process's "
                             f"{multihost.local_device()} "
                             "(multihost.initialize chose it)")
        return make_mesh(tuple(params.mesh_shape), devices=devices)
    if devices is None:
        device = torch.device(device)
        if device.type == "cpu":
            devices = [device] * n
        elif n == 1:
            devices = [device]
        else:
            devices = visible_devices()[:n]
    return make_mesh(tuple(params.mesh_shape), devices=list(devices))


class Runner:
    def __init__(self, params: SimulationParams, device="cuda",
                 verbose: bool = True, devices=None):
        device = torch.device(device)
        if (devices is None and device.type == "cuda"
                and multihost.process_count() == 1
                and not torch.cuda.is_available()):
            raise RuntimeError("device='cuda' but torch finds no CUDA device")
        check_runner_slice(params)
        self.params = params
        # rank-0 semantics (tpulbm/runner.py:63-64): banners and files come
        # from process 0 only; the gathers run on every process
        self.primary = multihost.is_primary()
        self.verbose = verbose and self.primary
        self.problem: Problem = make_problem(params)
        self.mesh = runner_mesh(params, device, devices)
        # the state is the mesh's grid of blocks, one block on (1,1), where
        # the sharded stepper and diagnostics are the one-device ones
        self.device = self.mesh.home
        self._diagnostics = sharded_step.Diagnostics(self.problem, self.mesh)
        self._chunk_cache: dict[int, object] = {}
        self._super: dict[bool, object] = {}   # with_fields -> super-chunk fn
        # A closed box (the cavity) has no open boundary to absorb the
        # walls' O(gradient) mass drift; the step is degree-1 homogeneous
        # in f, so rescaling the total mass to its start value after every
        # chunk and super-chunk (as tpulbm's Runner does) only pins the
        # density scale. On the device, no host round trip.
        self._mass0 = (float(np.prod(self.problem.spatial_shape))
                       if self.problem.closed_box else None)
        self._host_fetches = 0
        # VTK frame formatting and writing run on a pool of writer threads
        # (run() opens and closes it) so frames do not stall the device;
        # the pending cap bounds the RAM held by queued frame copies
        self._io_pool: ThreadPoolExecutor | None = None
        self._io_futures: list = []
        self._max_pending = 32
        os.makedirs(params.output_dir, exist_ok=True)

    def _print_banner(self) -> None:
        if not self.verbose:
            return
        p = self.params
        print("Cylinder Flow LBM Parameters:" if p.problem.startswith("cylinder")
              else f"{p.problem} LBM Parameters:")
        print(f"  Domain: {p.nx}×{p.ny}" + (f"×{p.nz}" if p.is_3d else ""))
        print(f"  tau = {p.tau}, nu = {p.nu()}")
        print(f"  Inlet velocity = {p.inlet_velocity}")
        print(f"  Reynolds number = {p.reynolds()}")
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "host CPU")
        if self.mesh.size > 1:
            my, mx = self.mesh.shape
            devs = sorted({str(d) for row in self.mesh.devices for d in row
                           if d is not None})
            world = multihost.process_count()
            procs = (f", {world} processes over {multihost.backend()}"
                     if world > 1 else "")
            print(f"  Device mesh: {my}×{mx} ({', '.join(devs)}; {name}"
                  f"{procs}), local block {p.ny // my}×{p.nx // mx}, "
                  f"precision {p.precision}, backend {p.backend}")
        else:
            print(f"  Device: {self.device} ({name}), precision "
                  f"{p.precision}, backend {p.backend}")
        if self.problem.solid is not None:
            print(f"  Cylinder: center=({p.get_cylinder_x()},"
                  f"{p.get_cylinder_y()}), "
                  f"radius={p.get_cylinder_radius_cells()} cells")
            print(f"  Solid cells: {solid_cell_count(self.problem.solid)}")

    def _chunk_fn(self, length: int):
        if length not in self._chunk_cache:
            self._chunk_cache[length] = sharded_step.make_chunk_fn(
                self.problem, self.mesh, length, backend=self.params.backend)
        return self._chunk_cache[length]

    def _renorm(self, f):
        """f with its total mass, summed over the shards, rescaled to the
        closed box's start value (f itself for an open problem)."""
        if self._mass0 is None:
            return f
        scale = self._mass0 / self._diagnostics.mass(f)
        return sharded_step._map(f, lambda b: b * scale.to(b.device))

    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        """One device-to-host copy, counted."""
        self._host_fetches += 1
        return x.cpu().numpy()

    def _diag(self, f) -> np.ndarray:
        """[fx, fy, max |u|, stable] (and Nu for a thermal problem) in ONE
        device-to-host fetch; the force is 0 without an obstacle."""
        return self._fetch(self._diagnostics.sample(f))

    def _fetch_fields(self, f):
        rho, u = self._diagnostics.fields(f)
        return self._fetch(rho), self._fetch(u)

    def _fetch_temp(self, f) -> np.ndarray | None:
        temp = self._diagnostics.temperature(f)
        return None if temp is None else self._fetch(temp)

    def _super_fn(self, with_fields: bool):
        if with_fields not in self._super:
            self._super[with_fields] = sharded_step.make_super_chunk_fn(
                self.problem, self.mesh, self.params.output_frequency,
                _SUPER_K, backend=self.params.backend,
                with_fields=with_fields)
        return self._super[with_fields]

    def _drain_io(self) -> None:
        """Wait for the queued VTK writes and surface their errors."""
        for fut in self._io_futures:
            fut.result()
        self._io_futures = []

    def _submit_frame(self, rho: np.ndarray, u: np.ndarray, t: int,
                      temp: np.ndarray | None = None) -> None:
        """Queue one VTK frame (with a temperature block for a thermal
        problem) on the writer pool and surface any exception of an
        already finished write."""
        p = self.params
        self._io_futures.append(self._io_pool.submit(
            io_mod.write_vtk_timestep, u[0], u[1], rho, p, t, p.output_dir,
            uz=u[2] if p.is_3d else None, fmt=p.vtk_format, temp=temp))
        pending = []
        for fut in self._io_futures:
            if fut.done():
                fut.result()
            else:
                pending.append(fut)
        self._io_futures = pending
        while len(self._io_futures) > self._max_pending:
            self._io_futures.pop(0).result()

    def _save_ckpt(self, ckpt_dir: str, t: int, f, stats=None) -> None:
        """tpulbm's checkpoint: one .npz of the state on one device, a
        per-shard directory on a mesh of several (tpulbm/runner.py:226-254),
        the statistics' accumulators beside the state."""
        first = -1 if stats is None or stats.first is None else stats.first
        if self.mesh.size > 1:
            sums = scalars = None
            if stats is not None:
                sums = {name: sharded_step._map(grid, self._fetch)
                        for name, grid in stats.sums.items()}
                scalars = {"count": float(self._fetch(stats.count)),
                           "first": first}
            # every process writes its own shards (checkpoint.save_sharded)
            ckpt.save_sharded(ckpt_dir, t, sharded_step._map(f, self._fetch),
                              self.params, stats=sums, stats_scalars=scalars,
                              owners=self.mesh.processes)
        else:
            host = None
            if stats is not None:
                host = {"count": self._fetch(stats.count),
                        "first": np.int64(first),
                        **{name: self._fetch(grid[0][0])
                           for name, grid in stats.sums.items()}}
            ckpt.save(ckpt_dir, t, self._fetch(f[0][0]), self.params,
                      stats=host)

    def _resume_point(self):
        """(start step, state or None, statistics or None) from the newest
        checkpoint in the run's checkpoint directory
        (tpulbm/runner.py:264-373): a single .npz (a host state, sharded on
        a mesh) or a per-shard directory (host blocks, read on a mesh whose
        blocks line up with the saved ones, as tpulbm reads it), each with
        the statistics' accumulators it holds.

        Across several processes process 0 decides and broadcasts (step,
        failed, kind), kind 0 fresh, 1 a single .npz (its state and
        statistics broadcast from process 0), 2 a per-shard directory
        (each process reads its own shards, then all learn whether any
        read failed), so a bad checkpoint raises on every process."""
        p = self.params
        ckpt_dir = os.path.join(p.output_dir, p.checkpoint_dir)
        several = multihost.process_count() > 1
        start_step, kind, f0, stats, err = 0, 0, None, None, None
        latest = ckpt.latest(ckpt_dir) if self.primary else None
        if latest is not None:
            try:
                if not os.path.isdir(latest):
                    start_step, f0, stats = ckpt.load(latest, p, extras=True)
                    kind = 1
                elif several:
                    # the shards are read below, by each process its own
                    start_step, kind = ckpt.check_manifest(latest, p), 2
                else:
                    start_step, f0, stats = ckpt.load_sharded(
                        latest, self.mesh.shape, p, extras=True)
                    kind = 2
            except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
                err = f"{type(e).__name__}: {e}"
        if several:
            text = (err or "").encode()
            start_step, failed, kind, has_stats, n = (
                int(v) for v in multihost.broadcast_one_to_all(np.array(
                    [start_step, err is not None, kind, stats is not None,
                     len(text)], np.int64)))
            if failed:
                # process 0's message on every process
                text = multihost.broadcast_one_to_all(
                    np.frombuffer(text, np.uint8) if self.primary
                    else np.zeros(n, np.uint8)).tobytes().decode()
                raise RuntimeError(f"checkpoint load failed on process 0 "
                                   f"({text})")
            if kind == 1:
                f0, stats = self._broadcast_npz(f0, stats, has_stats)
            elif kind == 2:
                f0, stats = self._load_own_shards(ckpt_dir, start_step)
        elif err is not None:
            raise RuntimeError(f"checkpoint load failed ({err})")
        if self.verbose and kind:
            print(f"  Resuming from {latest} at step {start_step}")
        return start_step, f0, stats

    def _broadcast_npz(self, f0, stats, has_stats: bool):
        """Process 0's single-.npz state and statistics on every process
        (the others pass placeholders of their shape and dtype)."""
        problem = self.problem
        shape = problem.spatial_shape
        d = problem.lattice.D
        f0 = multihost.broadcast_one_to_all(
            f0 if f0 is not None else np.zeros(
                (problem.state_q,) + tuple(shape), problem.dtype))
        if not has_stats:
            return f0, None
        like = {"count": (), "first": (), "s_rho": (), "s_u": (d,),
                "s_uu": (d * (d + 1) // 2,)}
        if stats is None:
            stats = {k: np.zeros(lead if k in ("count", "first")
                                 else lead + tuple(shape),
                                 np.int64 if k == "first" else problem.dtype)
                     for k, lead in like.items()}
        return f0, {k: multihost.broadcast_one_to_all(np.asarray(stats[k]))
                    for k in like}

    def _load_own_shards(self, ckpt_dir: str, step: int):
        """This process's shards and statistics sums from the per-shard
        checkpoint of `step` (its physics checked on process 0); raises on
        every process if any process's read failed."""
        path = os.path.join(ckpt_dir, f"ckpt_{step:09d}")
        err, f0, stats = None, None, None
        try:
            _, f0, stats = ckpt.load_sharded(
                path, self.mesh.shape, extras=True,
                cells=self.mesh.local_shards())
        except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
            err = f"{type(e).__name__}: {e}"
        failed = multihost.all_gather(torch.tensor(
            [err is not None], dtype=torch.int64, device=self.device))
        bad = [i for i, v in enumerate(failed.reshape(-1).tolist()) if v]
        if bad:
            raise RuntimeError(f"checkpoint load failed on process "
                               f"{', '.join(map(str, bad))}"
                               + (f" ({err})" if err else ""))
        return f0, stats

    def _stats(self, start_step: int, saved: dict | None):
        """The statistics' accumulators of a run with stats_from >= 0 (None
        otherwise): those of the checkpoint resumed from, where it holds
        them, else zeros (tpulbm/runner.py:341-373)."""
        p = self.params
        if p.stats_from < 0:
            return None
        dtype = torch.float64 if self.problem.dtype == np.float64 \
            else torch.float32
        if saved is not None and "s_rho" in saved:
            stats = sharded_step.Stats(self._diagnostics, dtype, saved)
            if self.verbose:
                print(f"  Resuming statistics accumulation "
                      f"({int(float(np.asarray(saved['count'])))} samples "
                      f"so far)")
            return stats
        if start_step > p.stats_from and self.verbose:
            print(f"  NOTE: resuming at step {start_step} with no saved "
                  f"statistics accumulators (pre-statistics checkpoint); "
                  f"accumulation starts fresh here")
        return sharded_step.Stats(self._diagnostics, dtype)

    def _write_stats(self, stats) -> None:
        """stats_fields.npz: the means and stresses computed on the device
        from the sums, fetched once (tpulbm/runner.py:605-634)."""
        p = self.params
        n = float(self._fetch(stats.count))
        if n < 1:
            if self.verbose:
                print("Reynolds statistics: no samples taken "
                      "(stats_from past the sampled window); skipping")
            return
        mrho, mu, re = (self._fetch(x) for x in stats.means())
        if not self.primary:
            return
        path = io_mod.write_stats_fields(
            mrho, mu, re, diagnostics.stats_pair_names(
                self.problem.lattice.D), int(n),
            stats.first if stats.first is not None else -1,
            p.output_frequency, p.output_dir)
        if self.verbose:
            print(f"Reynolds statistics: {int(n)} samples -> {path}")

    def _initial(self, f0):
        """The run's device state, the mesh's grid of blocks, from a host
        state (a global array, or a grid of host blocks from a per-shard
        checkpoint), or the initial state where f0 is None, built on each
        shard's device (sharded_step.shard_initial_state)."""
        problem = self.problem
        if isinstance(f0, list):
            return [[state_from_numpy_block(b, problem,
                                            self.mesh.device(iy, ix))
                     if b is not None else None
                     for ix, b in enumerate(row)]
                    for iy, row in enumerate(f0)]
        if f0 is None:
            return sharded_step.shard_initial_state(problem, self.mesh)[0]
        return split_state(f0, problem, self.mesh)

    def run(self, resume: bool = True) -> RunResult:
        """Step the problem to num_timesteps and write the artifacts. With
        resume and checkpoint_every set, continue from the newest
        checkpoint in output_dir/checkpoint_dir if there is one."""
        p = self.params
        problem = self.problem
        self._print_banner()
        t0_wall = time.perf_counter()
        self._host_fetches = 0
        start_step, f0, stats_saved = (self._resume_point()
                                       if resume and p.checkpoint_every
                                       else (0, None, None))
        f = self._initial(f0)
        stats = self._stats(start_step, stats_saved)
        force_writer = forces_path = nu_writer = probe_writer = None
        if problem.solid is not None:
            forces_path = os.path.join(p.output_dir, "forces.csv")
            if self.primary:
                force_writer = io_mod.ForceWriter(
                    forces_path, append=start_step > 0,
                    resume_step=start_step)
        if problem.thermal is not None and self.primary:
            # between y walls the Nusselt trace; the periodic passive
            # scalar's variance rides its slot (tpulbm/runner.py:385-393)
            trace = ({} if problem.walls_y else
                     dict(header="timestep,scalar_variance\n", fmt="{:.8e}"))
            nu_writer = io_mod.NusseltWriter(
                os.path.join(p.output_dir, "nusselt.csv" if problem.walls_y
                             else "scalar_variance.csv"),
                append=start_step > 0, resume_step=start_step, **trace)
        probe_slot = 4 + (problem.thermal is not None)
        n_probes = len(p.probe_points)
        if n_probes and self.primary:
            probe_writer = io_mod.ProbeWriter(
                os.path.join(p.output_dir, "probes.csv"), n_probes=n_probes,
                ndim=problem.lattice.D, thermal=problem.thermal is not None,
                append=start_step > 0, resume_step=start_step)
        meter = ThroughputMeter(p.num_cells, self.device)
        if self.verbose:
            print("Starting LBM simulation...")

        t = start_step
        success = True
        freq = p.output_frequency
        ckpt_dir = os.path.join(p.output_dir, p.checkpoint_dir)
        chunks_done = 0
        last_ckpt = 0
        # The reference's final fields are the moments stored during its
        # LAST collision (of the state before the final step) with the final
        # step's BC overrides at the inlet/outlet columns. To reproduce its
        # velocity_field.csv, stop one step short, snapshot the fields, then
        # advance the last step.
        t_fields = max(p.num_timesteps - 1, start_step)
        fields_prev = None
        self._io_pool = ThreadPoolExecutor(
            max_workers=max(2, min(8, os.cpu_count() or 1)))
        try:
            with meter.measure(p.num_timesteps - start_step):
                while t < p.num_timesteps:
                    # Fast path: _SUPER_K output intervals per host fetch,
                    # their diagnostics (and, in a VTK window, their fields)
                    # stacked on the device. A window holds a frame when
                    # its last one, t + (K-1)*freq, is due.
                    vtk_window = (p.enable_vtk
                                  and t + (_SUPER_K - 1) * freq
                                  >= p.vtk_start_step)
                    if t % freq == 0 and t + _SUPER_K * freq <= t_fields:
                        fn = self._super_fn(vtk_window)
                        sample = None
                        if stats is not None:
                            # skip the window's intervals before
                            # stats_from (tpulbm's j_skip)
                            skip = min(max(0, -((t - p.stats_from) // freq)),
                                       _SUPER_K)
                            sample = stats.sampler(t, freq, skip)
                        f, flat = fn(f, sample)
                        f = self._renorm(f)
                        d = fn.unpack(self._fetch(flat))
                        aborted = False
                        for j in range(_SUPER_K):
                            tj = t + j * freq
                            if force_writer is not None:
                                fv = d["forces"][j]
                                cd, cl = forces_mod.force_coefficients(
                                    problem, fv)
                                force_writer.record(tj, float(fv[0]),
                                                    float(fv[1]), cd, cl)
                            if nu_writer is not None:
                                nu_writer.record(tj,
                                                 float(d["nusselt"][j]))
                            if probe_writer is not None:
                                probe_writer.record(tj, d["probes"][j])
                            if tj > 0 and self.verbose:
                                print(f"Timestep {tj}: "
                                      f"max_vel={float(d['max_vel'][j]):.6f}")
                            if (vtk_window and tj > 0 and self.primary
                                    and tj >= p.vtk_start_step):
                                # copies: a view would pin the whole window
                                self._submit_frame(
                                    np.array(d["rho"][j]), np.array(d["u"][j]),
                                    tj, np.array(d["temp"][j])
                                    if "temp" in d else None)
                            if not d["stable"][j]:
                                if self.primary:
                                    print("Simulation unstable at "
                                          f"timestep {tj}")
                                success = False
                                aborted = True
                                break
                        if aborted:
                            break
                        t += _SUPER_K * freq
                        chunks_done += _SUPER_K
                        if (p.checkpoint_every and
                                chunks_done - last_ckpt >= p.checkpoint_every):
                            self._save_ckpt(ckpt_dir, t, f, stats)
                            last_ckpt = chunks_done
                        continue

                    # the tail: one diagnostics fetch per output interval
                    if t % freq == 0:
                        if stats is not None and t >= p.stats_from:
                            stats.add(f)
                            if stats.first is None:
                                stats.first = t
                        dv = self._diag(f)
                        fx, fy, mv, stable = dv[:4]
                        if force_writer is not None:
                            cd, cl = forces_mod.force_coefficients(
                                problem, np.array([fx, fy]))
                            force_writer.record(t, float(fx), float(fy), cd,
                                                cl)
                        if nu_writer is not None:
                            nu_writer.record(t, float(dv[4]))
                        if probe_writer is not None:
                            probe_writer.record(t, dv[probe_slot:].reshape(
                                n_probes, -1))
                        if t > 0:
                            if self.verbose:
                                print(f"Timestep {t}: max_vel={float(mv):.6f}")
                            if p.enable_vtk and t >= p.vtk_start_step:
                                # a gather every process takes part in
                                rho_f, u_f = self._fetch_fields(f)
                                temp = self._fetch_temp(f)
                                if self.primary:
                                    self._submit_frame(rho_f, u_f, t, temp)
                        if not stable:
                            if self.primary:
                                print(f"Simulation unstable at timestep {t}")
                            success = False
                            break

                    n = min(freq - (t % freq), p.num_timesteps - t)
                    if t < t_fields:
                        n = min(n, t_fields - t)
                    elif t == t_fields:
                        fields_prev = self._fetch_fields(f)
                    f = self._renorm(self._chunk_fn(n)(f))
                    t += n
                    chunks_done += 1
                    if (p.checkpoint_every and
                            chunks_done - last_ckpt >= p.checkpoint_every):
                        self._save_ckpt(ckpt_dir, t, f, stats)
                        last_ckpt = chunks_done

                # final fence + stability check of the end state
                if success and not self._fetch(self._diagnostics.stable(f)):
                    if self.primary:
                        print(f"Simulation unstable at timestep {t}")
                    success = False
        finally:
            for writer in (force_writer, nu_writer, probe_writer):
                if writer is not None:
                    writer.close()
            try:
                self._drain_io()
            finally:
                self._io_pool.shutdown()
                self._io_pool = None
        fetches = self._host_fetches
        if success and stats is not None:
            self._write_stats(stats)

        stats = self.write_final_results(f, fields_prev) if success else None
        wall = time.perf_counter() - t0_wall
        if self.verbose:
            print(f"\nThroughput: {meter.mlups:.1f} MLUPS over "
                  f"{meter.steps} steps ({wall:.1f}s wall total)")
        return RunResult(success, t, meter.mlups, wall, forces_path, stats,
                         fetches)

    def write_final_results(self, f, fields_prev=None) -> dict | None:
        """The final artifacts (tpulbm/runner.py:636-706). 2-D:
        velocity_field.csv, simulation_params.csv and, with an obstacle,
        the time-averaged drag summary; thermal: temperature_field.csv and
        the final Nusselt number (the passive scalar: its variance); 3-D:
        fields3d.npz and, with VTK on, a final frame. With `fields_prev`
        (the fields one step before the end), interior values come from
        the last collision and the inlet and outlet columns from the final
        BC application, as in the reference. Across several processes
        every process takes part in the gathers and process 0 alone writes
        (the others return None)."""
        p = self.params
        problem = self.problem
        if self.verbose:
            print("\nGathering final results...")
        rho, u = self._fetch_fields(f)
        T = self._fetch_temp(f)
        if not self.primary:
            return None
        if fields_prev is not None:
            rho_prev, u_prev = fields_prev
            edge_cols = []
            if problem.inlet_zou_he or problem.inlet_equilibrium:
                edge_cols.append(0)
            if problem.outlet_zou_he or problem.outlet_zero_grad:
                edge_cols.append(p.nx - 1)
            for col in edge_cols:
                rho_prev[..., col] = rho[..., col]
                u_prev[..., col] = u[..., col]
            rho, u = rho_prev, u_prev
        if p.is_3d:
            np.savez(os.path.join(p.output_dir, "fields3d.npz"),
                     rho=rho, ux=u[0], uy=u[1], uz=u[2],
                     params=np.frombuffer(p.to_json().encode(), np.uint8))
            if p.enable_vtk:
                io_mod.write_vtk_timestep(u[0], u[1], rho, p,
                                          p.num_timesteps, p.output_dir,
                                          uz=u[2], fmt=p.vtk_format)
            if self.verbose:
                print("Files written: fields3d.npz"
                      + (", vtk_output/ (final frame)" if p.enable_vtk
                         else ""))
            return None
        io_mod.write_velocity_field(u[0], u[1], rho, p, p.output_dir)
        io_mod.write_simulation_params(u[0], u[1], p, p.output_dir)
        written = ["velocity_field.csv", "simulation_params.csv"]
        stats = None
        if problem.thermal is not None and problem.walls_y:
            th = problem.thermal
            io_mod.write_temperature_field(T, p, p.output_dir)
            written += ["nusselt.csv", "temperature_field.csv"]
            # Nu from the host fields, as tpulbm computes it: u of the
            # reported fields, T of the final state
            nu = 1.0 + (np.mean(u[1] * T) * effective_height(p)
                        / (th.alpha * (th.t_bottom - th.t_top)))
            stats = {"nusselt": float(nu)}
            if self.verbose:
                print(f"Nusselt number = {nu:.4f}")
        elif problem.thermal is not None:
            io_mod.write_temperature_field(T, p, p.output_dir)
            written += ["scalar_variance.csv", "temperature_field.csv"]
            var = float(np.mean((T - T.mean()) ** 2))
            stats = {"scalar_variance": var}
            if self.verbose:
                print(f"Scalar variance = {var:.6e}")
        if problem.solid is not None:
            stats = io_mod.calculate_time_averaged_drag(
                os.path.join(p.output_dir, "forces.csv"),
                verbose=self.verbose)
            written.append("forces.csv")
        if self.verbose:
            print("Files written: " + ", ".join(written))
        return stats
