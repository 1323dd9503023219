"""Run orchestration on one device: banners, chunked time stepping, force
recording, diagnostics, VTK frames, the stability abort and the final
artifacts.

Port of tpulbm/runner.py (its per-interval path). Cadence parity with the
reference loop: forces are recorded at every t ≡ 0 (mod output_frequency),
t = 0 included, from the post-collision state; max-velocity prints and VTK
frames happen at those t > 0. Forces, max velocity and stability come back
in one host fetch per output interval; NaN/Inf persist under LBM
arithmetic, so a check per interval aborts as surely as one per step.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .config import SimulationParams
from .convert import state_from_numpy
from .geometry import solid_cell_count
from .models import make_problem
from .models.base import Problem
from .ops import diagnostics, forces as forces_mod
from .stepper import make_chunk_fn
from .utils import io as io_mod
from .utils.profiling import ThroughputMeter


@dataclasses.dataclass
class RunResult:
    success: bool
    final_step: int
    mlups: float
    wall_seconds: float
    forces_path: str | None
    stats: dict | None = None


def check_runner_slice(params: SimulationParams) -> None:
    """Raise NotImplementedError for run options the port lacks so far."""
    if params.backend == "pallas" and params.precision != "f32":
        raise NotImplementedError(
            "the CUDA kernel (--backend pallas) runs float32 only, as "
            "tpulbm's Pallas kernels do; use --backend jax for f64")
    if tuple(params.mesh_shape) != (1, 1):
        raise NotImplementedError(
            f"mesh_shape={params.mesh_shape} is not ported to tpulbm_torch "
            "yet (ROADMAP Queue 1 item 19, several devices)")
    if params.checkpoint_every:
        raise NotImplementedError(
            "checkpoints are not ported to tpulbm_torch yet (ROADMAP Queue 1 "
            "item 8); convert.load_tpulbm_checkpoint reads tpulbm's")
    if params.stats_from >= 0 or params.probe_points:
        raise NotImplementedError(
            "statistics and probes are not ported to tpulbm_torch yet "
            "(ROADMAP Queue 1 item 15)")


class Runner:
    def __init__(self, params: SimulationParams, device="cuda",
                 verbose: bool = True):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch finds no CUDA device")
        check_runner_slice(params)
        self.params = params
        self.device = device
        self.verbose = verbose
        self.problem: Problem = make_problem(params)
        self._chunk_cache: dict[int, object] = {}
        self._forces = forces_mod.forces_fn(self.problem, device)
        self._fields = diagnostics.fields_fn(self.problem, device)
        self._stable = diagnostics.stability_fn(self.problem)
        self._max_vel = diagnostics.max_velocity_fn(self.problem, device)
        os.makedirs(params.output_dir, exist_ok=True)

    def _print_banner(self) -> None:
        if not self.verbose:
            return
        p = self.params
        print("Cylinder Flow LBM Parameters:")
        print(f"  Domain: {p.nx}×{p.ny}")
        print(f"  tau = {p.tau}, nu = {p.nu()}")
        print(f"  Inlet velocity = {p.inlet_velocity}")
        print(f"  Reynolds number = {p.reynolds()}")
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "host CPU")
        print(f"  Device: {self.device} ({name}), precision {p.precision}, "
              f"backend {p.backend}")
        print(f"  Cylinder: center=({p.get_cylinder_x()},{p.get_cylinder_y()}), "
              f"radius={p.get_cylinder_radius_cells()} cells")
        print(f"  Solid cells: {solid_cell_count(self.problem.solid)}")

    def _chunk_fn(self, length: int):
        if length not in self._chunk_cache:
            self._chunk_cache[length] = make_chunk_fn(
                self.problem, self.device, length, backend=self.params.backend)
        return self._chunk_cache[length]

    def _diag(self, f: torch.Tensor) -> np.ndarray:
        """[fx, fy, max |u|, stable] in ONE device-to-host fetch."""
        force = self._forces(f)
        packed = torch.cat([force, self._max_vel(f)[None],
                            self._stable(f)[None].to(force.dtype)])
        return packed.cpu().numpy()

    def _fetch_fields(self, f: torch.Tensor):
        rho, u = self._fields(f)
        return rho.cpu().numpy(), u.cpu().numpy()

    def run(self) -> RunResult:
        p = self.params
        problem = self.problem
        self._print_banner()
        t0_wall = time.perf_counter()
        f = state_from_numpy(problem.initial_state(), problem, self.device)
        forces_path = os.path.join(p.output_dir, "forces.csv")
        force_writer = io_mod.ForceWriter(forces_path)
        meter = ThroughputMeter(p.num_cells, self.device)
        if self.verbose:
            print("Starting LBM simulation...")

        t = 0
        success = True
        freq = p.output_frequency
        # The reference's final fields are the moments stored during its
        # LAST collision (of the state before the final step) with the final
        # step's BC overrides at the inlet/outlet columns. To reproduce its
        # velocity_field.csv, stop one step short, snapshot the fields, then
        # advance the last step.
        t_fields = max(p.num_timesteps - 1, 0)
        fields_prev = None
        try:
            with meter.measure(p.num_timesteps):
                while t < p.num_timesteps:
                    if t % freq == 0:
                        fx, fy, mv, stable = self._diag(f)
                        cd, cl = forces_mod.force_coefficients(
                            problem, np.array([fx, fy]))
                        force_writer.record(t, float(fx), float(fy), cd, cl)
                        if t > 0:
                            if self.verbose:
                                print(f"Timestep {t}: max_vel={float(mv):.6f}")
                            if p.enable_vtk and t >= p.vtk_start_step:
                                rho_f, u_f = self._fetch_fields(f)
                                io_mod.write_vtk_timestep(
                                    u_f[0], u_f[1], rho_f, p, t, p.output_dir,
                                    fmt=p.vtk_format)
                        if not stable:
                            print(f"Simulation unstable at timestep {t}")
                            success = False
                            break

                    n = min(freq - (t % freq), p.num_timesteps - t)
                    if t < t_fields:
                        n = min(n, t_fields - t)
                    elif t == t_fields:
                        fields_prev = self._fetch_fields(f)
                    f = self._chunk_fn(n)(f)
                    t += n

                # final fence + stability check of the end state
                if success and not bool(self._stable(f)):
                    print(f"Simulation unstable at timestep {t}")
                    success = False
        finally:
            force_writer.close()

        stats = self.write_final_results(f, fields_prev) if success else None
        wall = time.perf_counter() - t0_wall
        if self.verbose:
            print(f"\nThroughput: {meter.mlups:.1f} MLUPS over "
                  f"{meter.steps} steps ({wall:.1f}s wall total)")
        return RunResult(success, t, meter.mlups, wall, forces_path, stats)

    def write_final_results(self, f: torch.Tensor,
                            fields_prev=None) -> dict | None:
        """velocity_field.csv, simulation_params.csv and the time-averaged
        drag summary. With `fields_prev` (the fields one step before the
        end), interior values come from the last collision and the inlet and
        outlet columns from the final BC application, as in the reference."""
        p = self.params
        if self.verbose:
            print("\nGathering final results...")
        rho, u = self._fetch_fields(f)
        if fields_prev is not None:
            rho_prev, u_prev = fields_prev
            for col in (0, p.nx - 1):   # Zou-He inlet and outlet columns
                rho_prev[..., col] = rho[..., col]
                u_prev[..., col] = u[..., col]
            rho, u = rho_prev, u_prev
        io_mod.write_velocity_field(u[0], u[1], rho, p, p.output_dir)
        io_mod.write_simulation_params(u[0], u[1], p, p.output_dir)
        stats = io_mod.calculate_time_averaged_drag(
            os.path.join(p.output_dir, "forces.csv"), verbose=self.verbose)
        if self.verbose:
            print("Files written: velocity_field.csv, simulation_params.csv, "
                  "forces.csv")
        return stats
