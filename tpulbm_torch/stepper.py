"""Chunked time stepping on one device.

Port of tpulbm/parallel/sharded_step.py::make_chunk_fn and
make_super_chunk_fn for a single device: no mesh and no halo exchange. A
chunk is a Python loop of kernel launches over two ping-pong buffers;
PyTorch queues them asynchronously, so the host only waits where a caller
reads a result.
"""
from __future__ import annotations

import math
import os

import torch

from .models.base import Problem
from .ops import (diagnostics, forces as forces_mod, step_cuda,
                  step_multiphase, step_multiphase_cuda, step_thermal,
                  step_thermal_cuda, step_torch)


def choose_substeps(chunk_len: int) -> int:
    """The temporal-blocking depth of a kernel chunk: sharded_step.py's
    choice (:336-375) for one device. TPULBM_NO_FUSED2 turns blocking off
    and TPULBM_SUBSTEPS forces a depth, as in tpulbm; otherwise the first
    of 4, 3, 2 that divides chunk_len, else 1 (the 1-step kernel). tpulbm's
    TPU-only conditions (slab count, VMEM fit) have no counterpart."""
    if os.environ.get("TPULBM_NO_FUSED2"):
        return 1
    forced = os.environ.get("TPULBM_SUBSTEPS")
    for n_sub in ([int(forced)] if forced else [4, 3, 2]):
        if n_sub != 1 and chunk_len % n_sub == 0:
            return n_sub
    return 1


def check_substeps_3d() -> None:
    """3-D chunks run one step per launch: the counterpart of tpulbm's 3-D
    dispatch with TPULBM_NO_FUSED2 (sharded_step.py:199-215). A depth
    forced above 1 with TPULBM_SUBSTEPS raises: the 3-D N-cascade is not
    ported."""
    forced = os.environ.get("TPULBM_SUBSTEPS")
    if (not os.environ.get("TPULBM_NO_FUSED2") and forced
            and int(forced) > 1):
        raise NotImplementedError(
            f"TPULBM_SUBSTEPS={forced}: 3-D temporal blocking is not ported "
            "to tpulbm_torch yet (ROADMAP Queue 2 item 11, 3-D N-cascade)")


def make_chunk_fn(problem: Problem, device, chunk_len: int,
                  backend: str = "pallas"):
    """fn(f) -> f advanced by chunk_len steps, on `device`.

    backend="pallas": the CUDA kernels (their plain version for CPU
    tensors). 2-D: chunk_len // N launches of the N-step kernel at the
    depth N of choose_substeps, or chunk_len launches of the 1-step kernel
    at N=1. 3-D: chunk_len launches of the D3Q19 kernel (check_substeps_3d).
    Thermal: chunk_len launches of the thermal kernel, one step each, as
    tpulbm's body_thermal_pallas scans its 1-step kernel
    (TPULBM_SUBSTEPS does not apply). Shan-Chen multiphase: chunk_len
    launches of the multiphase kernel, as tpulbm's body_multiphase_pallas
    (the same). backend="jax": the plain PyTorch step, in f32 or f64.
    fn.substeps is N (1 for the plain step), tpulbm's chunk.pallas_substeps.
    The input f is donated: its storage is reused as a ping-pong buffer.
    """
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    substeps = 1
    if backend == "pallas":
        if problem.params.precision != "f32":
            raise NotImplementedError(
                "the CUDA kernel runs float32 only, as tpulbm's Pallas "
                "kernels do; use backend='jax' for f64")
        if problem.thermal is not None:
            step = step_thermal_cuda.make_local_step_thermal_cuda(problem,
                                                                  device)
        elif problem.shan_chen:
            step = step_multiphase_cuda.make_local_step_multiphase_cuda(
                problem, device)
        elif problem.lattice.D == 3:
            check_substeps_3d()
            step = step_cuda.make_local_step_cuda_3d(problem, device)
        else:
            substeps = choose_substeps(chunk_len)
            step = (step_cuda.make_local_step_cuda(problem, device)
                    if substeps == 1 else
                    step_cuda.make_local_step_cuda_blocked(problem, device,
                                                           substeps))
        launches = chunk_len // substeps

        def chunk(f: torch.Tensor) -> torch.Tensor:
            spare = torch.empty_like(f)
            for _ in range(launches):
                f, spare = step(f, spare), f
            return f
    elif backend == "jax":
        device = torch.device(device)
        if problem.thermal is not None:
            step_plain = step_thermal.make_step_thermal(problem, device)
        elif problem.shan_chen:
            step_plain = step_multiphase.make_step_multiphase(problem, device)
        else:
            step_plain = step_torch.make_step_rolled(problem, device)

        def chunk(f: torch.Tensor) -> torch.Tensor:
            for _ in range(chunk_len):
                f = step_plain(f)
            return f
    else:
        raise ValueError(f"unknown backend {backend!r}")
    chunk.substeps = substeps
    return chunk


def make_super_chunk_fn(problem: Problem, device, interval_len: int,
                        n_intervals: int, backend: str = "pallas",
                        with_fields: bool = False):
    """fn(f) -> (f', diags): n_intervals chunks of interval_len steps with
    the per-interval diagnostics left on the device, so a caller fetches
    n_intervals output intervals with one device-to-host copy.

    diags is ONE flat device tensor in f's dtype; fn.unpack(diags) splits it
    (or a host copy of it) into forces (K, 2) (fx and fy, what forces.csv
    records; zeros without an obstacle), max_vel (K,), stable (K,) (1 or 0),
    for thermal problems nusselt (K,), and, with with_fields, rho
    (K, *spatial), u (K, D, *spatial) and, thermal, temp (K, *spatial):
    each taken at an interval's starting state, the reference's output
    cadence. Port of sharded_step.make_super_chunk_fn without with_stats;
    the Nusselt number rides the same round trip as there.
    """
    chunk = make_chunk_fn(problem, device, interval_len, backend=backend)
    force = (forces_mod.forces_fn(problem, device)
             if problem.solid is not None else None)
    max_vel = diagnostics.max_velocity_fn(problem, device)
    stable = diagnostics.stability_fn(problem)
    fields = diagnostics.fields_fn(problem, device) if with_fields else None
    thermal = problem.thermal is not None
    nusselt = diagnostics.nusselt_fn(problem) if thermal else None
    temp = (diagnostics.temperature_fn(problem)
            if thermal and with_fields else None)
    k = n_intervals
    spatial = tuple(problem.spatial_shape)
    dims = problem.lattice.D
    cells = math.prod(spatial)
    per = 5 if thermal else 4            # fx, fy, max |u|, stable[, Nu]
    n_scalar = per * k
    n_fields = (1 + dims + (1 if thermal else 0)) * k * cells
    size = n_scalar + (n_fields if with_fields else 0)

    def unpack(flat) -> dict:
        scalars = flat[:n_scalar].reshape(k, per)
        out = {"forces": scalars[:, :2], "max_vel": scalars[:, 2],
               "stable": scalars[:, 3]}
        if thermal:
            out["nusselt"] = scalars[:, 4]
        if with_fields:
            at = n_scalar
            out["rho"] = flat[at:at + k * cells].reshape((k,) + spatial)
            at += k * cells
            out["u"] = flat[at:at + dims * k * cells].reshape(
                (k, dims) + spatial)
            at += dims * k * cells
            if thermal:
                out["temp"] = flat[at:at + k * cells].reshape((k,) + spatial)
        return out

    def fn(f: torch.Tensor):
        flat = torch.empty(size, dtype=f.dtype, device=f.device)
        views = unpack(flat)
        for j in range(k):
            if force is None:
                views["forces"][j] = 0.0
            else:
                views["forces"][j] = force(f)[:2]
            views["max_vel"][j] = max_vel(f)
            views["stable"][j] = stable(f)
            if nusselt is not None:
                views["nusselt"][j] = nusselt(f)
            if fields is not None:
                views["rho"][j], views["u"][j] = fields(f)
            if temp is not None:
                views["temp"][j] = temp(f)
            f = chunk(f)
        return f, flat

    fn.unpack = unpack
    return fn
