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
    and TPULBM_SUBSTEPS forces a depth, as in tpulbm (one that does not
    divide chunk_len gives 1; 5-8 run the deep build of the N-step kernel,
    and the kernel wrapper refuses a depth above 8, the port's cap);
    otherwise the first of 4, 3, 2 that divides chunk_len, else 1 (the
    1-step kernel). tpulbm's TPU-only conditions (slab count, VMEM fit)
    have no counterpart."""
    if os.environ.get("TPULBM_NO_FUSED2"):
        return 1
    forced = os.environ.get("TPULBM_SUBSTEPS")
    for n_sub in ([int(forced)] if forced else [4, 3, 2]):
        if n_sub != 1 and chunk_len % n_sub == 0:
            return n_sub
    return 1


def blocking_split(chunk_len: int, n_sub: int):
    """sharded_step.py's _blocking_split (:32-49), verbatim: chunk_len as
    [(depth, iters), ...] segments led by depth n_sub with a shallower
    tail (140 -> [(3, 46), (2, 1)]), or None when n_sub cannot lead."""
    if n_sub == 3:
        k2 = (0, 2, 1)[chunk_len % 3]
        k3 = (chunk_len - 2 * k2) // 3
        if k3 < 1:
            return None
        return [(3, k3)] + ([(2, k2)] if k2 else [])
    if n_sub == 2:
        k2, k1 = divmod(chunk_len, 2)
        if k2 < 1:
            return None
        return [(2, k2)] + ([(1, k1)] if k1 else [])
    return [(n_sub, chunk_len // n_sub)] if chunk_len % n_sub == 0 else None


def plan_3d(chunk_len: int, nz: int, fits=None):
    """tpulbm's one-device 3-D plan (sharded_step.py:145-227): the blocked
    segments [(depth, iters), ...] of a D3Q19 chunk, or None where tpulbm
    takes its full-plane 1-step kernel. TPULBM_NO_FUSED2 turns blocking off;
    TPULBM_SUBSTEPS=n > 1 that divides chunk_len gives [(n, chunk_len//n)]
    and one that does not gives None; otherwise the first of the depth-3
    and depth-2 splits whose depths all pass. A depth passes where the
    tiled builder's conditions n_sub <= H = 8 and nz >= depth + 1 (:860)
    hold, and fits(depth) where given (a mesh's shards,
    parallel/sharded_step.plan_3d): a forced depth above 8 gives None, as
    on the TPU (tpulbm's interpret mode widens H to the depth instead).
    tpulbm's other TPU-only conditions have no counterpart: the VMEM tile
    search, nx % 128, and tile_height >= 4 * halo_height (:190-192).
    Depths 4-8 run the deep build of the N-step kernel."""
    if os.environ.get("TPULBM_NO_FUSED2"):
        return None
    forced = os.environ.get("TPULBM_SUBSTEPS")
    if forced:
        n = int(forced)
        splits = ([blocking_split(chunk_len, n)]
                  if 1 < n <= step_cuda.MAX_DEPTH and chunk_len % n == 0
                  else [])
    else:
        splits = [s for s in (blocking_split(chunk_len, n) for n in (3, 2))
                  if s is not None]
    for split in splits:
        if all(nz >= depth + 1 and (fits is None or fits(depth))
               for depth, _ in split):
            return split
    return None


def make_chunk_fn(problem: Problem, device, chunk_len: int,
                  backend: str = "pallas"):
    """fn(f) -> f advanced by chunk_len steps, on `device`.

    backend="pallas": the CUDA kernels (their plain version for CPU
    tensors). 2-D: chunk_len // N launches of the N-step kernel at the
    depth N of choose_substeps, or chunk_len launches of the 1-step kernel
    at N=1. 3-D: tpulbm's plan (plan_3d), each segment's launches in order:
    the N-step D3Q19 kernel at depths 2-8, the 1-step D3Q19 kernel at
    depth 1 and for the whole chunk where there is no plan.
    Thermal: chunk_len launches of the thermal kernel, one step each, as
    tpulbm's body_thermal_pallas scans its 1-step kernel
    (TPULBM_SUBSTEPS does not apply). Shan-Chen multiphase: chunk_len
    launches of the multiphase kernel, as tpulbm's body_multiphase_pallas
    (the same). backend="jax": the plain PyTorch step, in f32 or f64.
    fn.plan is the launches as [(depth, launches), ...]; fn.substeps the
    first segment's depth (1 for the plain step), tpulbm's
    chunk.pallas_substeps in 2-D; fn.pallas3d_depths tpulbm's attribute of
    the same name: the plan's depths, None where no 3-D plan runs.
    The input f is donated: its storage is reused as a ping-pong buffer.
    """
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    pallas3d_depths = None
    if backend == "pallas":
        if problem.params.precision != "f32":
            raise NotImplementedError(
                "the CUDA kernel runs float32 only, as tpulbm's Pallas "
                "kernels do; use backend='jax' for f64")
        if problem.thermal is not None:
            plan = [(1, chunk_len)]
            steps = [step_thermal_cuda.make_local_step_thermal_cuda(
                problem, device)]
        elif problem.shan_chen:
            plan = [(1, chunk_len)]
            steps = [step_multiphase_cuda.make_local_step_multiphase_cuda(
                problem, device)]
        elif problem.lattice.D == 3:
            plan = plan_3d(chunk_len, problem.spatial_shape[0])
            if plan is None:
                plan = [(1, chunk_len)]
            else:
                pallas3d_depths = [depth for depth, _ in plan]
            steps = [step_cuda.make_local_step_cuda_3d(problem, device)
                     if depth == 1 else
                     step_cuda.make_local_step_cuda_3d_blocked(problem, device,
                                                               depth)
                     for depth, _ in plan]
        else:
            n_sub = choose_substeps(chunk_len)
            plan = [(n_sub, chunk_len // n_sub)]
            steps = [step_cuda.make_local_step_cuda(problem, device)
                     if n_sub == 1 else
                     step_cuda.make_local_step_cuda_blocked(problem, device,
                                                            n_sub)]
        segments = [(step, n) for step, (_, n) in zip(steps, plan)]

        def chunk(f: torch.Tensor) -> torch.Tensor:
            spare = torch.empty_like(f)
            for step, n in segments:
                for _ in range(n):
                    f, spare = step(f, spare), f
            return f
    elif backend == "jax":
        device = torch.device(device)
        plan = [(1, chunk_len)]
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
    chunk.plan = plan
    chunk.substeps = plan[0][0]
    chunk.pallas3d_depths = pallas3d_depths
    return chunk


def make_super_chunk_fn(problem: Problem, device, interval_len: int,
                        n_intervals: int, backend: str = "pallas",
                        with_fields: bool = False):
    """fn(f, sample=None) -> (f', diags): n_intervals chunks of
    interval_len steps with the per-interval diagnostics left on the
    device, so a caller fetches n_intervals output intervals with one
    device-to-host copy.

    diags is ONE flat device tensor in f's dtype; fn.unpack(diags) splits it
    (or a host copy of it) into forces (K, 2) (fx and fy, what forces.csv
    records; zeros without an obstacle), max_vel (K,), stable (K,) (1 or 0),
    for thermal problems nusselt (K,), with params.probe_points probes
    (K, n_probes, 1 + D [+ 1]) and, with with_fields, rho (K, *spatial),
    u (K, D, *spatial) and, thermal, temp (K, *spatial): each taken at an
    interval's starting state, the reference's output cadence.
    sample(j, f), if given, sees the starting state of interval j before
    it is stepped (the Runner's Reynolds statistics, tpulbm's fn_stats).
    Port of sharded_step.make_super_chunk_fn; the Nusselt number and the
    probes ride the same round trip as there.
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
    probes = (diagnostics.probes_fn(problem)
              if problem.params.probe_points else None)
    size, unpack = super_layout(problem, n_intervals, with_fields)
    k = n_intervals

    def fn(f: torch.Tensor, sample=None):
        flat = torch.empty(size, dtype=f.dtype, device=f.device)
        views = unpack(flat)
        for j in range(k):
            if sample is not None:
                sample(j, f)
            if force is None:
                views["forces"][j] = 0.0
            else:
                views["forces"][j] = force(f)[:2]
            views["max_vel"][j] = max_vel(f)
            views["stable"][j] = stable(f)
            if nusselt is not None:
                views["nusselt"][j] = nusselt(f)
            if probes is not None:
                views["probes"][j] = probes(f)
            if fields is not None:
                views["rho"][j], views["u"][j] = fields(f)
            if temp is not None:
                views["temp"][j] = temp(f)
            f = chunk(f)
        return f, flat

    fn.unpack = unpack
    return fn


def super_layout(problem: Problem, k: int, with_fields: bool):
    """(size, unpack) of a super-chunk's flat diagnostics tensor for k
    intervals: per interval fx, fy, max |u|, stable (and Nu for a thermal
    problem, then each probe's values), then, with with_fields, rho, u
    (and temp) of every interval; unpack(flat) gives the views by name."""
    spatial = tuple(problem.spatial_shape)
    dims = problem.lattice.D
    cells = math.prod(spatial)
    thermal = problem.thermal is not None
    n_probes = len(problem.params.probe_points)
    width = 1 + dims + (1 if thermal else 0)   # rho, u[, T] a probe
    base = 5 if thermal else 4           # fx, fy, max |u|, stable[, Nu]
    per = base + n_probes * width
    n_scalar = per * k
    n_fields = (1 + dims + (1 if thermal else 0)) * k * cells
    size = n_scalar + (n_fields if with_fields else 0)

    def unpack(flat) -> dict:
        scalars = flat[:n_scalar].reshape(k, per)
        out = {"forces": scalars[:, :2], "max_vel": scalars[:, 2],
               "stable": scalars[:, 3]}
        if thermal:
            out["nusselt"] = scalars[:, 4]
        if n_probes:
            out["probes"] = scalars[:, base:].reshape(k, n_probes, width)
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

    return size, unpack
