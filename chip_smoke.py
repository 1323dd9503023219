#!/usr/bin/env python3
"""Quickest proof that tpulbm_torch runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda). Phases, each
printing its own line; any failure exits non-zero:

1. the card: torch.cuda must see it; nvidia-smi's name and power limit;
2. build: nvcc compiles tpulbm_torch/csrc/step_d2q9.cu (timed);
3. kernel against plain at 2048x512 (re200): one step from the initial
   state and one from a state the plain step advanced 500 steps, at
   rtol 5e-6 / atol 1e-7; then 280 steps of each (max error printed and
   bounded); then the port's Runner on a 64x32 cylinder through the
   kernel and through the plain step;
4. the main path: tpulbm_torch.runner.Runner on re200 at 2048x512 f32,
   2800 steps at output_frequency 140, no VTK; the kernel's launch count
   must be 2800 and every artifact finite;
5. timing: kernel and plain step at 2048x512, CUDA events, in turns
   plain, kernel, kernel, plain.

The last two lines are a JSON line per kernel and the result line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke"
ONE_STEP_TOL = dict(rtol=5e-6, atol=1e-7)
# 280 steps of f32 rounding differences (1/rho multiplied vs divided, sum
# order) from an impulsive start: a divergence bound, not a parity gate
DRIFT_280_BOUND = 1e-4


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_chunk(step, f: torch.Tensor, n: int) -> torch.Tensor:
    spare = torch.empty_like(f)
    for _ in range(n):
        f, spare = step(f, spare), f
    return f


def plain_chunk(step, f: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        f = step(f)
    return f


def ms_per_step(run, f: torch.Tensor, n: int) -> float:
    run(f.clone(), 20)                       # warm-up
    g = f.clone()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g = run(g, n)
    t1.record()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(g).all()), "timed run went non-finite")
    return t0.elapsed_time(t1) / n


def tiny_runner_agreement(dev) -> float:
    """The port's Runner through the kernel and through the plain step on
    a 64x32 cylinder, 60 steps: forces and final fields within rtol 1e-4 /
    atol 5e-6 and rtol 1e-5 / atol 5e-6. The atol covers near-zero values
    (uy ~ 1e-7) after 60 steps of f32 rounding differences between the
    kernel (1/rho multiplied) and the plain step (divided)."""
    from tpulbm_torch.config import SimulationParams
    from tpulbm_torch.runner import Runner

    out = {}
    for backend in ("pallas", "jax"):
        d = OUT_DIR / f"tiny_{backend}"
        p = SimulationParams(nx=64, ny=32, tau=0.6, inlet_velocity=0.05,
                             num_timesteps=60, output_frequency=20,
                             precision="f32", backend=backend,
                             enable_vtk=False, output_dir=str(d))
        require(Runner(p, device=dev, verbose=False).run().success,
                f"tiny run ({backend}) failed")
        out[backend] = (np.loadtxt(d / "forces.csv", delimiter=",",
                                   skiprows=1),
                        np.loadtxt(d / "velocity_field.csv", delimiter=",",
                                   skiprows=1))
    (fk, vk), (fp, vp) = out["pallas"], out["jax"]
    np.testing.assert_allclose(fk[:, 1:3], fp[:, 1:3], rtol=1e-4, atol=5e-6)
    np.testing.assert_allclose(vk, vp, rtol=1e-5, atol=5e-6)
    return float(np.abs(fk[:, 1:3] - fp[:, 1:3]).max())


def main() -> int:
    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from tpulbm_torch.config import PRESETS
    from tpulbm_torch.convert import state_from_numpy
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_cuda, step_torch
    from tpulbm_torch.runner import Runner
    from tpulbm_torch.utils import cuda_build

    # phase 2: build from the checkout's sources
    lib = cuda_build.load("step_d2q9.cu")
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {lib.path.name} in {lib.build_seconds:.2f} s "
          f"({'; '.join(ptxas)})")

    # phase 3: kernel against plain at the main path's shape
    params = PRESETS["re200"].replace(precision="f32", enable_vtk=False)
    problem = make_problem(params)
    kstep = step_cuda.make_local_step_cuda(problem, dev)
    pstep = step_torch.make_step_rolled(problem, dev)
    f0 = state_from_numpy(problem.initial_state(), problem, dev)

    def one_step_err(f: torch.Tensor) -> float:
        got = kstep(f, torch.empty_like(f))
        want = pstep(f)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **ONE_STEP_TOL)
        return float((got - want).abs().max())

    err_init = one_step_err(f0)
    f500 = plain_chunk(pstep, f0.clone(), 500)
    err_500 = one_step_err(f500)
    print(f"parity 1 step at {params.nx}x{params.ny}: max abs err "
          f"{err_init:.3e} from the initial state, {err_500:.3e} after 500 "
          f"plain steps (rtol 5e-6, atol 1e-7)")
    fk = kernel_chunk(kstep, f0.clone(), 280)
    fp = plain_chunk(pstep, f0.clone(), 280)
    torch.cuda.synchronize()
    err_280 = float((fk - fp).abs().max())
    require(np.isfinite(err_280) and err_280 < DRIFT_280_BOUND,
            f"280-step drift {err_280} beyond {DRIFT_280_BOUND}")
    print(f"parity 280 steps: max abs err {err_280:.3e} "
          f"(bound {DRIFT_280_BOUND})")
    err_tiny = tiny_runner_agreement(dev)
    print(f"runner 64x32, kernel vs plain: forces max abs diff "
          f"{err_tiny:.3e} (rtol 1e-4, atol 5e-6)")

    # phase 4: the main path, counted
    run_dir = OUT_DIR / "re200"
    main_params = params.replace(num_timesteps=2800, output_frequency=140,
                                 output_dir=str(run_dir))
    step_cuda.collide_stream.launches = 0
    t0 = time.perf_counter()
    result = Runner(main_params, device=dev).run()
    wall = time.perf_counter() - t0
    launches = step_cuda.collide_stream.launches
    require(result.success, "main-path run failed")
    require(launches == 2800, f"kernel launched {launches} times, not 2800")
    forces = np.loadtxt(run_dir / "forces.csv", delimiter=",", skiprows=1)
    require(forces.shape == (20, 5), f"forces.csv shape {forces.shape}")
    require(list(forces[:, 0].astype(int)) == list(range(0, 2800, 140)),
            "forces.csv timesteps")
    require(bool(np.isfinite(forces).all()), "forces.csv not finite")
    field = np.loadtxt(run_dir / "velocity_field.csv", delimiter=",",
                       skiprows=1)
    require(field.shape == (params.nx * params.ny, 6),
            f"velocity_field.csv shape {field.shape}")
    require(bool(np.isfinite(field).all()), "velocity_field.csv not finite")
    print(f"main path: re200 {params.nx}x{params.ny} f32, 2800 steps, "
          f"{launches} kernel launches, {wall:.2f} s wall, runner "
          f"{result.mlups:.1f} MLUPS, final C_D {forces[-1, 3]:.6f}")

    # phase 5: timing, in turns
    n_kernel, n_plain = 2000, 500
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "kernel":
            times[which].append(ms_per_step(
                lambda f, n: kernel_chunk(kstep, f, n), f0, n_kernel))
        else:
            times[which].append(ms_per_step(
                lambda f, n: plain_chunk(pstep, f, n), f0, n_plain))
    k_ms, p_ms = min(times["kernel"]), min(times["plain"])
    cells = params.nx * params.ny
    print(f"timing at {params.nx}x{params.ny} on {card}: kernel "
          f"{k_ms:.5f} ms/step = {cells / k_ms / 1e3:.1f} MLUPS "
          f"(runs {times['kernel']}), plain {p_ms:.5f} ms/step = "
          f"{cells / p_ms / 1e3:.1f} MLUPS (runs {times['plain']})")

    print(json.dumps({"kernels": [{
        "name": "d2q9_collide_stream", "route": "cuda",
        "source": step_cuda.KERNEL_SOURCE, "replaces": step_cuda.REPLACES,
        "launches": launches, "max_abs_err": max(err_init, err_500),
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
