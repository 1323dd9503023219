"""CLI entry point, on the same flags as tpulbm's main.py.

    python -m tpulbm_torch --preset re200 --no-vtk
    python -m tpulbm_torch --preset cylinder-small --cpu --num-timesteps 200
    python -m tpulbm_torch --problem cylinder3d --nx 256 --ny 256 --nz 256 \\
        --inlet-velocity 0.05 --no-vtk
    python -m tpulbm_torch --preset cylinder3d-small --no-vtk
    python -m tpulbm_torch --preset rayleigh-benard --nx 2048 --ny 512 --no-vtk
    python -m tpulbm_torch --preset heated-cavity
    python -m tpulbm_torch --problem multiphase --shan-chen-g -5 --nx 2048 \\
        --ny 512 --tau 1.0 --inlet-velocity 0 --cylinder-radius 0.15 \\
        --cylinder-x 0.5 --cylinder-y 0.5 --num-timesteps 2240 \\
        --output-frequency 140 --no-vtk
    python -m tpulbm_torch --preset taylor-green --no-vtk
    python -m tpulbm_torch --preset kolmogorov --probe '0.5,0.25' --no-vtk
    python -m tpulbm_torch --preset kolmogorov3d --num-timesteps 2240 \
        --output-frequency 140 --stats-from 1120
    python -m tpulbm_torch --problem cylinder3d --nx 256 --ny 256 --nz 256 \
        --inlet-velocity 0.05 --lattice3d d3q27 --no-vtk
    python -m tpulbm_torch --problem cylinder3d --nx 256 --ny 256 --nz 256 \
        --inlet-velocity 0.05 --cylinder-radius 0.23 --lattice3d d3q27 \
        --obstacle-bc bouzidi --no-vtk
    python -m tpulbm_torch --problem passive-scalar --thermal-tau 0.6 \\
        --tau 0.8 --inlet-velocity 0.04 --cylinder-radius 0 --no-vtk

Runs on the first CUDA device; --cpu runs the plain PyTorch version on the
host instead (debugging). --mesh NYxNX runs every problem on a mesh of
shards, one per visible card (--mesh auto chooses the
shape for torch.cuda.device_count() cards, (n, 1) for a 3-D problem as
tpulbm's main.py); with --cpu the shards run on the host,
--cpu-devices N of them for --mesh auto. Flags of main.py that the port
does not cover yet raise NotImplementedError.

    python -m tpulbm_torch --preset scale-8m --mesh 2x2 --no-vtk
    python -m tpulbm_torch --preset cylinder-small --cpu --mesh 2x2
    python -m tpulbm_torch --preset kolmogorov3d --cpu --cpu-devices 4 \
        --mesh auto --num-timesteps 280
    python -m tpulbm_torch --preset rayleigh-benard --nx 2048 --ny 512 \
        --mesh 2x2 --no-vtk
    python -m tpulbm_torch --problem multiphase --shan-chen-g -5 --nx 2048 \
        --ny 512 --tau 1.0 --inlet-velocity 0 --cylinder-radius 0.15 \
        --cylinder-x 0.5 --cylinder-y 0.5 --mesh 4x1 --no-vtk
    python -m tpulbm_torch --problem cylinder3d --nx 128 --ny 128 --nz 128 \
        --inlet-velocity 0.05 --cylinder-radius 0.23 --lattice3d d3q27 \
        --obstacle-bc bouzidi --mesh 2x1 --no-vtk

--distributed runs one process of several (parallel/multihost.py):
torchrun, or RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set
by hand, describes them; each drives its run of the mesh's shards, NCCL
between cards, gloo with --cpu; process 0 prints and writes. --mesh auto
then divides the grid over the processes.

    torchrun --nproc-per-node 2 -m tpulbm_torch --distributed --cpu \
        --mesh 2x1 --preset cylinder-small
    torchrun --nproc-per-node 4 -m tpulbm_torch --distributed \
        --preset scale-8m --mesh 2x2 --no-vtk
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    from .config import add_cli_args
    parser = argparse.ArgumentParser(
        prog="python -m tpulbm_torch",
        description="tpulbm_torch — Lattice Boltzmann solver on PyTorch + "
                    "CUDA")
    add_cli_args(parser)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host CPU (plain PyTorch; debug)")
    parser.add_argument("--cpu-devices", type=int, default=0,
                        help="with --cpu: the number of host shards "
                             "--mesh auto divides the grid into")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace here")
    parser.add_argument("--no-resume", action="store_true",
                        help="start from t=0 even if --checkpoint-every is "
                             "set and a checkpoint exists")
    parser.add_argument("--distributed", action="store_true",
                        help="one of several processes (torchrun's "
                             "variables): NCCL between cards, gloo with "
                             "--cpu")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cpu_devices and not args.cpu:
        raise ValueError("--cpu-devices counts host shards; it needs --cpu")
    if args.cpu_devices and args.distributed:
        raise ValueError("--cpu-devices counts one process's host shards; "
                         "--distributed runs a shard a process")
    from .config import params_from_args
    from .parallel import multihost

    params = params_from_args(args)
    if args.distributed:
        multihost.initialize(cpu=args.cpu)
    try:
        return _run(args, params)
    finally:
        multihost.shutdown()


def _run(args, params) -> int:
    import torch

    from .parallel import multihost
    from .parallel.mesh import choose_decomposition
    from .runner import Runner
    from .utils.profiling import trace

    if args.mesh == "auto":
        # tpulbm's main.py:59-70: the 3-D kernels shard y only, every 2-D
        # decomposition runs the kernels, so the reference's chooser; the
        # world's devices, one a process, across several processes
        n_dev = (multihost.process_count() if args.distributed
                 else max(args.cpu_devices, 1) if args.cpu
                 else torch.cuda.device_count())
        if n_dev < 1:
            raise RuntimeError("--mesh auto found no CUDA device (use --cpu "
                               "for the host)")
        if params.is_3d and params.backend == "pallas" \
                and params.ny % n_dev == 0:
            params = params.replace(mesh_shape=(n_dev, 1))
        else:
            params = params.replace(mesh_shape=choose_decomposition(
                n_dev, params.nx, params.ny))
    runner = Runner(params, device="cpu" if args.cpu else "cuda")
    with trace(args.profile_dir):
        result = runner.run(resume=not args.no_resume)
    return 0 if result.success else 1


if __name__ == "__main__":
    sys.exit(main())
