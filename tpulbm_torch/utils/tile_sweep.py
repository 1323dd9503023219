"""Time shapes of the N-step D3Q19 kernel on the card.

    python -m tpulbm_torch.utils.tile_sweep [--n 256] [--collision bgk]
        [--lattice d3q19] [--json PATH]

Builds csrc/step_d3q19_blocked.cu under other values of its knobs (the
thread-block cluster -DTPULBM_CLUSTER_X/_Y, the block's tile height
-DTPULBM_TILE_Y, its threads -DTPULBM_THREADS and its z-march
-DTPULBM_ZCHUNK), one nvcc each, all at once; checks every build at N = 2
and 3 bitwise against N launches of the 1-step kernel on the sphere in a
duct at n^3 (bench.py's d3q19 row at the default n = 256), from the state
after 20 steps, and times them in turns with CUDA events: ms per step,
the lower of two turns, beside the 1-step kernel. The first variant is the
source's defaults; cluster 1 x 1 stands for the lone block's trapezoid.
Prints the card (`nvidia-smi` name and power limit), one line per variant
(ms per step, tile, shared memory, resident clusters, ptxas's registers and
spills) and one JSON line; needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..config import SimulationParams
from ..convert import state_from_numpy
from ..models import make_problem
from ..ops import step_cuda
from . import cuda_build

SOURCE = "step_d3q19_blocked.cu"
KNOBS = ("TILE_Y", "CLUSTER_X", "CLUSTER_Y", "THREADS", "ZCHUNK")
DEFAULT = (16, 1, 2, 512, 64)
# (tile height, cluster x, cluster y, threads, z-march): the defaults first
VARIANTS = [DEFAULT,
            (16, 1, 1, 512, 64), (8, 1, 1, 512, 64),     # lone blocks
            (8, 1, 1, 256, 64),
            (8, 1, 2, 512, 64), (8, 1, 2, 384, 64), (8, 1, 2, 256, 64),
            (16, 1, 2, 384, 64), (16, 1, 4, 512, 64), (8, 2, 1, 512, 64),
            (8, 2, 2, 512, 64), (8, 2, 4, 512, 64), (4, 2, 2, 256, 64),
            (16, 1, 2, 512, 32), (16, 1, 2, 512, 128)]


def knob_defines(variant) -> tuple[str, ...]:
    return tuple(f"-DTPULBM_{k}={v}" for k, v in zip(KNOBS, variant))


def _build(variant, defines):
    name = "tile_sweep_" + "_".join(map(str, variant))
    out = cuda_build.build_dir() / "tile_sweep" / f"{name}.so"
    cuda_build.compile_library(cuda_build.SOURCE_DIR / SOURCE, out,
                               defines + knob_defines(variant))
    lib = step_cuda._bind_scratch(ctypes.CDLL(str(out)))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpulbm_d3q19_step_blocked.argtypes = [
        ptr, ptr, ptr, i32, i32, i32, i32, f32, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, ptr, ctypes.c_longlong, i32, ptr]
    lib.tpulbm_d3q19_step_blocked.restype = i32
    lib.tpulbm_cuda_error_string.argtypes = [i32]
    lib.tpulbm_cuda_error_string.restype = ctypes.c_char_p
    return lib, ptxas_by_depth(out.with_suffix(".log").read_text())


def ptxas_by_depth(log: str) -> dict[int, str]:
    """ptxas's registers and spill stores of each depth's kernel in a
    library's log, as {N: '128 regs, 0 B spills'}."""
    out, depth, spill = {}, 0, "?"
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            m = re.search(r"ILi(\d+)E", ln)
            depth = int(m.group(1)) if m else 0
        elif "spill stores" in ln:
            spill = ln.split("bytes spill stores")[0].split(",")[-1].strip()
        elif "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out[depth] = f"{regs} regs, {spill} B spills"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=256, help="grid edge")
    ap.add_argument("--collision", default="bgk",
                    help="bgk, trt, mrt, regularized, smagorinsky or "
                         "power_law")
    ap.add_argument("--lattice", default="d3q19", choices=("d3q19", "d3q27"))
    ap.add_argument("--only-default", action="store_true",
                    help="the defaults and the lone blocks at 512 threads "
                         "only")
    ap.add_argument("--json", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep: torch finds no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    n = args.n
    kw = {"smagorinsky": dict(smagorinsky=0.17),
          "power_law": dict(power_law_n=0.7)}.get(
        args.collision, dict(collision=args.collision))
    problem = make_problem(SimulationParams(
        problem="cylinder3d", nx=n, ny=n, nz=n, inlet_velocity=0.05,
        precision="f32", enable_vtk=False, lattice3d=args.lattice, **kw))
    consts = step_cuda.StepConstants.of(problem)
    defines = step_cuda.build_defines(consts.mode, consts.variant)
    variants = VARIANTS[:3] if args.only_default else VARIANTS
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda v: _build(v, defines), variants))

    solid = torch.as_tensor(step_cuda.kernel_mask(problem), device=dev)
    one = step_cuda.make_local_step_cuda_3d(problem, dev)

    def launches(step, f, count):
        spare = torch.empty_like(f)
        for _ in range(count):
            f, spare = step(f, spare), f
        return f

    f0 = launches(one, state_from_numpy(problem.initial_state(), problem,
                                        dev), 20)

    def blocked(lib, depth):
        def step(f, out):
            rc = lib.tpulbm_d3q19_step_blocked(*step_cuda.launch_args(
                f, out, solid, consts, depth, None,
                torch.cuda.current_stream(dev).cuda_stream))
            step_cuda._check_launch(lib, rc, f"tile sweep N={depth}")
            return out
        return step

    def ms_per_step(step, depth, steps=300):
        launches(step, f0.clone(), 10)           # warm-up
        g = f0.clone()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        launches(step, g, steps // depth)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / (steps // depth * depth)

    ref = {d: launches(one, f0.clone(), d) for d in (2, 3)}
    rows = []
    for variant, (lib, regs) in zip(variants, built):
        row = dict(zip(("tile_y", "cluster_x", "cluster_y", "threads",
                        "zchunk"), variant))
        row.update(
            tile={d: divmod(lib.tpulbm_d3q19_blocked_tile(d), 256)
                  for d in (2, 3)},
            smem={d: lib.tpulbm_d3q19_blocked_smem_bytes(d) for d in (2, 3)},
            active_clusters={d: lib.tpulbm_d3q19_blocked_active_clusters(
                d, 0) for d in (2, 3)},
            registers=regs, ms={2: [], 3: []})
        for d in (2, 3):
            got = blocked(lib, d)(f0, torch.empty_like(f0))
            torch.cuda.synchronize()
            row[f"bitwise_n{d}"] = bool(torch.equal(got, ref[d]))
        rows.append(row)
    one_ms = []
    order = list(range(len(rows)))
    for turn in (order, order[::-1]):
        one_ms.append(ms_per_step(one, 1))
        for i in turn:
            for d in (2, 3):
                rows[i]["ms"][d].append(
                    ms_per_step(blocked(built[i][0], d), d))
    print(f"{args.collision} {args.lattice} n={n}: 1-step {min(one_ms)} "
          f"ms/step {one_ms}")
    for row in rows:
        print(f"cluster {row['cluster_x']}x{row['cluster_y']} tile_y "
              f"{row['tile_y']} threads {row['threads']} zchunk "
              f"{row['zchunk']}: N=2 {min(row['ms'][2])} ms/step "
              f"{row['ms'][2]}, N=3 {min(row['ms'][3])} {row['ms'][3]}; "
              f"tiles {row['tile']}; smem {row['smem']}; resident clusters "
              f"{row['active_clusters']}; bitwise {row['bitwise_n2']}/"
              f"{row['bitwise_n3']}; ptxas {row['registers']}")
    result = {"card": card, "n": n, "collision": args.collision,
              "lattice": args.lattice, "one_step_ms": one_ms,
              "variants": rows}
    line = json.dumps(result)
    print(line)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    if not all(r["bitwise_n2"] and r["bitwise_n3"] for r in rows):
        print("tile_sweep: a variant is not bitwise equal to N 1-step "
              "launches")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
