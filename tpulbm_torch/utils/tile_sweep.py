"""Time shapes of the N-step kernels on the card.

    python -m tpulbm_torch.utils.tile_sweep [--n 256] [--collision bgk]
        [--lattice d3q19] [--json PATH]
    python -m tpulbm_torch.utils.tile_sweep --lattice d2q9 [--collision bgk]

D3Q19 and D3Q27: builds csrc/step_d3q19_blocked.cu under other values of
its knobs (the thread-block cluster -DTPULBM_CLUSTER_X/_Y, the block's
tile height -DTPULBM_TILE_Y, its threads -DTPULBM_THREADS and its z-march
-DTPULBM_ZCHUNK), one nvcc each, all at once; checks every build at N = 2
and 3 bitwise against N launches of the 1-step kernel on the sphere in a
duct at n^3 (bench.py's d3q19 row at the default n = 256), from the state
after 20 steps, and times them in turns with CUDA events: ms per step,
the lower of two turns, beside the 1-step kernel. The first variant is the
source's defaults; cluster 1 x 1 stands for the lone block's trapezoid.
D2Q9: builds csrc/step_d2q9_blocked.cu's row march under other values of
its knobs (stage 0's widened row -DTPULBM_WIDTH, the strip being N columns
narrower a side; the rows a march step -DTPULBM_ROWS, a thread a stage,
column and row; the segment -DTPULBM_SEGMENT, 0 the launcher's choice;
the blocks an SM asked of ptxas -DTPULBM_MIN_BLOCKS, 0 none), checks each at N = 2, 3, 4 bitwise against N 1-step
launches on re200 at 2048x512 and times them the same way.
Prints the card (`nvidia-smi` name and power limit), one line per variant
(ms per step, the shape, shared memory, resident blocks or clusters,
ptxas's registers and spills) and one JSON line; needs a CUDA card and
nvcc.
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
SOURCE_2D = "step_d2q9_blocked.cu"
KNOBS_2D = ("WIDTH", "ROWS", "SEGMENT", "MIN_BLOCKS")
# (stage 0's widened row, rows a march step, segment rows, blocks an SM
# asked of ptxas, -1 the source's default): the defaults first
VARIANTS_2D = [(96, 1, 0, -1),
               (64, 1, 0, -1), (128, 1, 0, -1), (96, 2, 0, -1),
               (96, 1, 0, 0), (96, 1, 0, 2), (96, 1, 32, -1),
               (96, 1, 64, -1)]


def knob_defines(variant, knobs=KNOBS) -> tuple[str, ...]:
    """The -D defines of a variant's knobs; a negative value keeps the
    source's default."""
    return tuple(f"-DTPULBM_{k}={v}" for k, v in zip(knobs, variant)
                 if v >= 0)


def _build_2d(variant, defines):
    name = "tile_sweep_2d_" + "_".join(map(str, variant))
    out = cuda_build.build_dir() / "tile_sweep" / f"{name}.so"
    cuda_build.compile_library(cuda_build.SOURCE_DIR / SOURCE_2D, out,
                               defines + knob_defines(variant, KNOBS_2D))
    lib = step_cuda._bind_march(ctypes.CDLL(str(out)))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpulbm_d2q9_step_blocked.argtypes = [
        ptr, ptr, ptr, i32, i32, i32, f32, f32, f32, ptr, ptr, i32, ptr, ptr,
        f32, f32, i32, ptr, ptr, i32, i32, ptr]
    lib.tpulbm_d2q9_step_blocked.restype = i32
    lib.tpulbm_cuda_error_string.argtypes = [i32]
    lib.tpulbm_cuda_error_string.restype = ctypes.c_char_p
    return lib, ptxas_by_depth(out.with_suffix(".log").read_text())


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


def ptxas_by_depth(log: str) -> dict:
    """ptxas's registers and spill stores of each depth's kernel in a
    library's log, as {N: '128 regs, 0 B spills'} (the 2-D kernel's with
    the clean corners under 'Nc')."""
    out, depth, spill = {}, 0, "?"
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            m = re.search(r"ILi(\d+)E(Lb1E)?", ln)
            depth = (0 if m is None else f"{m.group(1)}c" if m.group(2)
                     else int(m.group(1)))
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
    ap.add_argument("--lattice", default="d3q19",
                    choices=("d3q19", "d3q27", "d2q9"))
    ap.add_argument("--only-default", action="store_true",
                    help="the defaults and the lone blocks at 512 threads "
                         "only")
    ap.add_argument("--obstacle-bc", default="equilibrium",
                    help="d2q9: the cylinder's obstacle rule (equilibrium, "
                         "bounce_back or bouzidi)")
    ap.add_argument("--variants",
                    help="d2q9: the variants to build, as "
                         "'width,rows,segment,min_blocks;...' (default "
                         "VARIANTS_2D)")
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
    if args.lattice == "d2q9":
        return sweep_2d(args, card, dev)
    n = args.n
    problem = make_problem(SimulationParams(
        problem="cylinder3d", nx=n, ny=n, nz=n, inlet_velocity=0.05,
        precision="f32", enable_vtk=False, lattice3d=args.lattice,
        **_collision_kw(args.collision)))
    consts = step_cuda.StepConstants.of(problem)
    defines = step_cuda.build_defines(consts.mode, consts.variant)
    variants = VARIANTS[:3] if args.only_default else VARIANTS
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda v: _build(v, defines), variants))

    solid = torch.as_tensor(step_cuda.kernel_mask(problem), device=dev)
    one = step_cuda.make_local_step_cuda_3d(problem, dev)

    f0 = _launches(one, state_from_numpy(problem.initial_state(), problem,
                                         dev), 20)

    def blocked(lib, depth):
        def step(f, out):
            rc = lib.tpulbm_d3q19_step_blocked(*step_cuda.launch_args(
                f, out, solid, consts, depth, None,
                torch.cuda.current_stream(dev).cuda_stream))
            step_cuda._check_launch(lib, rc, f"tile sweep N={depth}")
            return out
        return step

    ref = {d: _launches(one, f0.clone(), d) for d in (2, 3)}
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
        one_ms.append(_ms_per_step(one, f0, 1, 300))
        for i in turn:
            for d in (2, 3):
                rows[i]["ms"][d].append(
                    _ms_per_step(blocked(built[i][0], d), f0, d, 300))
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


def _collision_kw(collision: str) -> dict:
    return {"smagorinsky": dict(smagorinsky=0.17),
            "power_law": dict(power_law_n=0.7)}.get(
        collision, dict(collision=collision))


def _launches(step, f, count):
    spare = torch.empty_like(f)
    for _ in range(count):
        f, spare = step(f, spare), f
    return f


def _ms_per_step(step, f0, depth, steps):
    """ms per step of `steps` steps of `step` (one launch is `depth`
    steps) from f0, CUDA events, after a warm-up."""
    _launches(step, f0.clone(), 10)
    g = f0.clone()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    _launches(step, g, steps // depth)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (steps // depth * depth)


def sweep_2d(args, card: str, dev) -> int:
    """The D2Q9 row march's variants (VARIANTS_2D) on re200 at 2048x512."""
    from ..config import PRESETS
    from ..ops import bouzidi
    depths = (2, 3, 4)
    problem = make_problem(PRESETS["re200"].replace(
        precision="f32", enable_vtk=False, obstacle_bc=args.obstacle_bc,
        **_collision_kw(args.collision)))
    consts = step_cuda.StepConstants.of(problem)
    defines = step_cuda.build_defines(consts.mode, consts.variant)
    links = (bouzidi.device_table(problem, dev)
             if consts.variant & step_cuda.BOUZIDI else None)
    variants = ([tuple(int(x) for x in v.split(","))
                 for v in args.variants.split(";")] if args.variants
                else VARIANTS_2D[:1] if args.only_default else VARIANTS_2D)
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda v: _build_2d(v, defines), variants))
    solid = torch.as_tensor(step_cuda.kernel_mask(problem), device=dev)
    one = step_cuda.make_local_step_cuda(problem, dev)
    f0 = _launches(one, state_from_numpy(problem.initial_state(), problem,
                                         dev), 200)

    def blocked(lib, depth):
        def step(f, out):
            rc = lib.tpulbm_d2q9_step_blocked(*step_cuda.launch_args(
                f, out, solid, consts, depth, links,
                torch.cuda.current_stream(dev).cuda_stream))
            step_cuda._check_launch(lib, rc, f"tile sweep N={depth}")
            return out
        return step

    ref = {d: _launches(one, f0.clone(), d) for d in depths}
    rows = []
    for variant, (lib, regs) in zip(variants, built):
        row = dict(zip(("width", "rows", "segment", "min_blocks"), variant))
        row.update(
            threads={d: lib.tpulbm_d2q9_blocked_threads(d) for d in depths},
            smem={d: lib.tpulbm_d2q9_blocked_smem_bytes(d, 0)
                  for d in depths},
            grid={d: divmod(lib.tpulbm_d2q9_blocked_grid(
                d, problem.params.nx, problem.params.ny, 0, 0), 65536)
                for d in depths},
            registers=regs, ms={d: [] for d in depths})
        for d in depths:
            got = blocked(lib, d)(f0, torch.empty_like(f0))
            torch.cuda.synchronize()
            row[f"bitwise_n{d}"] = bool(torch.equal(got, ref[d]))
        rows.append(row)
    one_ms = []
    order = list(range(len(rows)))
    for turn in (order, order[::-1]):
        one_ms.append(_ms_per_step(one, f0, 1, 1200))
        for i in turn:
            for d in depths:
                rows[i]["ms"][d].append(
                    _ms_per_step(blocked(built[i][0], d), f0, d, 1200))
    print(f"{args.collision} {args.obstacle_bc} d2q9 re200 2048x512: "
          f"1-step {min(one_ms)} "
          f"ms/step {one_ms}")
    for row in rows:
        print(f"width {row['width']} rows {row['rows']} threads "
              f"{row['threads']} segment {row['segment']} min blocks "
              f"{row['min_blocks']}: "
              + ", ".join(f"N={d} {min(row['ms'][d])} {row['ms'][d]}"
                          for d in depths)
              + f"; (strips, segments) {row['grid']}; smem {row['smem']}; "
              f"bitwise "
              f"{[row[f'bitwise_n{d}'] for d in depths]}; ptxas "
              f"{row['registers']}")
    line = json.dumps({"card": card, "lattice": "d2q9",
                       "collision": args.collision,
                       "obstacle_bc": args.obstacle_bc, "one_step_ms": one_ms,
                       "variants": rows})
    print(line)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    if not all(r[f"bitwise_n{d}"] for r in rows for d in depths):
        print("tile_sweep: a variant is not bitwise equal to N 1-step "
              "launches")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
