"""Time shapes of the N-step kernels on the card.

    python -m tpulbm_torch.utils.tile_sweep [--n 256] [--collision bgk]
        [--lattice d3q19] [--json PATH]
    python -m tpulbm_torch.utils.tile_sweep --lattice d2q9 [--collision bgk]
    python -m tpulbm_torch.utils.tile_sweep --one-step [--cases sphere,mrt]
    python -m tpulbm_torch.utils.tile_sweep --lattice d2q9 --one-step
        [--cases re200,kbc]
    python -m tpulbm_torch.utils.tile_sweep --multiphase

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
--one-step: builds csrc/step_d3q19.cu's z-march under other values of its
knobs (the tile height -DTPULBM_TILE_Y, the threads -DTPULBM_THREADS, the
march -DTPULBM_ZCHUNK, 0 the launcher's choice, the planes the pull
trails -DTPULBM_LAG)
for each of its cases (ONE_STEP_CASES: the sphere at 256^3 under BGK,
MRT, TRT, the power law and on D3Q27, one shard of the Bouzidi sphere at
256^3 on 2x2 with x rings, the 64^3 box with the z force under TRT),
each source of --sources under every knob set; holds the default build
to the plain step (one device) or the plain ring step (the shard) from a
seeded +-10% perturbed state, one N=2 and one N=3 launch of the N-step
kernel bitwise to 2 and 3 of its launches (one device) or its four
shards bitwise to one device (the shard), and every other variant bitwise
to the default build, and times them in turns.
--lattice d2q9 --one-step: builds csrc/step_d2q9.cu's row march at N = 1
under other values of its knobs (KNOBS_2D, VARIANTS_1_2D) for each of its
cases (ONE_STEP_2D_CASES: re200 at 2048x512 under BGK, KBC, the power law
and the Bouzidi cylinder, one shard of scale-8m on 2x2 with x rings and
its ranged launches on 4x1); holds the default build to the plain step
(one device) or the plain ring step (a shard: scale-8m's, Taylor-Green's
on 2x2 and the Bouzidi cylinder's on 1x2) from a seeded +-10%
perturbed state, one N=2 launch of the N-step kernel bitwise to 2 of its
launches (one device) or the shards bitwise to one device, every other
variant bitwise to the default build, and times them in turns on the
card's clock (`device_ms`).
--multiphase: builds csrc/step_multiphase.cu's row march under other
values of the same knobs (VARIANTS_MP) on the droplet at 2048x512 (one
device) and one shard of it on 4x1 and on 2x2 (x rings); holds the
default to the plain multiphase step or the plain ring step, the shards
bitwise to one device, every variant bitwise to the default, and times
them the same way.
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
from .ab_kernels import device_ms

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
SOURCE_2D = "step_d2q9_blocked.cu"
KNOBS_2D = ("WIDTH", "ROWS", "SEGMENT", "MIN_BLOCKS")
SOURCE_1 = "step_d3q19.cu"
KNOBS_1 = ("TILE_Y", "THREADS", "ZCHUNK", "LAG")
# (tile height, threads, march planes, planes the pull trails; -1 the
# source's default): the defaults first
VARIANTS_1 = [(-1, -1, -1, -1),
              (-1, -1, -1, 1), (-1, -1, -1, 2), (4, -1, -1, -1),
              (-1, -1, 8, -1), (-1, -1, 32, -1), (16, 512, -1, -1)]
# name -> (SimulationParams keywords, mesh shape or None)
ONE_STEP_CASES = {
    "sphere": (dict(problem="cylinder3d", nx=256, ny=256, nz=256,
                    inlet_velocity=0.05), None),
    "mrt": (dict(problem="cylinder3d", nx=256, ny=256, nz=256,
                 inlet_velocity=0.05, collision="mrt"), None),
    "trt": (dict(problem="cylinder3d", nx=256, ny=256, nz=256,
                 inlet_velocity=0.05, collision="trt"), None),
    "power_law": (dict(problem="cylinder3d", nx=256, ny=256, nz=256,
                       inlet_velocity=0.05, power_law_n=0.7), None),
    "d3q27": (dict(problem="cylinder3d", nx=256, ny=256, nz=256,
                   inlet_velocity=0.05, lattice3d="d3q27"), None),
    "bouzidi_2x2": (dict(problem="cylinder3d", nx=256, ny=256, nz=256,
                         inlet_velocity=0.05, cylinder_radius=0.23,
                         obstacle_bc="bouzidi"), (2, 2)),
    "box64_trt": (dict(preset="kolmogorov3d", nx=64, ny=64, nz=64,
                       collision="trt"), None),
}
# --lattice d2q9 --one-step and --multiphase: (the widened row, rows a
# march step, segment rows, blocks an SM asked of ptxas; -1 the source's
# default), the defaults first
# and the batches the copies run ahead, and (D2Q9) the Bouzidi link
# entries loaded a step ahead (KNOBS_MARCH)
KNOBS_MARCH = ("WIDTH", "ROWS", "SEGMENT", "MIN_BLOCKS", "AHEAD",
               "LINK_AHEAD")
VARIANTS_1_2D = [(-1, -1, -1, -1, -1), (-1, -1, -1, -1, 1),
                 (-1, -1, -1, -1, 3), (-1, -1, -1, -1, 4),
                 (96, -1, -1, -1, -1), (64, -1, -1, -1, -1),
                 (256, -1, -1, -1, -1), (-1, 2, -1, -1, -1),
                 (-1, -1, -1, 4, -1), (96, -1, -1, -1, 4)]
VARIANTS_MP = [(-1, -1, -1, -1, -1), (-1, -1, -1, -1, 1),
               (-1, -1, -1, -1, 3), (-1, -1, -1, -1, 6),
               (64, -1, -1, -1, -1), (96, -1, -1, -1, -1),
               (-1, 2, -1, -1, -1), (-1, -1, -1, 3, -1),
               (-1, -1, 8, -1, -1), (96, -1, -1, 3, -1)]
# name -> (SimulationParams keywords, mesh shape or None, ranged)
ONE_STEP_2D_CASES = {
    "re200": (dict(preset="re200"), None, False),
    "kbc": (dict(preset="re200", collision="kbc"), None, False),
    "power_law": (dict(preset="re200", power_law_n=0.7), None, False),
    "bouzidi": (dict(preset="re200", obstacle_bc="bouzidi"), None, False),
    "scale8m_2x2": (dict(preset="scale-8m"), (2, 2), False),
    "scale8m_4x1_overlap": (dict(preset="scale-8m"), (4, 1), True),
    "tg_2x2": (dict(problem="taylor-green", nx=2048, ny=512, tau=0.8,
                    inlet_velocity=0.04, periodic_x=True,
                    cylinder_radius=0.0), (2, 2), False),
    "bouzidi_1x2": (dict(preset="re200", obstacle_bc="bouzidi"), (1, 2),
                    False),
}
MP_CASES = {"droplet": None, "droplet_4x1": (4, 1), "droplet_2x2": (2, 2)}
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
                    help="d2q9 and --multiphase: the variants to build, as "
                         "'width,rows,segment,min_blocks[,ahead[,link_"
                         "ahead]];...' "
                         "(default VARIANTS_2D, VARIANTS_1_2D, VARIANTS_MP);"
                         " "
                         "--one-step: as 'tile_y,threads,zchunk,lag;...' "
                         "(default VARIANTS_1)")
    ap.add_argument("--one-step", action="store_true",
                    help="the 1-step D3Q19 kernel's z-march (csrc/"
                         "step_d3q19.cu) over ONE_STEP_CASES; with "
                         "--lattice d2q9 the 1-step D2Q9 row march "
                         "(csrc/step_d2q9.cu) over ONE_STEP_2D_CASES")
    ap.add_argument("--multiphase", action="store_true",
                    help="the Shan-Chen row march (csrc/step_multiphase.cu)"
                         " over MP_CASES")
    ap.add_argument("--cases", help="--one-step: the cases to run, "
                                    "comma-separated (default all)")
    ap.add_argument("--sources",
                    help="--one-step: the sources to build, comma-separated "
                         "names in csrc/ or paths (default step_d3q19.cu), "
                         "each under every variant; the first source's "
                         "first variant is the default build")
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
    if args.multiphase:
        return sweep_march_2d(args, card, dev, multiphase=True)
    if args.one_step and args.lattice == "d2q9":
        return sweep_march_2d(args, card, dev, multiphase=False)
    if args.one_step:
        return sweep_one_step(args, card, dev)
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


def _build_one_step(source, variant, defines):
    path = cuda_build.SOURCE_DIR / source   # a name in csrc/, or a path
    name = (f"tile_sweep_1_{path.stem}_" + "_".join(map(str, variant)) + "_"
            + "_".join(d.lstrip("-D").replace("=", "") for d in defines))
    out = cuda_build.build_dir() / "tile_sweep" / f"{name}.so"
    try:
        cuda_build.compile_library(path, out,
                                   defines + knob_defines(variant, KNOBS_1))
    except RuntimeError as err:   # e.g. a window that exceeds 227 KB
        return None, str(err).splitlines()[-1][:300]
    lib = step_cuda._bind_zmarch(ctypes.CDLL(str(out)))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    name = ("tpulbm_d3q19_step_rings" if "-DTPULBM_RINGS=1" in defines
            else "tpulbm_d3q19_step")
    getattr(lib, name).argtypes = (
        step_cuda._RINGS_ARGS_3D + step_cuda._CONSTS_ARGS_3D
        if "-DTPULBM_RINGS=1" in defines else
        [ptr, ptr, ptr, i32, i32, i32, f32, ptr, ptr, ptr, ptr, ptr, ptr,
         i32, i32, ptr])
    getattr(lib, name).restype = i32
    lib.tpulbm_cuda_error_string.argtypes = [i32]
    lib.tpulbm_cuda_error_string.restype = ctypes.c_char_p
    return lib, ptxas_lines(out.with_suffix(".log").read_text())


def ptxas_lines(log: str) -> str:
    """ptxas's report of a library's kernel: its stack frame, spills,
    registers and shared memory."""
    return "; ".join(ln.split("ptxas info    :")[-1].strip()
                     for ln in log.splitlines()
                     if "stack frame" in ln or "Used" in ln)


def _one_step_case(name, dev):
    """(problem, the launcher of a variant's library -> step(f, out), the
    default step the N-step kernel and one device are held to, the plain
    step, the state, the cells and the bound's bytes a step, the grid's
    cols, rows and planes) of a --one-step case."""
    from ..config import PRESETS
    from ..ops import bouzidi, step_rings_torch, step_torch
    from ..parallel import halo, mesh, sharded_step
    kw, shape = ONE_STEP_CASES[name]
    kw = dict(kw)
    preset = kw.pop("preset", None)
    params = (PRESETS[preset].replace(**kw) if preset
              else SimulationParams(**kw))
    problem = make_problem(params.replace(precision="f32",
                                          enable_vtk=False))
    f0 = state_from_numpy(problem.initial_state(), problem, dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    fp = f0 * (1 + 0.2 * (torch.rand(f0.shape, generator=gen, device=dev)
                          - 0.5))
    consts = step_cuda.kernel_constants(problem, 19)
    q = problem.lattice.Q
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    if shape is None:
        solid = torch.as_tensor(step_cuda.kernel_mask(problem), device=dev)
        links = (bouzidi.device_table(problem, dev)
                 if consts.variant & step_cuda.BOUZIDI else None)

        def launcher(lib):
            def step(f, out):
                rc = lib.tpulbm_d3q19_step(*step_cuda.launch_args(
                    f, out, solid, consts, 1, links, stream()))
                step_cuda._check_launch(lib, rc, f"one-step sweep {name}")
                return out
            return step
        plain = step_torch.make_step_rolled(problem, dev)
        nz, ny, nx = problem.spatial_shape
        return dict(problem=problem, launcher=launcher, plain=plain, f=fp,
                    cells=nz * ny * nx, grid=(nx, ny, nz),
                    nbytes=(8 * q + (0 if problem.solid is None else 1))
                    * nz * ny * nx + _link_bytes(solid, q))
    m = mesh.make_mesh(shape, devices=[dev] * (shape[0] * shape[1]))
    local = sharded_step.block_shape(problem, m)
    masks = halo.pad_mask(sharded_step.shard_mask(m, problem.solid),
                          periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, depth=1)
    geo = sharded_step.kernel_shards(problem, m, 1, True, masks)
    blocks = sharded_step.split(m, fp)
    rings = halo.exchange(blocks, eq_ring=problem.ghost_ring_values(),
                          depth=1, periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, x_rings=True)
    o = sharded_step.origin(m, local, 0, 0)
    ring_plain = step_rings_torch.make_ring_step(problem, o, local, 1,
                                                 masks[0][0], dev)

    def launcher(lib, shard=(0, 0)):
        iy, ix = shard
        b, r, g = blocks[iy][ix], rings[iy][ix], geo[iy][ix]

        def step(f, out):
            rc = lib.tpulbm_d3q19_step_rings(*step_cuda.ring_launch_args(
                b, out, r, g, consts, 1, stream=stream()))
            step_cuda._check_launch(lib, rc, f"one-step sweep {name}")
            return out
        return step

    def gathered(lib):
        outs = [[torch.empty_like(b) for b in row] for row in blocks]
        for iy, ix in m.shards():
            launcher(lib, (iy, ix))(None, outs[iy][ix])
        return sharded_step.gather(outs)

    nzl, nyl, nxl = local
    mask = geo[0][0].mask[:, 1:-1, 1:-1]
    return dict(problem=problem, launcher=launcher, gathered=gathered,
                plain=lambda f: ring_plain(blocks[0][0], *rings[0][0]),
                f=blocks[0][0], whole=fp, cells=nzl * nyl * nxl,
                grid=(nxl, nyl, nzl),
                nbytes=(8 * q + 1) * nzl * nyl * nxl
                + 2 * q * 4 * nzl * (nxl + 2 + nyl) + _link_bytes(mask, q))


def _link_bytes(mask, q: int) -> int:
    """The link table's bytes a step reads: (Q - 1) floats at each cell of
    the kernel mask that carries LINK_BIT."""
    return int((mask & step_cuda.LINK_BIT).ne(0).sum()) * (q - 1) * 4


def sweep_one_step(args, card: str, dev) -> int:
    """The 1-step D3Q19 kernel's variants (VARIANTS_1) over
    ONE_STEP_CASES."""
    names = args.cases.split(",") if args.cases else list(ONE_STEP_CASES)
    knobs = ([tuple(int(x) for x in v.split(",")) for v in
              args.variants.split(";")] if args.variants
             else VARIANTS_1[:1] if args.only_default else VARIANTS_1)
    sources = args.sources.split(",") if args.sources else [SOURCE_1]
    # every source under every knob set; the first is the default build
    variants = [(src, v) for src in sources for v in knobs]
    jobs, loads = [], []
    for name in names:
        kw, shape = ONE_STEP_CASES[name]
        kw = dict(kw)
        preset = kw.pop("preset", None)
        from ..config import PRESETS
        params = (PRESETS[preset].replace(**kw) if preset
                  else SimulationParams(**kw))
        c = step_cuda.StepConstants.of(make_problem(params.replace(
            precision="f32", enable_vtk=False)))
        defines = step_cuda.build_defines(
            c.mode, c.variant | (step_cuda.RINGS if shape else 0))
        jobs += [(name, sv, defines) for sv in variants]
        # the port's own libraries the default build is held to
        plain = step_cuda.build_defines(c.mode, c.variant)
        loads += [("step_d3q19.cu", plain)] + (
            [] if shape else [("step_d3q19_blocked.cu", plain)])
    with ThreadPoolExecutor(len(jobs) + len(loads)) as pool:
        for job in dict.fromkeys(loads):
            pool.submit(cuda_build.load, *job)
        built = list(pool.map(
            lambda j: _build_one_step(j[1][0], j[1][1], j[2]), jobs))
    libs = {(j[0], j[1]): b for j, b in zip(jobs, built)}
    result, ok = {"card": card, "cases": {}}, True
    for name in names:
        case = _one_step_case(name, dev)
        problem, f = case["problem"], case["f"]
        default = libs[name, variants[0]][0]
        base = case["launcher"](default)(f, torch.empty_like(f))
        want = case["plain"](f)
        torch.cuda.synchronize()
        tol = (dict(rtol=1e-4, atol=1e-7) if problem.params.power_law_n
               else dict(rtol=5e-6, atol=1e-7))
        err = float((base - want).abs().max())
        plain_ok = bool(torch.allclose(base, want, **tol))
        if "gathered" in case:   # the four shards against one device
            one = step_cuda.make_local_step_cuda_3d(problem, dev)
            whole = case["whole"]
            anchor = {1: bool(torch.equal(
                case["gathered"](default),
                one(whole, torch.empty_like(whole))))}
        else:
            anchor = {}
            for n in (2, 3):
                g = step_cuda.make_local_step_cuda_3d_blocked(problem, dev, n)
                got = case["launcher"](default)
                h = f
                for _ in range(n):
                    h = got(h, torch.empty_like(h))
                anchor[n] = bool(torch.equal(g(f, torch.empty_like(f)), h))
        rows = []
        for v in variants:
            lib, regs = libs[name, v]
            if lib is None:
                print(f"  {v}: not built: {regs}")
                continue
            nx, ny, nz = case["grid"]
            out = case["launcher"](lib)(f, torch.empty_like(f))
            torch.cuda.synchronize()
            march = lib.tpulbm_d3q19_grid(nx, ny, nz, 0)
            tx, ty = divmod(lib.tpulbm_d3q19_tile(), 256)
            rows.append(dict(
                source=v[0],
                variant=dict(zip(("tile_y", "threads", "zchunk", "lag"),
                                 v[1])),
                tile=(tx, ty), threads=lib.tpulbm_d3q19_threads(),
                lag=lib.tpulbm_d3q19_lag(),
                smem=lib.tpulbm_d3q19_smem_bytes(),
                resident=lib.tpulbm_d3q19_resident(0), march=march,
                blocks=-(-nx // tx) * -(-ny // ty) * -(-nz // march),
                bitwise=bool(torch.equal(out, base)), ptxas=regs, ms=[],
                lib=lib))
        order = list(range(len(rows)))
        for turn in (order, order[::-1]):
            for i in turn:
                rows[i]["ms"].append(_ms_per_step(
                    case["launcher"](rows[i]["lib"]), f, 1, 200))
        for r in rows:
            del r["lib"]
        bound = 1e3 * case["nbytes"] / 3.35e12
        print(f"{name} ({card}): the default within {err:.3e} of the plain "
              f"step ({'ok' if plain_ok else 'NOT within tolerance'}); "
              f"bitwise {anchor}; bound {bound:.5f} ms")
        for r in rows:
            print(f"  {r['source']} {r['variant']}: {min(r['ms']):.5f} "
                  f"ms/step {r['ms']} "
                  f"({100 * bound / min(r['ms']):.1f}% of the bound); tile "
                  f"{r['tile']} threads {r['threads']} lag {r['lag']} march "
                  f"{r['march']} blocks {r['blocks']} smem {r['smem']} "
                  f"resident {r['resident']}; bitwise {r['bitwise']}; "
                  f"ptxas {r['ptxas']}")
        ok = ok and plain_ok and all(anchor.values()) and all(
            r["bitwise"] for r in rows)
        result["cases"][name] = dict(max_abs_err=err, plain_ok=plain_ok,
                                     anchor=anchor, bound_ms=bound,
                                     variants=rows)
        del case
        torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    if not ok:
        print("tile_sweep: a variant or the default is not right")
        return 1
    return 0


def _build_march(source, variant, defines, multiphase):
    """A variant of the 1-step D2Q9 or the Shan-Chen row march: (library,
    ptxas's report) or (None, the error)."""
    name = (f"tile_sweep_{'mp' if multiphase else 'd2q9_1'}_"
            + "_".join(map(str, variant)) + "_"
            + "_".join(d.lstrip("-D").replace("=", "") for d in defines))
    out = cuda_build.build_dir() / "tile_sweep" / f"{name}.so"
    try:
        if not out.exists():   # cases of one build share it
            cuda_build.compile_library(
                cuda_build.SOURCE_DIR / source, out,
                defines + knob_defines(variant, KNOBS_MARCH))
    except RuntimeError as err:   # e.g. rings beyond 227 KB
        return None, str(err).splitlines()[-1][:300]
    lib = ctypes.CDLL(str(out))
    rings = "-DTPULBM_RINGS=1" in defines
    if multiphase:
        from ..ops import step_multiphase_cuda
        lib = step_multiphase_cuda._bind_march(lib)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = ("tpulbm_multiphase_step_rings" if rings
              else "tpulbm_multiphase_step")
        getattr(lib, fn).argtypes = (
            [ptr] * 6 + [i32] * 7 + [ptr, ptr, i32, ptr] if rings
            else [ptr, ptr, i32, i32, ptr, ptr, i32, ptr])
    else:
        lib = step_cuda._bind_march1(lib)
        fn = "tpulbm_d2q9_step_rings" if rings else "tpulbm_d2q9_step"
        getattr(lib, fn).argtypes = (
            step_cuda._RINGS_ARGS + step_cuda._CONSTS_ARGS if rings else
            _D2Q9_STEP_ARGS)
    getattr(lib, fn).restype = ctypes.c_int
    lib.tpulbm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpulbm_cuda_error_string.restype = ctypes.c_char_p
    return lib, ptxas_lines(out.with_suffix(".log").read_text())


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_D2Q9_STEP_ARGS = [_P, _P, _P, _I, _I, _F, _F, _F, _P, _P, _I, _P, _P, _F, _F,
                   _I, _P, _P, _I, _I, _P]


def _march_problem(name, multiphase):
    """(problem, mesh shape or None, ranged) of a --lattice d2q9 --one-step
    or --multiphase case."""
    from ..config import PRESETS
    if multiphase:
        params = SimulationParams(
            problem="multiphase", nx=2048, ny=512, tau=1.0,
            shan_chen_g=-5.0, inlet_velocity=0.0, cylinder_radius=0.15,
            cylinder_x=0.5, cylinder_y=0.5)
        shape, ranged = MP_CASES[name], False
    else:
        kw, shape, ranged = ONE_STEP_2D_CASES[name]
        kw = dict(kw)
        preset = kw.pop("preset", None)
        params = (PRESETS[preset].replace(**kw) if preset
                  else SimulationParams(**kw))
    return (make_problem(params.replace(precision="f32", enable_vtk=False)),
            shape, ranged)


def _march_defines(name, multiphase) -> tuple:
    """nvcc's defines of a case's library (its ring build on a mesh)."""
    problem, shape, _ = _march_problem(name, multiphase)
    rings = ("-DTPULBM_RINGS=1",) if shape else ()
    if multiphase:
        return rings
    c = step_cuda.StepConstants.of(problem)
    return step_cuda.build_defines(c.mode, c.variant) + rings


def _march_case(name, dev, multiphase):
    """A --lattice d2q9 --one-step or --multiphase case: (problem,
    launcher(lib) -> step(f, out) for shard (0, 0) or one device, the
    default's reference (the plain step or plain ring step of the state),
    anchor(lib) -> bool (N=2 bitwise 2 launches, or the shards bitwise one
    device), the state, its grid (cols, rows), the bound's bytes, the
    defines)."""
    import numpy as np
    from ..ops import bouzidi, step_multiphase, step_multiphase_cuda
    from ..ops import step_rings_torch, step_torch
    from ..parallel import halo, mesh, sharded_step
    problem, shape, ranged = _march_problem(name, multiphase)
    f0 = state_from_numpy(problem.initial_state(), problem, dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    fp = f0 * (0.9 + 0.2 * torch.rand(f0.shape, generator=gen, device=dev))
    if problem.solid is not None:
        solid = torch.as_tensor(problem.solid, device=dev)
        w = torch.as_tensor(problem.lattice.w, dtype=fp.dtype, device=dev)
        fp = torch.where(solid, w.view(-1, 1, 1), fp)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    defines = _march_defines(name, multiphase)
    if multiphase:
        consts = step_multiphase_cuda.MultiphaseConstants.of(problem)
        one_port = step_multiphase_cuda.make_local_step_multiphase_cuda(
            problem, dev)
    else:
        consts = step_cuda.kernel_constants(problem, 9)
        one_port = step_cuda.make_local_step_cuda(problem, dev)
    ny, nx = problem.spatial_shape
    if shape is None:
        if multiphase:
            def launcher(lib):
                def step(f, out):
                    rc = lib.tpulbm_multiphase_step(
                        f.data_ptr(), out.data_ptr(), nx, ny,
                        *consts.arrays, dev.index or 0, stream())
                    step_cuda._check_launch(lib, rc, f"sweep {name}")
                    return out
                return step
            plain = step_multiphase.make_step_multiphase(problem, dev)
            anchor = lambda lib: True   # noqa: E731 (no N-step kernel)
            nbytes = 72 * nx * ny
        else:
            solid = torch.as_tensor(step_cuda.kernel_mask(problem),
                                    device=dev)
            links = (bouzidi.device_table(problem, dev)
                     if consts.variant & step_cuda.BOUZIDI else None)

            def launcher(lib):
                def step(f, out):
                    rc = lib.tpulbm_d2q9_step(*step_cuda.launch_args(
                        f, out, solid, consts, 1, links, stream()))
                    step_cuda._check_launch(lib, rc, f"sweep {name}")
                    return out
                return step
            plain = step_torch.make_step_rolled(problem, dev)
            blocked = step_cuda.make_local_step_cuda_blocked(problem, dev, 2)

            def anchor(lib):
                one = launcher(lib)
                h = one(one(fp, torch.empty_like(fp)), torch.empty_like(fp))
                return bool(torch.equal(blocked(fp, torch.empty_like(fp)),
                                        h))
            nbytes = 73 * nx * ny + (
                0 if links is None else
                int((solid & step_cuda.LINK_BIT).ne(0).sum()) * 32)
        return dict(problem=problem, launcher=launcher,
                    want=plain(fp), anchor=anchor, f=fp, grid=(nx, ny),
                    nbytes=nbytes, defines=defines)
    m = mesh.make_mesh(shape, devices=[dev] * (shape[0] * shape[1]))
    local = sharded_step.block_shape(problem, m)
    nyl, nxl = local
    x_rings = shape[1] != 1
    depth = step_multiphase_cuda.DEPTH if multiphase else 1
    blocks = sharded_step.split(m, fp)
    rings = halo.exchange(blocks, eq_ring=problem.ghost_ring_values(),
                          depth=depth, periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, x_rings=x_rings)
    if multiphase:
        geo = {c: step_cuda.Shard(
            index=c, origin=sharded_step.origin(m, local, *c),
            local_shape=local, grid=tuple(problem.spatial_shape),
            depth=depth, x_rings=x_rings) for c in m.shards()}

        def launch(lib, b, out, r, c, rows=None):
            rc = lib.tpulbm_multiphase_step_rings(
                *step_multiphase_cuda.ring_args(b, out, r, geo[c], consts,
                                                dev.index or 0, stream()))
            step_cuda._check_launch(lib, rc, f"sweep {name}")
            return out
        ring_plain = step_multiphase.make_ring_step_multiphase(
            problem, geo[0, 0].origin, local, dev)
    else:
        solid = (np.zeros(problem.spatial_shape, bool)
                 if problem.solid is None else problem.solid)
        masks = halo.pad_mask(sharded_step.shard_mask(m, solid),
                              periodic_x=problem.periodic_x,
                              periodic_y=problem.periodic_y, depth=1)
        grid = sharded_step.kernel_shards(problem, m, 1, x_rings, masks)

        def launch(lib, b, out, r, c, rows=None):
            g = grid[c[0]][c[1]]
            step_cuda.check_shard(b, out, r, g, 1, rows or (0, nyl))
            rc = lib.tpulbm_d2q9_step_rings(*step_cuda.ring_launch_args(
                b, out, r, g, consts, 1, rows or (0, nyl), stream()))
            step_cuda._check_launch(lib, rc, f"sweep {name}")
            return out
        ring_plain = step_rings_torch.make_ring_step(
            problem, sharded_step.origin(m, local, 0, 0), local, 1,
            masks[0][0] if problem.solid is not None else None, dev)

    def shard_step(lib, c):
        b, r = blocks[c[0]][c[1]], rings[c[0]][c[1]]

        def step(f, out):
            if ranged:
                launch(lib, b, out, (None,) * 4, c, (2, nyl - 2))
                launch(lib, b, out, r, c, (0, 2))
                return launch(lib, b, out, r, c, (nyl - 2, nyl))
            return launch(lib, b, out, r, c)
        return step

    def anchor(lib):
        outs = [[torch.empty_like(b) for b in row] for row in blocks]
        for c in m.shards():
            shard_step(lib, c)(None, outs[c[0]][c[1]])
        return bool(torch.equal(sharded_step.gather(outs),
                                one_port(fp, torch.empty_like(fp))))
    hx = depth if x_rings else 0
    return dict(problem=problem, launcher=lambda lib: shard_step(lib, (0, 0)),
                want=ring_plain(blocks[0][0], *rings[0][0]), anchor=anchor,
                f=blocks[0][0], grid=(nxl, nyl),
                nbytes=(72 if multiphase else 73) * nxl * nyl
                + 36 * (2 * depth * (nxl + 2 * hx) + 2 * hx * nyl),
                defines=defines)


def sweep_march_2d(args, card: str, dev, multiphase: bool) -> int:
    """The 1-step D2Q9 row march's variants (VARIANTS_1_2D) over
    ONE_STEP_2D_CASES, or the Shan-Chen march's (VARIANTS_MP) over
    MP_CASES."""
    source = "step_multiphase.cu" if multiphase else "step_d2q9.cu"
    names = (args.cases.split(",") if args.cases
             else list(MP_CASES if multiphase else ONE_STEP_2D_CASES))
    variants = ([tuple(int(x) for x in v.split(",")) for v in
                 args.variants.split(";")] if args.variants
                else (VARIANTS_MP if multiphase else VARIANTS_1_2D))
    if args.only_default:
        variants = variants[:1]
    result, ok = {"card": card, "source": source, "cases": {}}, True
    # every case's variants (and the port's own libraries) at once
    jobs = list(dict.fromkeys((v, _march_defines(name, multiphase))
                              for name in names for v in variants))
    with ThreadPoolExecutor(32) as pool:
        built_all = dict(zip(jobs, pool.map(
            lambda j: _build_march(source, j[0], j[1], multiphase), jobs)))
    for name in names:
        case = _march_case(name, dev, multiphase)
        built = [built_all[v, case["defines"]] for v in variants]
        default = built[0][0]
        f = case["f"]
        base = case["launcher"](default)(f, torch.empty_like(f))
        torch.cuda.synchronize()
        tol = (dict(rtol=1e-4, atol=1e-7)
               if case["problem"].params.power_law_n
               else dict(rtol=5e-6, atol=1e-7))
        err = float((base - case["want"]).abs().max())
        plain_ok = bool(torch.allclose(base, case["want"], **tol))
        anchor = case["anchor"](default)
        rows, libs = [], []
        for v, (lib, regs) in zip(variants, built):
            if lib is None:
                print(f"  {v}: not built: {regs}")
                continue
            out = case["launcher"](lib)(f, torch.empty_like(f))
            torch.cuda.synchronize()
            nx, ny = case["grid"]
            if multiphase:
                shape = (lib.tpulbm_multiphase_width(),
                         lib.tpulbm_multiphase_rows(),
                         lib.tpulbm_multiphase_threads(),
                         lib.tpulbm_multiphase_smem_bytes(),
                         divmod(lib.tpulbm_multiphase_grid(nx, ny, 0),
                                65536))
            else:
                shape = (lib.tpulbm_d2q9_width(), lib.tpulbm_d2q9_rows(),
                         lib.tpulbm_d2q9_threads(),
                         lib.tpulbm_d2q9_smem_bytes(0),
                         divmod(lib.tpulbm_d2q9_grid(nx, ny, 0, 0), 65536))
            rows.append(dict(
                variant=dict(zip(("width", "rows", "segment", "min_blocks",
                                  "ahead", "link_ahead"), v)),
                shape=dict(zip(("width", "rows", "threads", "smem",
                                "strips_segments"), shape)),
                bitwise=bool(torch.equal(out, base)), ptxas=regs, ms=[]))
            libs.append(lib)
        order = list(range(len(rows)))
        for turn in (order, order[::-1]):
            for i in turn:
                rows[i]["ms"].append(device_ms(case["launcher"](libs[i]), f,
                                               200, 1))
        bound = 1e3 * case["nbytes"] / 3.35e12
        print(f"{name} ({card}): the default within {err:.3e} of the plain "
              f"step ({'ok' if plain_ok else 'NOT within tolerance'}); "
              f"anchor bitwise {anchor}; bound {bound:.5f} ms")
        for r in rows:
            print(f"  {r['variant']}: {min(r['ms']):.5f} ms/step {r['ms']} "
                  f"({100 * bound / min(r['ms']):.1f}% of the bound) on the "
                  f"card's clock; {r['shape']}; bitwise {r['bitwise']}; "
                  f"ptxas {r['ptxas']}")
        ok = ok and plain_ok and anchor and all(r["bitwise"] for r in rows)
        result["cases"][name] = dict(max_abs_err=err, plain_ok=plain_ok,
                                     anchor=anchor, bound_ms=bound,
                                     variants=rows)
        del case, libs
        torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    if not ok:
        print("tile_sweep: a variant or the default is not right")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
