"""Time tilings of the N-step D3Q19 kernel on the card.

    python -m tpulbm_torch.utils.tile_sweep [--n 256] [--json PATH]

Builds copies of csrc/step_d3q19_blocked.cu with other tile heights
(kBY) and z-march lengths (kZChunk), one nvcc each, all
at once; checks every copy at N = 2 and 3 bitwise against N launches of
the 1-step kernel on the sphere in a duct at n^3 (bench.py's d3q19 row at
the default n = 256), and times them in turns with CUDA events: ms per
step, the lower of two turns, beside the 1-step kernel. The first variant
is the source as it stands. Prints the card (`nvidia-smi` name and power
limit), one line per variant and one JSON line; needs a CUDA card and
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
_HEIGHT = re.compile(r"constexpr int kBY = (\d+);")
_ZCHUNK = re.compile(r"constexpr int kZChunk = (\d+);")
# (tile height, z-planes a block marches over): every tile height 2, 4, 8
# with every march 32, 64, 128
VARIANTS = [(by, z) for by in (2, 4, 8) for z in (32, 64, 128)]


def variant_source(text: str, by: int, zchunk: int) -> str:
    text, n1 = _HEIGHT.subn(f"constexpr int kBY = {by};", text)
    text, n2 = _ZCHUNK.subn(f"constexpr int kZChunk = {zchunk};", text)
    if (n1, n2) != (1, 1):
        raise RuntimeError(f"{SOURCE}: tile constants not found")
    return text


def _build(variant: tuple[int, int], text: str):
    name = "tile_sweep_{}_{}".format(*variant)
    src = cuda_build.build_dir() / "tile_sweep" / f"{name}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(variant_source(text, *variant))
    out = src.with_suffix(".so")
    cuda_build.compile_library(src, out)
    lib = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpulbm_d3q19_step_blocked.argtypes = [
        ptr, ptr, ptr, i32, i32, i32, i32, f32, ptr, ptr, ptr, ptr, ptr, i32,
        i32, ptr]
    lib.tpulbm_d3q19_step_blocked.restype = i32
    lib.tpulbm_d3q19_blocked_smem_bytes.argtypes = [i32]
    lib.tpulbm_cuda_error_string.argtypes = [i32]
    lib.tpulbm_cuda_error_string.restype = ctypes.c_char_p
    regs = [ln.split(":", 1)[-1].strip()
            for ln in out.with_suffix(".log").read_text().splitlines()
            if "registers" in ln]
    return lib, regs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=256, help="grid edge")
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
    text = (cuda_build.SOURCE_DIR / SOURCE).read_text()
    shipped = (int(_HEIGHT.search(text).group(1)),
               int(_ZCHUNK.search(text).group(1)))
    variants = [shipped] + [v for v in VARIANTS if v != shipped]
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda v: _build(v, text), variants))

    n = args.n
    problem = make_problem(SimulationParams(
        problem="cylinder3d", nx=n, ny=n, nz=n, inlet_velocity=0.05,
        precision="f32", enable_vtk=False))
    consts = step_cuda.StepConstants.of(problem)
    solid = torch.as_tensor(problem.solid, device=dev).to(torch.uint8)
    f0 = state_from_numpy(problem.initial_state(), problem, dev)
    one = step_cuda.make_local_step_cuda_3d(problem, dev)

    def blocked(lib, depth):
        def step(f, out):
            rc = lib.tpulbm_d3q19_step_blocked(
                f.data_ptr(), out.data_ptr(), solid.data_ptr(), n, n, n,
                depth, *consts.d3q19_args, None, 0, 0,
                torch.cuda.current_stream(dev).cuda_stream)
            step_cuda._check_launch(lib, rc, f"tile sweep N={depth}")
            return out
        return step

    def launches(step, f, count):
        spare = torch.empty_like(f)
        for _ in range(count):
            f, spare = step(f, spare), f
        return f

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
        row = {"by": variant[0], "zchunk": variant[1],
               "smem": {d: lib.tpulbm_d3q19_blocked_smem_bytes(d)
                        for d in (2, 3)},
               "registers": regs, "ms": {2: [], 3: []}}
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
    for row in rows:
        print(f"BY {row['by']} zchunk {row['zchunk']}: N=2 "
              f"{min(row['ms'][2]):.5f} ms/step {row['ms'][2]}, N=3 "
              f"{min(row['ms'][3]):.5f} {row['ms'][3]}; smem {row['smem']}; "
              f"bitwise {row['bitwise_n2']}/{row['bitwise_n3']}; "
              f"{'; '.join(row['registers'])}")
    result = {"card": card, "n": n, "one_step_ms": one_ms, "variants": rows}
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
