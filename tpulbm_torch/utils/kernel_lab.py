"""The D3Q19 phase lab: where a 1-step D3Q19 kernel's time goes.

    python -m tpulbm_torch.utils.kernel_lab [--size 256] [--iters 30]
        [--repeats 3] [--variants dma,collide,stream,bcs,full] [--cpu]

Port of scripts/kernel_lab.py. One step of a mask-free D3Q19 duct (tau
0.6, inlet u 0.05) over a state padded by H = 8 rows above and below in
y, (19, nz, ny + 2H, nx), with its phases switched on and off (VARIANTS):
`dma` copies, `collide` adds the BGK collision, `stream` the pull with
the frozen equilibrium at the z edges, `bcs` tpulbm's strip ops (x-edge
sanitize, y walls at rows 0 and ny - 1, z walls, equilibrium inlet,
zero-gradient outlet), `full` all three. Only the rows [H, H + ny) are
written; the output buffer starts as a copy of the input, so the pad rows
of chained iterations stay defined (tpulbm's hold garbage; its centre
rows are the same).

On the card each variant runs its CUDA kernel (csrc/kernel_lab_d3q19.cu,
the geometry of the 1-step D3Q19 kernel before its redesign: 32 x 4
tiles, 64-plane marches, a ring of three collided planes), is first held
against its plain version (plain_lab) on the same input at rtol 5e-6 /
atol 1e-7, and is timed with CUDA events around `iters` chained launches
(ping-pong), the best of `repeats`. With --cpu the plain version runs on
the host (a rehearsal: its times are the host's). One JSON line per
variant with tpulbm's keys (variant, size, ty: the CUDA tile's height,
iters, mlups_effective, raw_gpops, dma_gbs_min, best_s) and the device
it ran on, ms per iteration, the kernel's error against its plain version
and, on the card, its share of the byte bound (152 B a cell over 3.35
TB/s). A diagnostic: no run of the port launches the lab.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import time

import numpy as np
import torch

from .. import lattice as lat_mod
from .. import physics
from . import cuda_build

SOURCE = "tpulbm_torch/csrc/kernel_lab_d3q19.cu"
REPLACES = "scripts/kernel_lab.py:56"       # make_lab_kernel
H = 8            # pad rows above and below in y, as tpulbm's lab
TAU = 0.6
U_IN = 0.05
TILE_Y = 4       # the CUDA tile's height (kernel_lab_d3q19.cu kBY)
TILE_X = 32
Z_CHUNK = 64
VARIANTS = {
    "dma": dict(do_collide=False, do_stream=False, do_bcs=False),
    "collide": dict(do_collide=True, do_stream=False, do_bcs=False),
    "stream": dict(do_collide=False, do_stream=True, do_bcs=False),
    "bcs": dict(do_collide=False, do_stream=False, do_bcs=True),
    "full": dict(do_collide=True, do_stream=True, do_bcs=True),
}
TOL = dict(rtol=5e-6, atol=1e-7)
HBM_BYTES_PER_S = 3.35e12
BYTES_PER_CELL = 19 * 4 * 2      # 19 f32 read and written once


def eq_in() -> np.ndarray:
    """(19,) float32: the inlet equilibrium at rho 1, u = (U_IN, 0, 0),
    computed as tpulbm's lab computes it (float64, rounded once)."""
    lat = lat_mod.D3Q19
    cu = lat.c[:, 0] * U_IN
    return (lat.w * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * U_IN * U_IN)
            ).astype(np.float32)


def plain_lab(f: torch.Tensor, variant: str) -> torch.Tensor:
    """One lab step of `variant` of the padded f (19, nz, ny + 2H, nx):
    a new tensor, f's pad rows and the step's rows [H, H + ny)."""
    do = VARIANTS[variant]
    lat = lat_mod.D3Q19
    nz, rows, nx = f.shape[1:]
    ny = rows - 2 * H
    eq = [float(v) for v in eq_in()]
    g = physics.collide(lat, f, 1.0 / TAU) if do["do_collide"] else f
    if do["do_stream"]:
        planes = []
        for i in range(lat.Q):
            cx, cy, cz = (int(v) for v in lat.c[i])
            s = torch.roll(g[i, :, H - cy:H - cy + ny], (cz, cx), (0, 2))
            if cz > 0:
                s[0] = eq[i]
            elif cz < 0:
                s[nz - 1] = eq[i]
            planes.append(s)
        s = torch.stack(planes)
    else:
        s = g[:, :, H:H + ny].clone()
    if do["do_bcs"]:
        opp = [int(o) for o in lat.opposite]
        for i in range(lat.Q):
            cx, cy, cz = (int(v) for v in lat.c[i])
            if cx:
                col = 0 if cx > 0 else nx - 1
                s[i, :, :, col] = 0.0
                if cz > 0:
                    s[i, 0, :, col] = eq[i]
                elif cz < 0:
                    s[i, nz - 1, :, col] = eq[i]
            if cy > 0:
                s[i, :, 0] = s[opp[i], :, 0]
            elif cy < 0:
                s[i, :, ny - 1] = s[opp[i], :, ny - 1]
        for i in range(lat.Q):
            if lat.c[i][2] > 0:
                s[i, 0] = s[opp[i], 0]
        for i in range(lat.Q):
            if lat.c[i][2] < 0:
                s[i, nz - 1] = s[opp[i], nz - 1]
        for i in range(lat.Q):
            s[i, :, :, 0] = eq[i]
            s[i, :, :, nx - 1] = s[i, :, :, nx - 2]
    out = f.clone()
    out[:, :, H:H + ny] = s
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("kernel_lab_d3q19.cu").lib
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpulbm_kernel_lab_d3q19.argtypes = [p, p, i32, i32, i32, i32, f32, p,
                                            p, i32, p]
    lib.tpulbm_kernel_lab_d3q19.restype = i32
    lib.tpulbm_cuda_error_string.argtypes = [i32]
    lib.tpulbm_cuda_error_string.restype = ctypes.c_char_p
    held = (lib.tpulbm_kernel_lab_pad(), lib.tpulbm_kernel_lab_tile_y())
    if held != (H, TILE_Y):
        raise RuntimeError(f"kernel_lab_d3q19.cu holds (H, tile height) "
                           f"{held}, not {(H, TILE_Y)}")
    return lib


def lab_step(f: torch.Tensor, out: torch.Tensor,
             variant: str) -> torch.Tensor:
    """One lab step of `variant` from the padded f into the rows
    [H, H + ny) of out; returns out (whose pad rows it leaves as they
    are). On a CUDA tensor: launches the lab kernel on the current stream
    (no synchronization) and raises if the launch is refused; counted in
    lab_step.launches. On a CPU tensor: the plain version."""
    q, nz, rows, nx = f.shape
    if (q != 19 or rows <= 2 * H or nx < 3 or f.dtype != torch.float32
            or not f.is_contiguous() or out.shape != f.shape
            or out.dtype != f.dtype or not out.is_contiguous()
            or out.device != f.device or out.data_ptr() == f.data_ptr()):
        raise ValueError(f"the lab takes a contiguous float32 (19, nz, ny + "
                         f"{2 * H}, nx >= 3) state and an output of its "
                         f"shape, got {tuple(f.shape)} {f.dtype}")
    if f.device.type == "cpu":
        new = plain_lab(f, variant)
        out[:, :, H:rows - H] = new[:, :, H:rows - H]
        return out
    lib = _library()
    index = list(VARIANTS).index(variant)
    w = (ctypes.c_float * 19)(*lat_mod.D3Q19.w.astype(np.float32))
    eq = (ctypes.c_float * 19)(*eq_in())
    rc = lib.tpulbm_kernel_lab_d3q19(
        f.data_ptr(), out.data_ptr(), nx, rows - 2 * H, nz, index, 1.0 / TAU,
        eq, w, f.device.index or 0,
        torch.cuda.current_stream(f.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lab kernel ({variant}) launch failed: "
                           + lib.tpulbm_cuda_error_string(rc).decode())
    lab_step.launches[variant] += 1
    return out


lab_step.launches = dict.fromkeys(VARIANTS, 0)


def lab_input(n: int, device, seed: int = 0) -> torch.Tensor:
    """The padded (19, n, n + 2H, n) input of an n^3 lab, uniform in
    [0.02, 0.08) (positive, so the collision's 1/rho is safe), made from
    `seed` on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f = torch.rand((19, n, n + 2 * H, n), generator=gen, device=device)
    return f.mul_(0.06).add_(0.02)


def chained(f: torch.Tensor, variant: str, iters: int) -> torch.Tensor:
    """`iters` chained lab steps from f (ping-pong over two buffers that
    start as copies of f)."""
    a, b = f.clone(), f.clone()
    for _ in range(iters):
        a, b = lab_step(a, b, variant), a
    return a


def loaded_per_cell(variant: str) -> float:
    """Cells a CUDA block loads (and collides, where it collides) for each
    cell it writes: the variants that stream load a one-cell halo around
    the 32 x 4 tile and one plane before and after its 64-plane march."""
    if not VARIANTS[variant]["do_stream"]:
        return 1.0
    return ((TILE_X + 2) * (TILE_Y + 2) / (TILE_X * TILE_Y)
            * (Z_CHUNK + 2) / Z_CHUNK)


def run(n: int, iters: int, repeats: int, variants: list[str],
        device) -> list[dict]:
    """The lab's JSON rows at n^3 on `device` (see the module's
    docstring)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    label = torch.cuda.get_device_name(device) if cuda else "cpu"
    f = lab_input(n, device)
    cells = n ** 3
    bound_ms = cells * BYTES_PER_CELL / HBM_BYTES_PER_S * 1e3
    rows = []
    for name in variants:
        got = lab_step(f, f.clone(), name)
        want = plain_lab(f, name)
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, **TOL)
        chained(f, name, 2)                      # warm-up
        best = float("inf")
        for _ in range(repeats):
            a, b = f.clone(), f.clone()
            if cuda:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(device)
                t0.record()
                for _ in range(iters):
                    a, b = lab_step(a, b, name), a
                t1.record()
                torch.cuda.synchronize(device)
                seconds = t0.elapsed_time(t1) / 1e3
            else:
                start = time.perf_counter()
                for _ in range(iters):
                    a, b = lab_step(a, b, name), a
                seconds = time.perf_counter() - start
            best = min(best, seconds)
        ms = best / iters * 1e3
        row = {"variant": name, "size": n, "ty": TILE_Y, "iters": iters,
               "mlups_effective": cells * iters / best / 1e6,
               "raw_gpops": cells * iters * 19 * loaded_per_cell(name)
               / best / 1e9,
               "dma_gbs_min": cells * iters * 19 * 4
               * (loaded_per_cell(name) + 1) / best / 1e9,
               "best_s": best, "device": label, "ms": ms,
               "max_abs_err": err}
        if cuda:
            row["bound_ms"] = bound_ms
            row["bound_share"] = bound_ms / ms
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256, help="cube edge")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--cpu", action="store_true",
                    help="the plain version on the host (a rehearsal)")
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"kernel_lab: unknown variants {unknown}")
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("kernel_lab: torch finds no CUDA device (--cpu "
                         "runs the plain version on the host)")
    device = "cpu" if args.cpu else torch.device("cuda", 0)
    for row in run(args.size, args.iters, args.repeats, variants, device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
