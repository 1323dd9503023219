"""Where the device time of one Runner run goes.

    python -m tpulbm_torch.utils.profile_run --preset rayleigh-benard \\
        --nx 2048 --ny 512 --num-timesteps 2240 --output-frequency 140 \\
        --no-vtk

Takes the flags of `python -m tpulbm_torch` and runs on the first CUDA
device (without one it exits non-zero); with --mesh NYxNX and --one-card
every shard of the mesh runs on that card (Runner(devices=[cuda:0] * n)):

    python -m tpulbm_torch.utils.profile_run --preset scale-8m \\
        --mesh 2x2 --one-card --no-vtk

The configuration runs three times: once to warm up (kernel builds,
allocator), once unprofiled (wall time and runner MLUPS without the
profiler's overhead) and once under torch.profiler (CPU and CUDA
activity). It prints one JSON line: both runs' wall time and MLUPS, the device window of the profiled run (from
its first device event to its last), the time and count of each of the
port's kernels by name (every collision's library of a kernel under its
name: the run's collision is the line's `collision`), of the other
kernels (the diagnostics' plain PyTorch kernels), of copies and of sets,
the device's idle time, the window less the union of all device events,
and the host's time and count of each CUDA runtime call (a synchronize,
or a copy from pageable memory, is where the host waits for the card).
"""
from __future__ import annotations

import json
import os
import re
import sys
import tempfile

import torch

# the port's kernels, by a part of their mangled names
PORT_KERNELS = {"thermal_step_kernel": "thermal",
                # mangled (ILi1E) or demangled (<1,) template depth: the
                # D2Q9 march at one step, then at N
                r"d2q9_march_kernel(ILi1E|<1,)": "d2q9 1-step",
                "d2q9_march_kernel": "d2q9 N-step",
                "d3q19_step_kernel": "d3q19",
                r"d3q19_blocked_kernel(ILi2E|<2>)": "d3q19 N=2",
                r"d3q19_blocked_kernel(ILi3E|<3>)": "d3q19 N=3",
                "multiphase_step_kernel": "multiphase"}


def _group(event: dict) -> str:
    cat = event.get("cat", "")
    if cat == "gpu_memcpy":
        return "copies"
    if cat == "gpu_memset":
        return "sets"
    for part, name in PORT_KERNELS.items():
        if re.search(part, event.get("name", "")):
            return name
    return "other kernels"


def _busy(spans: list, lo: float, hi: float) -> float:
    """Length of the union of (start, end) spans, clipped to [lo, hi]."""
    busy, cur = 0.0, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        if a >= b:
            continue
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return busy + (0.0 if cur is None else cur[1] - cur[0])


def device_breakdown(trace_path: str) -> dict:
    """Device time (ms) of a chrome trace by group; the window from the
    first device event to the last and its idle time; and the stepping
    loop's window, from the first launch of a port kernel to the end of
    the last, with its idle time."""
    with open(trace_path) as fh:
        trace = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    events = [e for e in trace
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        raise RuntimeError("the trace holds no device events")
    groups: dict[str, dict] = {}
    spans, port = [], []
    for e in events:
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        spans.append(span)
        name = _group(e)
        if name in PORT_KERNELS.values():
            port.append(span)
        g = groups.setdefault(name, {"ms": 0.0, "count": 0})
        g["ms"] += float(e["dur"]) / 1e3
        g["count"] += 1
    runtime: dict[str, dict] = {}
    for e in trace:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            r = runtime.setdefault(e.get("name", "?"), {"ms": 0.0, "count": 0})
            r["ms"] += float(e.get("dur", 0.0)) / 1e3
            r["count"] += 1
    out = {"groups": groups, "runtime": runtime}
    windows = {"window": spans}
    if port:
        windows["loop"] = port
    for key, bounds in windows.items():
        lo, hi = min(a for a, _ in bounds), max(b for _, b in bounds)
        idle = (hi - lo) - _busy(spans, lo, hi)
        out[key] = {"ms": (hi - lo) / 1e3, "idle_ms": idle / 1e3,
                    "idle_share": idle / (hi - lo)}
    return out


def main(argv=None) -> int:
    from ..__main__ import build_parser
    from ..config import params_from_args
    from ..models import make_problem
    from ..ops.step_torch import collision_mode
    from ..runner import Runner

    if not torch.cuda.is_available():
        print("profile_run: torch finds no CUDA device", file=sys.stderr)
        return 1
    parser = build_parser()
    parser.add_argument("--one-card", action="store_true",
                        help="run every shard of --mesh on the first card")
    args = parser.parse_args(argv)
    params = params_from_args(args)
    n = params.mesh_shape[0] * params.mesh_shape[1]
    devices = [torch.device("cuda", 0)] * n if args.one_card else None

    def runner():
        return Runner(params, device="cuda", verbose=False, devices=devices)

    runs = []
    for _ in range(2):                           # warm-up, then unprofiled
        result = runner().run()
        if not result.success:
            return 1
        runs.append(result)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled = runner().run()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        out = device_breakdown(path)
    out.update({
        "device": torch.cuda.get_device_name(0),
        "collision": collision_mode(make_problem(params)),
        "mesh": list(params.mesh_shape), "one_card": args.one_card,
        "cells": params.num_cells, "steps": params.num_timesteps,
        "wall_s": runs[1].wall_seconds, "mlups": runs[1].mlups,
        "host_fetches": runs[1].host_fetches,
        "profiled_wall_s": profiled.wall_seconds,
        "profiled_mlups": profiled.mlups})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
