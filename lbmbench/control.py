"""Readings for the limits of a cell's check: the program's and the
control's, seed by seed, one job each at the cell's own size.

    python3 -m lbmbench.control --workload <cell> --seeds 11,12,13 \
        --control 3 [--out readings.jsonl]

For each seed it runs one job of the cell through the Runner (as a window's
job), then compares what it wrote with the float64 reference (the
program's readings); for the first `--control` seeds it also puts the
control in the program's place, the reference computed in bfloat16 from
its own start and from the program's state that the check starts its tail
from (check.py), and
compares that with the float64 reference (the control's readings). One
JSON line a seed on standard output, and in --out where given. The
benchmark's runs never run it; its CPU counterpart is
tests/test_lbmbench_control.py.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time

from . import check, harness, spec
from .run import ROOT, pin_caches


def readings(cell: spec.Cell, seed: int, with_control: bool, device) -> dict:
    import torch
    from tpulbm_torch.config import SimulationParams
    from tpulbm_torch.runner import Runner

    with tempfile.TemporaryDirectory(prefix="lbmbench-") as out_dir:
        keep = check.END_INTERVALS + 1
        runner = harness.observed(Runner, keep)(SimulationParams.from_dict(
            spec.program_params(cell, seed, out_dir)), device=device,
            verbose=False)
        t0 = time.perf_counter()
        result = runner.run(resume=False)
        job_s = time.perf_counter() - t0
        state, t_state = runner.kept_state()
        del runner
        gc.collect()
        ref_params = spec.reference_params(cell, seed)
        out = {"seed": seed, "success": result.success, "job_s": job_s,
               "t_state": t_state,
               "program": check.compare(ref_params, cell.traffic, out_dir,
                                        state, t_state, device)}
        if with_control:
            out["control"] = check.control(ref_params, cell.traffic, state,
                                           t_state, device, torch.bfloat16)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True,
                        help="comma-separated seeds")
    parser.add_argument("--control", type=int, default=3,
                        help="seeds (the first ones) to run the control on")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    pin_caches(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("lbmbench.control: torch finds no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    try:
        for k, seed in enumerate(seeds):
            line = json.dumps({"workload": args.workload, **readings(
                cell, seed, k < args.control, "cuda")})
            print(line, flush=True)
            if sink is not None:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
