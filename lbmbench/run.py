"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m lbmbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, with --trace 1 breakdown, and last the
checks: each number compared with its limit); the checks are also the last
lines of standard error. Without a card, or with fewer than the cell asks
for, it exits 2 and prints no result; if the process has loaded jax,
jaxlib, flax or tpulbm once the window has closed, it exits 3 and prints
none either.

The program's build caches live at fixed paths inside the checkout
(build/tpulbm_torch for nvcc's libraries, build/triton, build/torch_extensions),
so only the first run in a checkout builds.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tpulbm")


def pin_caches(root: Path) -> None:
    build = root / "build"
    os.environ["TPULBM_TORCH_BUILD_DIR"] = str(build / "tpulbm_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or
    tpulbm (compared whole: tpulbm_torch is the program)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    pin_caches(ROOT)

    import torch
    from lbmbench import harness, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"lbmbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch finds {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), T_PROCESS,
        device="cuda", log=lambda s: print(s, file=sys.stderr))
    bad = forbidden_modules()
    if bad:
        print(f"lbmbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for check in result["checks"].values():
        if check["value"] is not None and not math.isfinite(check["value"]):
            check["value"] = None
    try:
        with open("/proc/self/io") as fh:
            io = dict(line.split(": ") for line in fh.read().splitlines())
        print(f"write_bytes {int(io['write_bytes'])}", file=sys.stderr)
    except (OSError, KeyError, ValueError):
        pass
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
