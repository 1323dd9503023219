"""A copy of the benchmark's files at sizes a CPU test run can hold: the
same cells, configurations, metrics and limits, with each traffic mix cut
to a small grid and a short job."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = {
    "2048x512-bgk": dict(nx=120, ny=48, job_steps=400,
                         check_start_intervals=3),
    "4096x2048-bgk": dict(nx=120, ny=48, job_steps=400,
                          check_start_intervals=3),
    "256cube-bgk": dict(nx=40, ny=24, nz=24, job_steps=300,
                        check_start_intervals=2),
    "256cube-mrt": dict(nx=40, ny=24, nz=24, job_steps=300,
                        check_start_intervals=2),
}


def tiny_root(tmp_path: Path) -> Path:
    """tmp_path/ with BENCHMARK.json and lbmbench/'s data files, every
    traffic mix cut to TINY's sizes at an output interval of 20 steps."""
    root = Path(tmp_path)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "lbmbench", root / "lbmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, sizes in TINY.items():
        path = root / "lbmbench" / "traffic" / f"{name}.json"
        traffic = json.loads(path.read_text())
        traffic.update(sizes, output_frequency=20)
        path.write_text(json.dumps(traffic))
    return root
