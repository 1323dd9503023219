"""A cell of BENCHMARK.json and the files it names, found by name: its
configuration (`file` of its `configs` entry), its traffic mix
(traffic/<traffic>.json), its limits (limits/<workload>.json) and its
metrics (the entries of `end_to_end` and `per_layer` that apply to it, each
per-layer metric read by metrics/<name>.py). The seed draws the inputs both
the program and the reference get."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path

    @property
    def steps(self) -> int:
        return int(self.traffic["job_steps"])

    @property
    def freq(self) -> int:
        return int(self.traffic["output_frequency"])

    @property
    def cells(self) -> int:
        t = self.traffic
        return int(t["nx"]) * int(t["ny"]) * max(1, int(t.get("nz", 0)))

    @property
    def step_kind(self) -> str:
        """The yardstick's key for one step's bytes and operations."""
        kind = self.config["lattice"].lower()
        mode = self.traffic.get("collision", "bgk")
        return kind if mode == "bgk" else f"{kind}_{mode}"


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path) -> Cell:
    """The workload `name` of root/BENCHMARK.json with its files, which lie
    in root/lbmbench. Raises KeyError for an unknown workload."""
    bench_dir = Path(root) / HERE.name
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    config = json.loads((Path(root) / conf["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{work['traffic']}.json").read_text())
    limits_path = bench_dir / "limits" / f"{name}.json"
    limits = (json.loads(limits_path.read_text())
              if limits_path.exists() else {})
    return Cell(name=name, chips=int(work["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                bench_dir=bench_dir)


def draws(cell: Cell, seed: int) -> dict:
    """The seed's offsets of the obstacle's centre and scale of the inlet
    velocity, each uniform in its band of the configuration."""
    rng = np.random.default_rng(seed % 2 ** 64)
    bands = cell.config["seed_bands"]
    return {key: float(rng.uniform(*bands[key]))
            for key in ("cylinder_x", "cylinder_y", "inlet_velocity_scale")}


def physics(cell: Cell, seed: int) -> dict:
    """The parameters the program and the reference share."""
    c, t = cell.config, cell.traffic
    d = draws(cell, seed)
    return {"nx": int(t["nx"]), "ny": int(t["ny"]), "nz": int(t.get("nz", 0)),
            "tau": float(c["tau"]),
            "inlet_velocity": float(c["inlet_velocity"])
            * d["inlet_velocity_scale"],
            "cylinder_x": float(c["cylinder_x"]) + d["cylinder_x"],
            "cylinder_y": float(c["cylinder_y"]) + d["cylinder_y"],
            "cylinder_radius": float(c["cylinder_radius"]),
            "collision": t.get("collision", "bgk")}


def warmup_steps(cell: Cell, super_k: int | None) -> int:
    """The warm-up job's length: one super-chunk of the program's `super_k`
    output intervals, then the chunk lengths of a job's tail (a whole
    interval, and the remainder up to the job's end, which the Runner takes
    as all but one step and then the last step). The whole job where
    `super_k` is unknown."""
    if not super_k:
        return cell.steps
    rest = cell.steps - (cell.steps - 1) // cell.freq * cell.freq
    return min(cell.steps, (super_k + 1) * cell.freq + rest)


def program_params(cell: Cell, seed: int, output_dir: str,
                   steps: int | None = None) -> dict:
    """The program's SimulationParams fields for one job of the cell (of
    `steps` steps where given: the warm-up's)."""
    c, t = cell.config, cell.traffic
    out = physics(cell, seed)
    out.update(problem=c["problem"], obstacle_bc=c["obstacle_bc"],
               precision=c["precision"], backend="pallas",
               num_timesteps=int(steps or t["job_steps"]),
               output_frequency=int(t["output_frequency"]),
               output_dir=str(output_dir), enable_vtk=False)
    return out


def reference_params(cell: Cell, seed: int) -> dict:
    out = physics(cell, seed)
    if "mrt_rates" in cell.traffic:
        out["mrt_rates"] = dict(cell.traffic["mrt_rates"])
    return out
