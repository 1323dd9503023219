"""The harness on the CPU: BENCHMARK.json against the contract it is
written to, files found by name, the result line's keys, no result without
a card, and the imports of the harness and the reference compared by whole
top-level module names. A run on the card is marked requires_cuda."""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import pytest

from lbmbench import harness, spec
from lbmbench.tests.tiny import REPO, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["lbmbench"] and len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    # a full check of 24 cells (14 runs each) fits in 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 \
        <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["why"])
        assert TEXT.match(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        config = json.loads((REPO / c["file"]).read_text())
        assert set(c["reduced"]) == set(config["reduced"])
        names.add(c["name"])
    assert 1 <= cells <= 24
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        assert (REPO / "lbmbench" / "traffic" / f"{w['traffic']}.json"
                ).exists()
        assert (REPO / "lbmbench" / "limits" / f"{w['name']}.json").exists()
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == cells
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    cell_names = [w["name"] for w in b["workloads"]]

    def cells_of(m):
        assert set(m.get("workloads", cell_names)) <= set(cell_names)
        return set(m.get("workloads", cell_names))

    e2e = {m["name"]: cells_of(m) for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        # each cell that reads it reports the metric it moves
        assert TEXT.match(m["layer"]) and cells_of(m) <= e2e[m["moves"]]
        metrics_dir = REPO / "lbmbench" / "metrics"
        assert (metrics_dir / f"{m['name']}.py").exists() or \
            (metrics_dir / f"{m['name'].split('.')[0]}.py").exists()
    for cell in cell_names:
        assert cell in e2e["setup_s"]
        assert any(cell in c for n, c in e2e.items() if n != "setup_s")
        assert any(cell in cells_of(m) for m in b["per_layer"])
    # one layer, one name
    layers = {}
    for m in b["per_layer"]:
        assert layers.setdefault(m["name"].split(".")[0], m["layer"]) == \
            m["layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_file_name_is_made_of_name_characters():
    for path in (REPO / "lbmbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_a_new_configuration_traffic_and_metric_are_found_by_name(tmp_path):
    root = tiny_root(tmp_path)
    lb = root / "lbmbench"
    config = json.loads((lb / "configs" / "cyl2d.json").read_text())
    config.update(name="cyl2d-tau07", tau=0.7)
    (lb / "configs" / "cyl2d-tau07.json").write_text(json.dumps(config))
    traffic = json.loads((lb / "traffic" / "2048x512-bgk.json").read_text())
    traffic.update(nx=100, ny=40)
    (lb / "traffic" / "100x40-bgk.json").write_text(json.dumps(traffic))
    (lb / "metrics" / "answer.py").write_text(
        "def read(run):\n    return 42.0 + run.cell.steps\n")
    (lb / "limits" / "cyl2d-tau07-100x40.json").write_text(
        (lb / "limits" / "cyl2d-2048x512.json").read_text())
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="cyl2d-tau07",
                             file="lbmbench/configs/cyl2d-tau07.json"))
    b["workloads"].append({"name": "cyl2d-tau07-100x40",
                           "config": "cyl2d-tau07", "traffic": "100x40-bgk",
                           "chips": 1, "why": "a new cell"})
    b["end_to_end"].append({"name": "mlups.new", "unit": "MLUPS",
                            "better": "higher", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["cyl2d-tau07-100x40"]})
    b["per_layer"] += [
        {"name": "answer", "unit": "1", "better": "higher",
         "source": "program_counter", "layer": "Runner", "moves": "mlups.new",
         "workloads": ["cyl2d-tau07-100x40"]},
        {"name": "host_fetches_per_kstep.new", "unit": "1/kstep",
         "better": "lower", "source": "program_counter",
         "layer": "Runner", "moves": "mlups.new",
         "workloads": ["cyl2d-tau07-100x40"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("cyl2d-tau07-100x40", root)
    assert cell.config["tau"] == 0.7 and cell.traffic["nx"] == 100
    assert [m["name"] for m in cell.per_layer] == [
        "answer", "host_fetches_per_kstep.new"]
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "mlups.new"]
    assert "answer" not in [m["name"] for m in spec.load_cell(
        "cyl2d-2048x512", root).per_layer]
    out = harness.run_cell(cell, 7, 0.1, True, time.perf_counter(),
                           device="cpu", log=lambda s: None)
    assert out["metrics"]["answer"] == {"value": 442.0, "unit": "1"}
    # a split name is read by its base's reader
    assert out["metrics"]["host_fetches_per_kstep.new"]["value"] > 0
    out = harness.run_cell(cell, 7, 0.1, False, time.perf_counter(),
                           device="cpu", log=lambda s: None)
    assert set(out["metrics"]) == {"mlups.new", "setup_s"}


def test_the_warmup_lengths_of_the_cells():
    super_k = 8
    steps = {w["name"]: spec.warmup_steps(spec.load_cell(w["name"], REPO),
                                          super_k)
             for w in bench()["workloads"]}
    assert steps == {"cyl2d-2048x512": 1280, "sphere3d-256-bgk": 1400,
                     "cyl2d-4096x2048": 1360, "sphere3d-256-mrt": 1400}
    cell = spec.load_cell("cyl2d-2048x512", REPO)
    assert spec.warmup_steps(cell, None) == cell.steps


@pytest.mark.parametrize("name", ["cyl2d-2048x512", "sphere3d-256-bgk"])
def test_the_warmup_runs_every_chunk_length_of_a_job(tmp_path, name):
    from tpulbm_torch import runner as runner_mod
    from tpulbm_torch.config import SimulationParams
    cell = spec.load_cell(name, tiny_root(tmp_path))
    seen = []

    class Counting(runner_mod.Runner):
        def _chunk_fn(self, length):
            seen[-1].add(length)
            return super()._chunk_fn(length)

        def _super_fn(self, *args):
            seen[-1].add("super")
            return super()._super_fn(*args)

    for steps in (spec.warmup_steps(cell, runner_mod._SUPER_K), None):
        seen.append(set())
        assert Counting(SimulationParams.from_dict(spec.program_params(
            cell, 3, tmp_path / "job", steps)), device="cpu",
            verbose=False).run(resume=False).success
    assert seen[0] == seen[1] and "super" in seen[0]


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_contract_keys(tmp_path, trace):
    root = tiny_root(tmp_path)
    cell = spec.load_cell("cyl2d-2048x512", root)
    out = harness.run_cell(cell, 2 ** 31 + 5, 0.1, trace, time.perf_counter(),
                           device="cpu", log=lambda s: None)
    assert list(out) == KEYS + ["checks"]
    assert out["correct"] is True and out["attempted"] >= 1
    assert out["failed"] == 0
    names = [m["name"] for m in (cell.per_layer if trace else
                                 cell.end_to_end)]
    # on the CPU the trace holds no device events, so the device metrics
    # are left out
    assert set(out["metrics"]) <= set(names)
    if not trace:
        assert set(out["metrics"]) == {"mlups.2d", "setup_s"}
    assert list(out["checks"]) == ["force_start", "force_tail", "fields_u",
                                   "fields_rho", "rows"]
    assert ("busy_s" in out["device"]) == trace


def test_a_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "lbmbench.run", "--workload",
         "cyl2d-2048x512", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                          "HOME": str(REPO / "build")})
    assert proc.returncode != 0
    assert "device" not in proc.stdout and "{" not in proc.stdout


def top_level_modules(code: str) -> set:
    proc = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_neither_jax_nor_the_program():
    loaded = top_level_modules("import lbmbench.reference.lbm")
    assert not loaded & {"jax", "jaxlib", "flax", "tpulbm", "tpulbm_torch"}


def test_a_run_imports_no_jax_nor_the_jax_package(tmp_path):
    root = tiny_root(tmp_path)
    loaded = top_level_modules(
        "import time\nfrom pathlib import Path\n"
        "from lbmbench import control, harness, run, spec\n"
        f"cell = spec.load_cell('sphere3d-256-bgk', Path({str(root)!r}))\n"
        "harness.run_cell(cell, 3, 0.1, True, time.perf_counter(), "
        "device='cpu', log=lambda s: None)\n"
        "assert run.forbidden_modules() == []")
    assert "tpulbm_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "tpulbm"}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch finds no CUDA device)")


@pytest.mark.requires_cuda
def test_a_traced_run_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "-m", "lbmbench.run", "--workload",
         "cyl2d-2048x512", "--seed", "2147483650", "--seconds", "2",
         "--trace", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert out["correct"] is True and out["device"]["busy_s"] > 0
    assert {m["name"] for m in bench()["per_layer"]
            if "cyl2d-2048x512" in m.get("workloads", ["cyl2d-2048x512"])
            } == set(out["metrics"])
