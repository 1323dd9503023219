"""The check's control and faults at sizes a CPU run can hold, judged by
the cells' own limits (lbmbench/limits/): the control (the reference in
bfloat16 in the program's place) comes out not correct, and so does a run
whose timed path is broken underneath: a step that returns its state
unchanged, half of the domain left unstepped, the N=4 launches' outlet
columns left unstepped (far downstream of the cylinder), a field value or
a force row altered where it is written. A sound run of the same size is
correct.
The same control on the card, at each cell's size: python3 -m
lbmbench.control (its docstring)."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from lbmbench import check, harness, spec
from lbmbench.tests.tiny import tiny_root

CELLS = ["cyl2d-2048x512", "sphere3d-256-bgk", "cyl2d-4096x2048",
         "sphere3d-256-mrt"]
WRAPPERS = ("collide_stream", "collide_stream_blocked", "collide_stream_3d",
            "collide_stream_3d_blocked")


def run(root, name, seed=11):
    cell = spec.load_cell(name, root)
    return harness.run_cell(cell, seed, 0.1, False, time.perf_counter(),
                            device="cpu", log=lambda s: None)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_the_control_is_not(tmp_path, name):
    root = tiny_root(tmp_path)
    out = run(root, name)
    assert out["correct"] is True, out["checks"]
    cell = spec.load_cell(name, root)
    # the program's state where the check's tail starts, from a sound job
    from tpulbm_torch.config import SimulationParams
    from tpulbm_torch.runner import Runner
    keep = check.END_INTERVALS + 1
    runner = harness.observed(Runner, keep)(SimulationParams.from_dict(
        spec.program_params(cell, 11, tmp_path / "job")), device="cpu",
        verbose=False)
    assert runner.run(resume=False).success
    state, t_state = runner.kept_state()
    # one whole interval before the last force row
    assert t_state == (cell.steps - 1) // cell.freq * cell.freq - cell.freq
    values = check.control(spec.reference_params(cell, 11), cell.traffic,
                           state, t_state, "cpu", torch.bfloat16)
    ok, rows = check.verdict(values, cell.limits)
    assert not ok, rows


def _unchanged(orig):
    def step(f, out, *args, **kwargs):
        return out.copy_(f)
    return step


def _half(orig):
    def step(f, out, *args, **kwargs):
        res = orig(f, out, *args, **kwargs)
        half = f.shape[-2] // 2
        res[..., :half, :] = f[..., :half, :]
        return res
    return step


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("name", CELLS[:2])
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, name, fault):
    from tpulbm_torch.ops import step_cuda
    for w in WRAPPERS:
        monkeypatch.setattr(step_cuda, w, {"unchanged": _unchanged,
                                           "half": _half}[fault](
            getattr(step_cuda, w)))
    out = run(tiny_root(tmp_path), name)
    assert out["correct"] is False


def test_unstepped_outlet_columns_of_the_n4_launches_are_not_correct(
        tmp_path, monkeypatch):
    """A fault in the N=4 kernel that only the outlet's columns show, 96
    columns downstream of the cylinder: no signal from it reaches the
    cylinder's force rows that the reference follows from its own start,
    so only the tail's fields see it."""
    from tpulbm_torch.ops import step_cuda
    blocked = step_cuda.collide_stream_blocked

    def faulty(f, out, solid, consts, n_sub, *args, **kwargs):
        res = blocked(f, out, solid, consts, n_sub, *args, **kwargs)
        if n_sub == 4:
            res[..., -2:] = f[..., -2:]
        return res

    monkeypatch.setattr(step_cuda, "collide_stream_blocked", faulty)
    root = tiny_root(tmp_path)
    cell = spec.load_cell(CELLS[0], root)
    assert cell.traffic["nx"] - cell.traffic["nx"] * 0.2 > 90
    out = run(root, CELLS[0])
    assert out["correct"] is False
    assert out["checks"]["force_start"]["value"] <= \
        out["checks"]["force_start"]["limit"]


def test_an_altered_field_value_is_not_correct(tmp_path, monkeypatch):
    from tpulbm_torch.utils import io
    write = io.write_velocity_field

    def altered(ux, uy, rho, *args, **kwargs):
        ux = np.array(ux)
        ux[ux.shape[0] // 3, ux.shape[1] // 2] += 1e-4
        return write(ux, uy, rho, *args, **kwargs)

    monkeypatch.setattr(io, "write_velocity_field", altered)
    out = run(tiny_root(tmp_path), CELLS[0])
    assert out["correct"] is False
    assert out["checks"]["fields_u"]["value"] > \
        out["checks"]["fields_u"]["limit"]


def test_an_altered_3d_field_value_is_not_correct(tmp_path, monkeypatch):
    savez = np.savez

    def altered(path, **arrays):
        if "uz" in arrays:
            uz = np.array(arrays["uz"])
            uz[uz.shape[0] // 2, uz.shape[1] // 3, uz.shape[2] // 2] += 1e-4
            arrays["uz"] = uz
        return savez(path, **arrays)

    monkeypatch.setattr(np, "savez", altered)
    out = run(tiny_root(tmp_path), CELLS[1])
    assert out["correct"] is False


@pytest.mark.parametrize("row", [40, "last"])
def test_an_altered_force_row_is_not_correct(tmp_path, monkeypatch, row):
    from tpulbm_torch.utils import io
    record = io.ForceWriter.record
    root = tiny_root(tmp_path)
    cell = spec.load_cell(CELLS[0], root)
    t_bad = 40 if row == 40 else (cell.steps - 1) // cell.freq * cell.freq

    def altered(self, timestep, fx, fy, cd, cl):
        if timestep == t_bad:
            fx = fx * 1.1
        return record(self, timestep, fx, fy, cd, cl)

    monkeypatch.setattr(io.ForceWriter, "record", altered)
    out = run(root, CELLS[0])
    assert out["correct"] is False
