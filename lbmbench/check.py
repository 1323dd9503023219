"""The comparison that decides `correct`.

What the window's last job wrote is held against the plain reference
(reference/lbm.py) in float64:

- force_start: the forces.csv rows of the first `check_start_intervals`
  output intervals (t = 0, freq, ...) against the reference run from its
  own start: the largest gap in drag or lift over the rows, over the
  force scale 1/2 U^2 A (A = 2r in 2-D, pi r^2 in 3-D): a gap of the drag
  or lift coefficient.
- force_tail: the forces.csv rows from t_state to the last force row
  against the reference followed from the program's own state at t_state,
  which the harness keeps (the reference cannot follow a whole job within
  a run's time). t_state lies END_INTERVALS output intervals before the
  last force row, so that the reference follows one whole interval of the
  job's main loop (its chunk and kernels) besides the job's remainder.
- fields_u, fields_rho: the final fields (velocity_field.csv in 2-D,
  fields3d.npz in 3-D) against the reference stepped from that state to
  the job's end: the largest gap of a velocity component over the inlet
  velocity, and of the density.
- rows: forces.csv rows missing, extra or not finite (an exact count).

The control puts the reference computed in bfloat16 in the program's
place: its own start for the first rows, the program's state at t_state
for the rest (control.py, tests/test_lbmbench_control.py)."""
from __future__ import annotations

import os

import numpy as np
import torch

from .reference.lbm import Case

END_INTERVALS = 1
NAMES = ("force_start", "force_tail", "fields_u", "fields_rho", "rows")


class Outputs:
    """What a job produced: force rows {t: (drag, lift)} and the final
    fields (rho, u (D, ...))."""

    def __init__(self, forces: dict, rho: np.ndarray, u: np.ndarray):
        self.forces, self.rho, self.u = forces, rho, u

    @classmethod
    def from_files(cls, out_dir: str, shape: tuple) -> "Outputs":
        rows = np.loadtxt(os.path.join(out_dir, "forces.csv"), delimiter=",",
                          skiprows=1, ndmin=2)
        forces = {int(r[0]): (float(r[1]), float(r[2])) for r in rows}
        npz = os.path.join(out_dir, "fields3d.npz")
        if len(shape) == 3:
            with np.load(npz) as z:
                rho = z["rho"].astype(np.float64)
                u = np.stack([z[k] for k in ("ux", "uy", "uz")]).astype(
                    np.float64)
        else:
            cols = np.loadtxt(os.path.join(out_dir, "velocity_field.csv"),
                              delimiter=",", skiprows=1, usecols=(2, 3, 4))
            rho = cols[:, 2].reshape(shape)
            u = np.stack([cols[:, 0].reshape(shape),
                          cols[:, 1].reshape(shape)])
        return cls(forces, rho, u)

    @classmethod
    def from_case(cls, case: Case, start_rows: list, state: torch.Tensor,
                  tail_rows: list, steps: int) -> "Outputs":
        """What `case` produces in the program's place: the first rows
        from its own start, the tail's rows and the final fields from the
        state at tail_rows[0]."""
        forces = {}
        f = case.initial()
        for k, t in enumerate(start_rows):
            if k:
                f = case.run(f, t - start_rows[k - 1])
            forces[t] = tuple(case.force(f)[:2])
        g = state.to(device=case.device, dtype=case.dtype)
        for k, t in enumerate(tail_rows):
            if k:
                g = case.run(g, t - tail_rows[k - 1])
            forces[t] = tuple(case.force(g)[:2])
        g = case.run(g, steps - 1 - tail_rows[-1])
        rho, u, _ = case.final_fields(g)
        return cls(forces, rho, u)


def schedule(steps: int, freq: int, start_intervals: int, t_state: int):
    """(start rows, tail rows): the rows the reference follows from its
    own start, and those from the program's state at t_state up to the
    job's last force row."""
    t_last = (steps - 1) // freq * freq
    start = [k * freq for k in range(start_intervals + 1)
             if k * freq < t_state]
    return start, list(range(t_state, t_last + 1, freq))


def readings(ref: Outputs, got: Outputs, start_rows: list, tail_rows: list,
             steps: int, freq: int, case: Case) -> dict:
    def force_gap(t):
        if t not in got.forces:
            return float("inf")
        r, g = np.array(ref.forces[t]), np.array(got.forces[t])
        return float(np.max(np.abs(g - r)) / case.force_scale)

    due = set(range(0, steps, freq))
    finite = all(np.isfinite(v).all() for v in got.forces.values())
    rows = len(due ^ set(got.forces)) + (0 if finite else 1)
    if got.u.shape != ref.u.shape:
        fu = fr = float("inf")
    else:
        fu = float(np.max(np.abs(got.u - ref.u))) / case.u_in
        fr = float(np.max(np.abs(got.rho - ref.rho)))
    return {"force_start": max(force_gap(t) for t in start_rows),
            "force_tail": max(force_gap(t) for t in tail_rows),
            "fields_u": fu if np.isfinite(fu) else float("inf"),
            "fields_rho": fr if np.isfinite(fr) else float("inf"),
            "rows": rows}


def compare(ref_params: dict, traffic: dict, out_dir: str,
            state: torch.Tensor | None, t_state: int | None, device) -> dict:
    """The readings of the job written to out_dir, with the program's
    state at t_state, against the float64 reference on `device`."""
    steps = int(traffic["job_steps"])
    freq = int(traffic["output_frequency"])
    case = Case(ref_params, device=device, dtype=torch.float64)
    got = Outputs.from_files(out_dir, case.shape)
    if state is None:
        return dict.fromkeys(NAMES, float("inf"))
    start, tail = schedule(steps, freq,
                           int(traffic["check_start_intervals"]), t_state)
    ref = Outputs.from_case(case, start, state, tail, steps)
    return readings(ref, got, start, tail, steps, freq, case)


def control(ref_params: dict, traffic: dict, state: torch.Tensor,
            t_state: int, device, dtype=torch.bfloat16) -> dict:
    """The control's readings: the reference in `dtype` in the program's
    place, against the reference in float64."""
    steps = int(traffic["job_steps"])
    freq = int(traffic["output_frequency"])
    start, tail = schedule(steps, freq,
                           int(traffic["check_start_intervals"]), t_state)
    case = Case(ref_params, device, torch.float64)
    ref = Outputs.from_case(case, start, state, tail, steps)
    got = Outputs.from_case(Case(ref_params, device, dtype), start, state,
                            tail, steps)
    # the control writes no forces.csv: its other rows count as present
    got.forces.update({t: (0.0, 0.0) for t in range(0, steps, freq)
                       if t not in got.forces})
    return readings(ref, got, start, tail, steps, freq, case)


def verdict(values: dict, limits: dict) -> tuple[bool, list]:
    """(every reading within its limit, [(name, value, limit)]); a reading
    without a limit fails."""
    rows = [(k, values[k], limits.get(k)) for k in NAMES]
    ok = all(lim is not None and v <= lim for _, v, lim in rows)
    return ok, rows
