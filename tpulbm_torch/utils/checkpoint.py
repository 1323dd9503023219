"""Checkpoint / resume: the port's copy of tpulbm's single-device format
(tpulbm/utils/checkpoint.py: save, latest, load), so a checkpoint written
by either package resumes in the other.

One .npz holds the state `f` ((Q, *spatial), or the stacked (14, ny, nx)
thermal state), the step and the params JSON; `load` refuses one written
with other physics. tpulbm's per-shard checkpoint directories (several
devices) are found by `latest` so that the Runner can refuse them by name;
reading them is not ported (ROADMAP Queue 1 item 19).
"""
from __future__ import annotations

import glob
import os
import re

import numpy as np

from ..config import SimulationParams

__all__ = ["latest", "load", "save"]

_PAT = re.compile(r"ckpt_(\d+)\.npz$")
_PAT_DIR = re.compile(r"ckpt_(\d+)$")

# Fields that do not change the physics of the trajectory: safe to differ
# between the checkpointing run and the resuming run. Everything else
# (grid, tau, velocities, BC/collision choices, body force, precision, …)
# must match.
_RUNTIME_FIELDS = frozenset({
    "num_timesteps", "output_frequency", "vtk_start_step", "backend",
    "mesh_shape", "checkpoint_every", "checkpoint_dir", "output_dir",
    "enable_vtk", "vtk_format", "stats_from",
})


def save(ckpt_dir: str, step: int, f: np.ndarray,
         params: SimulationParams, keep: int = 3) -> str:
    """Write ckpt_<step>.npz atomically and keep the newest `keep`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:09d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, f=np.asarray(f), step=np.int64(step),
                 params_json=np.bytes_(params.to_json().encode()))
    os.replace(tmp, path)  # atomic publish
    for old in sorted(glob.glob(os.path.join(ckpt_dir, "ckpt_*.npz")))[:-keep]:
        os.remove(old)
    return path


def latest(ckpt_dir: str) -> str | None:
    """Newest complete checkpoint: either a ckpt_<step>.npz file or a
    ckpt_<step>/ shard directory whose manifest.json exists."""
    cands = []
    for p in glob.glob(os.path.join(ckpt_dir, "ckpt_*")):
        m = _PAT.search(p)
        if m:
            cands.append((int(m.group(1)), p))
            continue
        m = _PAT_DIR.search(p)
        if m and os.path.exists(os.path.join(p, "manifest.json")):
            cands.append((int(m.group(1)), p))
    return max(cands)[1] if cands else None


def _check_params(path: str, saved: SimulationParams,
                  params: SimulationParams) -> None:
    saved_d, run_d = saved.to_dict(), params.to_dict()
    for field in sorted(set(saved_d) & set(run_d) - _RUNTIME_FIELDS):
        if saved_d[field] != run_d[field]:
            raise ValueError(
                f"checkpoint {path} was written with {field}="
                f"{saved_d[field]!r}, run has {run_d[field]!r}")


def load(path: str, params: SimulationParams | None = None):
    """(step, f) from a single-.npz checkpoint; with `params`, raises
    ValueError if it was written with other physics."""
    with np.load(path) as data:
        f = data["f"]
        step = int(data["step"])
        saved = SimulationParams.from_json(bytes(data["params_json"]).decode())
    if params is not None:
        _check_params(path, saved, params)
    return step, f
