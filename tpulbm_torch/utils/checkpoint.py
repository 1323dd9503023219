"""Checkpoint / resume: the port's copy of tpulbm's single-device format
(tpulbm/utils/checkpoint.py: save, latest, load), so a checkpoint written
by either package resumes in the other.

One .npz holds the state `f` ((Q, *spatial), or the stacked (14, ny, nx)
thermal state), the step and the params JSON; `load` refuses one written
with other physics. A run on a mesh of several shards writes tpulbm's
per-shard directory instead (save_sharded, load_sharded): ckpt_<step>/
holds proc_00000.npz, one array per shard under "shard_0_<y0>_<x0>" (the
offsets of its block on each axis), and manifest.json, written last, whose
presence publishes the checkpoint. One process that drives every shard
writes the one file tpulbm's process 0 writes for a one-host run; across
several processes (parallel/multihost.py) each writes proc_<pid>.npz with
its own shards, waits for the others, then writes the same manifest,
whose file map names each shard's process file, and each reads back only
its own shards (tpulbm/utils/checkpoint.py:95-140).
Both formats carry a run's Reynolds-statistics accumulators, as tpulbm's
do: the single .npz under stats_count, stats_first, stats_s_rho,
stats_s_u and stats_s_uu; the directory each sum's blocks under
"<name>|<shard key>" beside the state's, their layout under the
manifest's "stats" and the count and first step under its
"stats_scalars".
"""
from __future__ import annotations

import glob
import json
import os
import re
import shutil

import numpy as np

from ..config import SimulationParams

__all__ = ["check_manifest", "latest", "load", "load_sharded", "save",
           "save_sharded"]

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
         params: SimulationParams, keep: int = 3,
         stats: dict | None = None) -> str:
    """Write ckpt_<step>.npz atomically and keep the newest `keep`.
    stats: the statistics accumulators as host arrays (count, first,
    s_rho, s_u, s_uu), stored under stats_* keys."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:09d}.npz")
    tmp = path + ".tmp"
    extra = {f"stats_{k}": np.asarray(v) for k, v in (stats or {}).items()}
    with open(tmp, "wb") as fh:
        np.savez(fh, f=np.asarray(f), step=np.int64(step),
                 params_json=np.bytes_(params.to_json().encode()), **extra)
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


def load(path: str, params: SimulationParams | None = None,
         extras: bool = False):
    """(step, f) from a single-.npz checkpoint, or (step, f, stats) with
    `extras` (the statistics accumulators by name, without the stats_
    prefix, or None); with `params`, raises ValueError if it was written
    with other physics."""
    with np.load(path) as data:
        f = data["f"]
        step = int(data["step"])
        saved = SimulationParams.from_json(bytes(data["params_json"]).decode())
        stats = {k[len("stats_"):]: data[k] for k in data.files
                 if k.startswith("stats_")} or None
    if params is not None:
        _check_params(path, saved, params)
    return (step, f, stats) if extras else (step, f)


def _shard_key(offsets) -> str:
    """tpulbm's key of one shard: its block's offset on each axis."""
    return "shard_" + "_".join(str(int(o)) for o in offsets)


def _like(grid: list) -> np.ndarray:
    """A block this process holds: every block of a grid has its shape."""
    return np.asarray(next(b for row in grid for b in row if b is not None))


def _keys(grid: list) -> dict:
    """{(iy, ix): shard key} of every shard of a grid of blocks
    (..., nyl, nxl), each keyed by its offsets on every axis (0 on the
    leading ones)."""
    like = _like(grid)
    nyl, nxl = like.shape[-2:]
    return {(iy, ix): _shard_key((0,) * (like.ndim - 2)
                                 + (iy * nyl, ix * nxl))
            for iy, row in enumerate(grid) for ix in range(len(row))}


def _block_keys(grid: list) -> dict:
    """{shard key: host block} of the blocks of a grid this process holds
    (None marks another process's)."""
    return {key: np.asarray(grid[iy][ix])
            for (iy, ix), key in _keys(grid).items()
            if grid[iy][ix] is not None}


def _file_map(grid: list, owners) -> dict:
    """{shard key: the file of the process that holds it}, owners[iy][ix]
    the process of shard (iy, ix)."""
    return {key: f"proc_{owners[iy][ix]:05d}.npz"
            for (iy, ix), key in _keys(grid).items()}


def _global_shape(grid: list) -> list:
    like = _like(grid)
    return list(like.shape[:-2]) + [like.shape[-2] * len(grid),
                                    like.shape[-1] * len(grid[0])]


def save_sharded(ckpt_dir: str, step: int, shards: list,
                 params: SimulationParams, keep: int = 3,
                 stats: dict | None = None,
                 stats_scalars: dict | None = None, owners=None) -> str:
    """Write ckpt_<step>/ from a sharded state: `shards` the (my, mx) grid
    of host blocks (Q, nyl, nxl), shard (iy, ix) at rows iy*nyl and columns
    ix*nxl, None where another process holds the shard; keep the newest
    `keep` checkpoints of either kind. stats: the statistics sums by name,
    each a grid of host blocks; stats_scalars: their count and first
    sampled step. owners: the process of each shard, (my, mx)
    (parallel/mesh.Mesh.processes); None where this process holds every
    shard. Across several processes every process calls it: each writes
    its own blocks, then, after a barrier, the same manifest."""
    from ..parallel import multihost
    pid = multihost.process_index()
    if owners is None:
        if any(b is None for row in shards for b in row):
            raise ValueError("a grid of several processes' shards needs "
                             "their owners (owners=mesh.processes)")
        owners = [[pid] * len(row) for row in shards]
    path = os.path.join(ckpt_dir, f"ckpt_{step:09d}")
    os.makedirs(path, exist_ok=True)
    arrays = _block_keys(shards)
    stats_meta = {}
    for name, grid in (stats or {}).items():
        arrays.update({f"{name}|{key}": b
                       for key, b in _block_keys(grid).items()})
        stats_meta[name] = {"global_shape": _global_shape(grid),
                            "dtype": str(_like(grid).dtype),
                            "files": _file_map(grid, owners)}
    fpath = os.path.join(path, f"proc_{pid:05d}.npz")
    tmp = fpath + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, fpath)
    # no manifest may precede a peer's shard file
    multihost.sync(f"ckpt_{step}")
    manifest = {"step": int(step), "params": params.to_dict(),
                "global_shape": _global_shape(shards),
                "dtype": str(_like(shards).dtype),
                "files": _file_map(shards, owners)}
    if stats_meta:
        manifest["stats"] = stats_meta
    if stats_scalars:
        manifest["stats_scalars"] = {k: float(v)
                                     for k, v in stats_scalars.items()}
    mtmp = os.path.join(path, f"manifest.json.tmp{pid}")
    with open(mtmp, "w") as fh:
        json.dump(manifest, fh, indent=1)
    os.replace(mtmp, os.path.join(path, "manifest.json"))
    cands = []
    for p in glob.glob(os.path.join(ckpt_dir, "ckpt_*")):
        m = _PAT.search(p) or _PAT_DIR.search(p)
        if m:
            cands.append((int(m.group(1)), p))
    for _, old in sorted(cands)[:-keep]:
        _remove(old)
    return path


def _remove(path: str) -> None:
    """Delete a checkpoint file or directory. Processes that share a
    directory prune the same checkpoints at once, so a part another
    process deleted first is passed over; any other error raises."""
    while os.path.lexists(path):
        try:
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        except FileNotFoundError:
            continue


def check_manifest(path: str, params: SimulationParams | None = None) -> int:
    """The step of a per-shard checkpoint directory; with `params`, raises
    ValueError if it was written with other physics."""
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    if params is not None:
        _check_params(path, SimulationParams.from_dict(manifest["params"]),
                      params)
    return int(manifest["step"])


def _load_grid(path: str, shape: list, files: dict, mesh_shape, opened,
               prefix: str = "", cells=None) -> list:
    """The grid of host blocks of one array of global `shape` saved per
    shard (tpulbm's files map: shard key -> file), cut for `mesh_shape`;
    only the shards in `cells` (default: all), None for the others."""
    *lead, ny, nx = shape
    my, mx = mesh_shape
    if ny % my or nx % mx:
        raise ValueError(f"grid {nx}x{ny} not divisible by mesh {mesh_shape}")
    nyl, nxl = ny // my, nx // mx
    want = tuple(lead) + (nyl, nxl)
    grid = []
    for iy in range(my):
        row = []
        for ix in range(mx):
            key = _shard_key((0,) * len(lead) + (iy * nyl, ix * nxl))
            if cells is not None and (iy, ix) not in cells:
                row.append(None)
                continue
            if key not in files:
                raise ValueError(
                    f"checkpoint {path} has no shard at offsets {key!r} "
                    f"— it was saved with an incompatible mesh (saved "
                    f"files: {sorted(files)[:4]}…)")
            fname = files[key]
            if fname not in opened:
                opened[fname] = np.load(os.path.join(path, fname))
            block = opened[fname][prefix + key]
            if block.shape != want:
                raise ValueError(f"shard {key} of {path} is {block.shape}, "
                                 f"not {want}: it was saved with an "
                                 "incompatible mesh")
            row.append(block)
        grid.append(row)
    return grid


def load_sharded(path: str, mesh_shape: tuple[int, int],
                 params: SimulationParams | None = None,
                 extras: bool = False, cells=None):
    """(step, grid of host blocks) from a per-shard checkpoint directory,
    cut for a (my, mx) mesh: the blocks must line up with the saved ones
    (tpulbm's rule), else ValueError. With `params`, raises ValueError if
    it was written with other physics. With `extras`, (step, grid, stats):
    the statistics sums by name, each a grid of host blocks, and the
    scalars count and first, or None. cells: the (iy, ix) to read (a
    process's own shards), None in the grids for the others; every file
    is read where its shards are wanted, whichever process wrote it."""
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    if params is not None:
        _check_params(path, SimulationParams.from_dict(manifest["params"]),
                      params)
    opened = {}
    try:
        grid = _load_grid(path, manifest["global_shape"], manifest["files"],
                          mesh_shape, opened, cells=cells)
        stats = None
        if extras and "stats" in manifest:
            stats = {name: _load_grid(path, meta["global_shape"],
                                      meta["files"], mesh_shape, opened,
                                      prefix=f"{name}|", cells=cells)
                     for name, meta in manifest["stats"].items()}
            stats.update(manifest.get("stats_scalars", {}))
    finally:
        for data in opened.values():
            data.close()
    step = int(manifest["step"])
    return (step, grid, stats) if extras else (step, grid)
