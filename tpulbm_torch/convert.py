"""Carry state between tpulbm and the port.

Both packages hold the populations as (Q, *spatial) arrays in the same
direction order and layout ((9, ny, nx) for D2Q9: the cylinder, the
channel, the cavity, the periodic boxes; (19, nz, ny, nx) for D3Q19 and
(27, nz, ny, nx) for D3Q27: the sphere, the duct and the 3-D boxes; and
(14, ny, nx) for the thermal problems and the
passive scalar: the 9 D2Q9 planes stacked over the 5 D2Q5 planes), so a
tpulbm state moves over unchanged. The params carry all the physics: the
port's Problem, Kolmogorov's force profile included, is built from them
(models.make_problem), never taken from tpulbm's callables.
A tpulbm single-device checkpoint (tpulbm's checkpoint.save: one .npz with
`f`, `step` and the params JSON) can be continued in the port, and one the
port writes in tpulbm. A sharded state (a mesh of several shards) is the
(my, mx) grid of local blocks in tpulbm's shard order, row by row, each
(Q, [nz,] nyl, nxl) (the mesh cuts y and x, as tpulbm's P(None, [None,]
"y", "x")):
split_state and gather_state carry a global state into and out of one.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import SimulationParams
from .lattice import D2Q5, D2Q9, D3Q19, D3Q27
from .models import make_problem
from .models.base import Problem
from .utils import checkpoint

# planes of a state -> number of spatial axes, for the states the port holds
_SPATIAL_DIMS = {D2Q9.Q: D2Q9.D, D3Q19.Q: D3Q19.D, D3Q27.Q: D3Q27.D,
                 D2Q9.Q + D2Q5.Q: 2}


def state_from_numpy(f: np.ndarray, problem: Problem, device) -> torch.Tensor:
    """A tpulbm state (state_q, *spatial) as a contiguous tensor on
    `device`; raises unless its shape and dtype are the problem's."""
    f = np.asarray(f)
    want = (problem.state_q,) + problem.spatial_shape
    if f.shape != want:
        raise ValueError(f"state shape {f.shape} != problem's {want}")
    if f.dtype != np.dtype(problem.dtype):
        raise TypeError(f"state dtype {f.dtype} != problem's "
                        f"{np.dtype(problem.dtype)}")
    return torch.from_numpy(np.ascontiguousarray(f)).to(device)


def state_from_numpy_block(block: np.ndarray, problem: Problem,
                           device) -> torch.Tensor:
    """One shard's host block (state_q, [nz,] nyl, nxl) as a contiguous
    tensor on `device`; raises unless its planes, its z extent and its
    dtype are the problem's."""
    block = np.asarray(block)
    lead = tuple(problem.spatial_shape[:-2])
    if (block.ndim != 3 + len(lead) or block.shape[0] != problem.state_q
            or tuple(block.shape[1:-2]) != lead):
        raise ValueError(f"block shape {block.shape} is not a "
                         f"({problem.state_q}, "
                         + "".join(f"{n}, " for n in lead)
                         + "nyl, nxl) block")
    if block.dtype != np.dtype(problem.dtype):
        raise TypeError(f"block dtype {block.dtype} != problem's "
                        f"{np.dtype(problem.dtype)}")
    return torch.from_numpy(np.ascontiguousarray(block)).to(device)


def state_to_numpy(f: torch.Tensor) -> np.ndarray:
    """A port state f32/f64 tensor, (9, ny, nx), (19 or 27, nz, ny, nx) or
    the thermal (14, ny, nx), as a host NumPy array."""
    if f.dim() == 0 or f.dim() != 1 + _SPATIAL_DIMS.get(f.shape[0], -1):
        raise ValueError(f"state must be (9, ny, nx), (19 or 27, nz, ny, "
                         f"nx) or (14, ny, nx), got {tuple(f.shape)}")
    if f.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"state dtype must be float32 or float64, "
                        f"got {f.dtype}")
    return f.detach().cpu().numpy()


def load_tpulbm_checkpoint(path: str, params: SimulationParams,
                           device) -> tuple[int, torch.Tensor]:
    """(step, f) from a tpulbm single-device checkpoint; raises if it was
    written with different physics than `params`."""
    step, f = checkpoint.load(path, params)
    return step, state_from_numpy(f, make_problem(params), device)


def split_state(f: np.ndarray, problem: Problem, mesh) -> list:
    """A tpulbm global state (state_q, [nz,] ny, nx) as the sharded state of
    `mesh` (parallel/mesh.Mesh): block (iy, ix) a contiguous tensor on
    mesh.device(iy, ix); raises unless its shape and dtype are the
    problem's."""
    from .parallel.sharded_step import shard_state
    return shard_state(mesh, state_from_numpy(f, problem, "cpu"))[0]


def gather_state(shards: list) -> np.ndarray:
    """The global host state (Q, [nz,] ny, nx) of a sharded state."""
    return np.concatenate([np.concatenate([state_to_numpy(b) for b in row],
                                          axis=-1) for row in shards],
                          axis=-2)
