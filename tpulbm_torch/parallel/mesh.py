"""The mesh of shards and the decomposition choice.

Port of tpulbm/parallel/mesh.py. tpulbm's `jax.sharding.Mesh` with axes
('y', 'x') becomes a `Mesh` dataclass: its shape (my, mx) and a (my, mx)
grid of torch devices, one per shard. One process drives every shard, as
`shard_map` does; a device may repeat, the counterpart of tpulbm's virtual
CPU devices, so a 2x2 mesh runs its four shards on one card (or on the
host CPU in the tests).
"""
from __future__ import annotations

import dataclasses
import math

import torch


def choose_decomposition(n_devices: int, nx: int, ny: int) -> tuple[int, int]:
    """Pick (py, px) with py*px == n_devices minimizing the reference's score.

    Returns mesh shape in (y, x) order (array-axis order)."""
    aspect = nx / ny
    best, best_score = None, math.inf
    for px in range(1, n_devices + 1):
        if n_devices % px:
            continue
        py = n_devices // px
        if nx % px or ny % py:
            continue
        lnx, lny = nx // px, ny // py
        surface = 2.0 * (lnx + lny)
        volume = float(lnx * lny)
        score = surface / math.sqrt(volume) + abs(math.log((lnx / lny) / aspect))
        if score < best_score:
            best_score, best = score, (py, px)
    if best is None:
        raise ValueError(
            f"no decomposition of {n_devices} devices divides grid {nx}x{ny}; "
            f"choose nx, ny divisible by a factor pair of the device count")
    return best


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (my, mx) mesh of shards: devices[iy][ix] holds shard (iy, ix),
    which owns rows [iy*nyl, (iy+1)*nyl) and columns [ix*nxl, (ix+1)*nxl)
    of the global grid."""
    shape: tuple[int, int]
    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def shards(self):
        """(iy, ix) of every shard, row by row: tpulbm's shard order."""
        my, mx = self.shape
        return [(iy, ix) for iy in range(my) for ix in range(mx)]

    def device(self, iy: int, ix: int) -> torch.device:
        return self.devices[iy][ix]

    def local_shape(self, spatial_shape: tuple[int, int]) -> tuple[int, int]:
        """(nyl, nxl): tpulbm's local_block_shape for a 2-D grid."""
        my, mx = self.shape
        ny, nx = spatial_shape
        if ny % my or nx % mx:
            raise ValueError(f"grid {spatial_shape} not divisible by mesh "
                             f"{self.shape}")
        return ny // my, nx // mx


def visible_devices() -> list[torch.device]:
    """Every visible card, in index order; raises where there is none (a
    mesh runs on the host CPU only when the caller asks, devices=[cpu]...)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("a mesh defaults to the visible CUDA devices and "
                           "torch finds none; pass devices=['cpu', ...] to "
                           "run the shards on the host CPU")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(mesh_shape: tuple[int, int] | None = None,
              nx: int | None = None, ny: int | None = None,
              devices=None) -> Mesh:
    """A Mesh of shape mesh_shape=(my, mx), or None to choose it from the
    grid over all devices (choose_decomposition). devices: a list of torch
    devices (or names), one per shard in row-by-row order; a device may
    repeat. Default: every visible card, and a mesh larger than that
    raises as tpulbm's make_mesh does."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else visible_devices())]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    if mesh_shape is None:
        if nx is None or ny is None:
            raise ValueError("need nx, ny for automatic decomposition")
        mesh_shape = choose_decomposition(len(devices), nx, ny)
    my, mx = (int(v) for v in mesh_shape)
    if my < 1 or mx < 1 or my * mx != len(devices):
        raise ValueError(f"mesh {tuple(mesh_shape)} needs {my * mx} devices, "
                         f"have {len(devices)}")
    grid = tuple(tuple(devices[iy * mx:(iy + 1) * mx]) for iy in range(my))
    return Mesh((my, mx), grid)
