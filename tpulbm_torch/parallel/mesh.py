"""The mesh of shards and the decomposition choice.

Port of tpulbm/parallel/mesh.py. tpulbm's `jax.sharding.Mesh` with axes
('y', 'x') becomes a `Mesh` dataclass: its shape (my, mx) and a (my, mx)
grid of torch devices, one per shard. One process drives every shard, as
`shard_map` does; a device may repeat, the counterpart of tpulbm's virtual
CPU devices, so a 2x2 mesh runs its four shards on one card (or on the
host CPU in the tests).

Across several processes (parallel/multihost.py) each drives a run of
my*mx/P shards in row-major order, jax's process-to-device map: the mesh
records each shard's process, and its device only where this process
owns it (None for another process's shard, as a sharded state's grid
holds None there).
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
    devices: tuple[tuple[torch.device | None, ...], ...]
    # the process of each shard, (my, mx): every decision of which process
    # owns a shard reads it here
    processes: tuple[tuple[int, ...], ...]
    rank: int = 0

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def shards(self):
        """(iy, ix) of every shard, row by row: tpulbm's shard order."""
        my, mx = self.shape
        return [(iy, ix) for iy in range(my) for ix in range(mx)]

    def device(self, iy: int, ix: int) -> torch.device | None:
        """Shard (iy, ix)'s device; None where another process owns it."""
        return self.devices[iy][ix]

    def process(self, iy: int, ix: int) -> int:
        """The process that drives shard (iy, ix)."""
        return self.processes[iy][ix]

    def is_local(self, iy: int, ix: int) -> bool:
        return self.process(iy, ix) == self.rank

    def local_shards(self):
        """(iy, ix) of this process's shards, row by row."""
        return [cell for cell in self.shards() if self.is_local(*cell)]

    def by_process(self):
        """(iy, ix) of every shard, process by process and within each row
        by row: the order of an all-gather of every process's
        local_shards()."""
        return sorted(self.shards(), key=lambda cell: self.process(*cell))

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard: where the diagnostics
        reduce (shard (0,0)'s in one process)."""
        return self.device(*self.local_shards()[0])

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
    raises as tpulbm's make_mesh does.

    Across P processes (multihost.initialize) the shards are this
    process's run of my*mx/P: `devices` lists theirs (default: each on
    multihost.local_device()), mesh_shape None divides the grid over
    P * len(devices) devices, and a mesh P does not divide raises."""
    from . import multihost
    world, rank = multihost.process_count(), multihost.process_index()
    if devices is None:
        devices = (visible_devices() if world == 1
                   else [multihost.local_device()])
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    if mesh_shape is None:
        if nx is None or ny is None:
            raise ValueError("need nx, ny for automatic decomposition")
        mesh_shape = choose_decomposition(world * len(devices), nx, ny)
    my, mx = (int(v) for v in mesh_shape)
    if world > 1:
        if my * mx % world:
            raise ValueError(f"mesh {(my, mx)} does not divide over {world} "
                             "processes")
        per = my * mx // world
        if len(devices) == 1:
            devices = devices * per
        if len(devices) != per:
            raise ValueError(f"mesh {(my, mx)} over {world} processes runs "
                             f"{per} shards a process, have {len(devices)} "
                             "devices")
        # runs of `per` shards in row-major order, jax's process map
        procs = tuple(tuple((iy * mx + ix) // per for ix in range(mx))
                      for iy in range(my))
        it = iter(devices)
        grid = tuple(tuple(next(it) if p == rank else None for p in row)
                     for row in procs)
        return Mesh((my, mx), grid, procs, rank)
    if my < 1 or mx < 1 or my * mx != len(devices):
        raise ValueError(f"mesh {tuple(mesh_shape)} needs {my * mx} devices, "
                         f"have {len(devices)}")
    grid = tuple(tuple(devices[iy * mx:(iy + 1) * mx]) for iy in range(my))
    return Mesh((my, mx), grid, ((0,) * mx,) * my)
