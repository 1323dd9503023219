"""Lattice descriptors: the port's copy of tpulbm/lattice.py (D2Q9, D2Q5,
D3Q19, D3Q27), plus tensor views.

The direction order is tpulbm's (and its reference's), so every piece of
boundary-condition algebra carries over index for index:

    D2Q9:  0:( 0, 0)  1:( 1, 0)  2:( 0, 1)  3:(-1, 0)  4:( 0,-1)
           5:( 1, 1)  6:(-1, 1)  7:(-1,-1)  8:( 1,-1)
    D2Q5:  the first five D2Q9 directions (the thermal scalar's lattice)
    D3Q19: rest, the six axes, the twelve face diagonals
    D3Q27: D3Q19's 19 index for index, then the eight corners

Constants live as NumPy arrays; the kernels take them as arguments.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

__all__ = ["D2Q5", "D2Q9", "D3Q19", "D3Q27", "Lattice", "lattice_tensors"]


@dataclasses.dataclass(frozen=True)
class Lattice:
    """A DdQq lattice: velocity set, quadrature weights, and opposite map."""

    name: str
    D: int
    velocities: tuple[tuple[int, ...], ...]  # (Q, D) integer lattice velocities
    weights: tuple[float, ...]               # (Q,) quadrature weights

    @property
    def Q(self) -> int:
        return len(self.velocities)

    @cached_property
    def c(self) -> np.ndarray:
        """Velocity set as an int (Q, D) array."""
        return np.asarray(self.velocities, dtype=np.int32)

    @cached_property
    def w(self) -> np.ndarray:
        """Weights as a float64 (Q,) array."""
        return np.asarray(self.weights, dtype=np.float64)

    @cached_property
    def opposite(self) -> np.ndarray:
        """opposite[i] = index j with c[j] == -c[i] (derived, not
        hard-coded; D2Q9 gives {0,3,4,1,2,7,8,5,6})."""
        c = self.c
        opp = np.empty(self.Q, dtype=np.int32)
        for i in range(self.Q):
            matches = np.where((c == -c[i]).all(axis=1))[0]
            if len(matches) != 1:
                raise ValueError(f"lattice {self.name}: no unique opposite for dir {i}")
            opp[i] = matches[0]
        return opp

    @property
    def cs2(self) -> float:
        """Lattice speed of sound squared (1/3 for the standard lattices here)."""
        return 1.0 / 3.0


D2Q9 = Lattice(
    name="D2Q9",
    D=2,
    velocities=(
        (0, 0),
        (1, 0), (0, 1), (-1, 0), (0, -1),
        (1, 1), (-1, 1), (-1, -1), (1, -1),
    ),
    weights=(
        4.0 / 9.0,
        1.0 / 9.0, 1.0 / 9.0, 1.0 / 9.0, 1.0 / 9.0,
        1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0,
    ),
)

# D2Q5: the advection-diffusion lattice of the thermal (double-population)
# models, in D2Q9's first-five direction order
D2Q5 = Lattice(
    name="D2Q5",
    D=2,
    velocities=((0, 0), (1, 0), (0, 1), (-1, 0), (0, -1)),
    weights=(1.0 / 3.0, 1.0 / 6.0, 1.0 / 6.0, 1.0 / 6.0, 1.0 / 6.0),
)

# D3Q19: rest, 6 axis-aligned, 12 face-diagonal
_D3Q19_AXIS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))
_D3Q19_DIAG = (
    (1, 1, 0), (-1, -1, 0), (1, -1, 0), (-1, 1, 0),
    (1, 0, 1), (-1, 0, -1), (1, 0, -1), (-1, 0, 1),
    (0, 1, 1), (0, -1, -1), (0, 1, -1), (0, -1, 1),
)
D3Q19 = Lattice(
    name="D3Q19",
    D=3,
    velocities=((0, 0, 0),) + _D3Q19_AXIS + _D3Q19_DIAG,
    weights=(1.0 / 3.0,) + (1.0 / 18.0,) * 6 + (1.0 / 36.0,) * 12,
)

# D3Q27: the fourth-order isotropic set, D3Q19's directions index for
# index (so its boundary algebra carries over), then the 8 corners
_D3Q27_CORNER = (
    (1, 1, 1), (-1, -1, -1), (1, 1, -1), (-1, -1, 1),
    (1, -1, 1), (-1, 1, -1), (1, -1, -1), (-1, 1, 1),
)
D3Q27 = Lattice(
    name="D3Q27",
    D=3,
    velocities=((0, 0, 0),) + _D3Q19_AXIS + _D3Q19_DIAG + _D3Q27_CORNER,
    weights=(8.0 / 27.0,) + (2.0 / 27.0,) * 6 + (1.0 / 54.0,) * 12
    + (1.0 / 216.0,) * 8,
)


def lattice_tensors(lat: Lattice, device, dtype=torch.float32):
    """(c, w, opposite) of `lat` as tensors on `device`: c (Q, D) int64,
    w (Q,) in `dtype`, opposite (Q,) int64."""
    c = torch.as_tensor(lat.c, dtype=torch.int64, device=device)
    w = torch.as_tensor(lat.w, dtype=dtype, device=device)
    opp = torch.as_tensor(lat.opposite, dtype=torch.int64, device=device)
    return c, w, opp
