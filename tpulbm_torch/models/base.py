"""Problem definition: lattice + geometry + boundary-condition layout.

Port of tpulbm/models/base.py for the slices the port covers (uniform
equilibrium start, optional solid mask; the 2-D cylinder's and the 3-D
sphere-in-duct's boundary layouts). The initial state and the ghost
values are computed in NumPy on the host, exactly as tpulbm does, so both
packages start from byte-identical arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import SimulationParams
from ..lattice import Lattice
from .. import physics


@dataclasses.dataclass(frozen=True)
class Problem:
    """Static description of one simulation setup. `solid` is a host bool
    (*spatial) mask in ([z,] y, x) order, True on solid cells, or None."""

    params: SimulationParams
    lattice: Lattice
    solid: np.ndarray | None
    init_rho: float = 1.0
    init_u: tuple[float, ...] = (0.0, 0.0)
    inlet_zou_he: bool = False        # Zou-He velocity inlet at x = 0
    outlet_zou_he: bool = False       # Zou-He pressure outlet at x = nx-1
    inlet_equilibrium: bool = False   # equilibrium inlet at x = 0 (3-D)
    outlet_zero_grad: bool = False    # zero-gradient outlet at x = nx-1 (3-D)
    walls_y: bool = True              # bounce-back walls at y = 0 and ny-1
    walls_z: bool = False             # bounce-back walls at z = 0 and nz-1
    obstacle_bc: str = "equilibrium"  # solid cells pinned to rest equilibrium
    collision: str = "bgk"

    @property
    def spatial_shape(self) -> tuple[int, ...]:
        p = self.params
        return (p.nz, p.ny, p.nx) if p.is_3d else (p.ny, p.nx)

    @property
    def dtype(self):
        return np.float64 if self.params.precision == "f64" else np.float32

    def ghost_ring_values(self) -> np.ndarray:
        """(Q,) values held by out-of-domain ghost cells: equilibrium(rho=1,
        u=init_u), frozen for the whole run (the reference never updates
        its physical-edge ghosts)."""
        return physics.uniform_equilibrium(
            self.lattice, self.init_rho, self.init_u, dtype=self.dtype)

    def initial_state(self) -> np.ndarray:
        """(Q, *spatial) initial populations: uniform equilibrium(1, init_u),
        solid cells at rest equilibrium."""
        Q = self.lattice.Q
        feq = self.ghost_ring_values()
        f = np.broadcast_to(
            feq.reshape((Q,) + (1,) * len(self.spatial_shape)),
            (Q,) + self.spatial_shape).copy()
        if self.solid is not None:
            rest = physics.rest_equilibrium(self.lattice, self.dtype)
            f[:, self.solid] = rest[:, None]
        return f
