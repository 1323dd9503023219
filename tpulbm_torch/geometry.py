"""Obstacle geometry: the port's copy of tpulbm/geometry.py (NumPy cylinder
and sphere masks, built on the host)."""
from __future__ import annotations

import numpy as np

from .config import SimulationParams

__all__ = ["cylinder_mask", "solid_cell_count", "sphere_mask"]


def cylinder_mask(params: SimulationParams) -> np.ndarray:
    """Boolean (ny, nx) mask, True on solid cells: integer center and
    radius, inclusive dist^2 <= r^2 test (the reference's rasterization)."""
    cx, cy = params.get_cylinder_x(), params.get_cylinder_y()
    r = params.get_cylinder_radius_cells()
    # open grids: (ny,1) + (1,nx) broadcast — no full-size index temporaries
    yy, xx = np.ogrid[0:params.ny, 0:params.nx]
    dx = xx.astype(np.float64) - cx
    dy = yy.astype(np.float64) - cy
    return (dx * dx + dy * dy) <= float(r) * float(r)


def sphere_mask(params: SimulationParams) -> np.ndarray:
    """Boolean (nz, ny, nx) mask for a sphere: center fractions reuse
    cylinder_{x,y}, z is centered, radius is cylinder_radius * ny."""
    cx, cy = params.get_cylinder_x(), params.get_cylinder_y()
    cz = params.nz // 2
    r = params.get_cylinder_radius_cells()
    # open grids: three 1-D axes broadcast at the final add
    zz, yy, xx = np.ogrid[0:params.nz, 0:params.ny, 0:params.nx]
    d2 = ((xx - cx).astype(np.float64) ** 2 + (yy - cy).astype(np.float64) ** 2
          + (zz - cz).astype(np.float64) ** 2)
    return d2 <= float(r) * float(r)


def solid_cell_count(mask: np.ndarray) -> int:
    """Global solid-cell count (printed in the run banner)."""
    return int(mask.sum())
