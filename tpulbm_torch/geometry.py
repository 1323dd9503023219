"""Obstacle geometry: tpulbm's NumPy cylinder and sphere masks, re-exported."""
from tpulbm.geometry import cylinder_mask, solid_cell_count, sphere_mask

__all__ = ["cylinder_mask", "solid_cell_count", "sphere_mask"]
