"""Obstacle geometry: tpulbm's NumPy cylinder mask, re-exported."""
from tpulbm.geometry import cylinder_mask, solid_cell_count

__all__ = ["cylinder_mask", "solid_cell_count"]
