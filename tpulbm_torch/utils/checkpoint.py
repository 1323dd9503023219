"""Checkpoint / resume: tpulbm's jax-free single-device format, re-exported,
so a checkpoint written by either package resumes in the other. One .npz
holds the state `f`, the step and the params JSON; `load` refuses one
written with other physics."""
from tpulbm.utils.checkpoint import latest, load, save

__all__ = ["latest", "load", "save"]
