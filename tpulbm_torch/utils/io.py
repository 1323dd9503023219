"""Artifact writers: tpulbm's jax-free writers, re-exported, so both packages
write byte-identical forces.csv, velocity_field.csv, simulation_params.csv
and VTK frames."""
from tpulbm.utils.io import (ForceWriter, calculate_time_averaged_drag,
                             write_simulation_params, write_velocity_field,
                             write_vtk_timestep)

__all__ = ["ForceWriter", "calculate_time_averaged_drag",
           "write_simulation_params", "write_velocity_field",
           "write_vtk_timestep"]
