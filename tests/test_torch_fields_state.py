"""The analytic start of the periodic boxes (Problem.fields_state, the
init_fields start) built by tensors on the mesh's first device and cut
(sharded_step.shard_initial_state): bitwise the host array
Problem.initial_state() gives, on one shard and on meshes, for every box
problem and both precisions."""
import numpy as np
import pytest
import torch

from tpulbm_torch.config import PRESETS, SimulationParams
from tpulbm_torch.models import make_problem
from tpulbm_torch.parallel import sharded_step
from tpulbm_torch.parallel.mesh import make_mesh

BOX = dict(tau=0.8, periodic_x=True, cylinder_radius=0.0, enable_vtk=False)
CASES = {
    "taylor-green": SimulationParams(problem="taylor-green", nx=24, ny=16,
                                     inlet_velocity=0.04, **BOX),
    "shear-layer": PRESETS["shear-layer"].replace(nx=24, ny=16,
                                                  enable_vtk=False),
    "kolmogorov": SimulationParams(problem="kolmogorov", nx=24, ny=16,
                                   inlet_velocity=0.05, kolmogorov_n=4,
                                   **BOX),
    "passive-scalar": SimulationParams(problem="passive-scalar", nx=24,
                                       ny=16, inlet_velocity=0.04,
                                       thermal_tau=0.5704, **BOX),
    "taylor-green3d": SimulationParams(problem="taylor-green", nx=12, ny=8,
                                       nz=6, inlet_velocity=0.04, **BOX),
    "kolmogorov3d": PRESETS["kolmogorov3d"].replace(nx=12, ny=8, nz=6,
                                                    enable_vtk=False),
}


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fields_state_is_the_host_start(name, precision):
    problem = make_problem(CASES[name].replace(precision=precision))
    assert problem.init_fields is not None
    want = problem.initial_state()
    got = problem.fields_state(torch.device("cpu"))
    assert got.dtype == torch.from_numpy(want).dtype
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 3)])
@pytest.mark.parametrize("name", ["taylor-green", "passive-scalar",
                                  "kolmogorov3d"])
def test_shard_initial_state_cuts_the_host_start(name, shape):
    problem = make_problem(CASES[name].replace(precision="f32"))
    mesh = make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))
    blocks, solid = sharded_step.shard_initial_state(problem, mesh)
    assert solid is None
    got = sharded_step.gather(blocks)
    assert np.array_equal(got.numpy(), problem.initial_state())
