"""The benchmark's plain reference (lbmbench/reference/lbm.py) against the
port's plain tier in float64 at small sizes: the mask and start, 30 steps,
the force every 10 steps and the final fields. The test imports both; the
reference imports nothing of the port (test_lbmbench_harness.py)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from lbmbench.reference.lbm import Case, mrt_basis

from tpulbm_torch.config import SimulationParams
from tpulbm_torch.models import make_problem
from tpulbm_torch.ops import diagnostics, forces, step_torch

RATES_2D = {"e": 1.64, "eps": 1.54, "qx": 1 / 0.6, "qy": 1 / 0.6}
RATES_3D = {"e": 1.19, "eps": 1.4, "qx": 1.2, "qy": 1.2, "qz": 1.2,
            "pixx": 1.4, "piww": 1.4, "mx": 1.98, "my": 1.98, "mz": 1.98}
CASES = {
    "cylinder-bgk": dict(nx=96, ny=40, nz=0, collision="bgk"),
    "cylinder-mrt": dict(nx=96, ny=40, nz=0, collision="mrt",
                         mrt_rates=RATES_2D),
    "sphere-bgk": dict(nx=40, ny=24, nz=20, collision="bgk"),
    "sphere-mrt": dict(nx=40, ny=24, nz=20, collision="mrt",
                       mrt_rates=RATES_3D),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_steps_as_the_port(name):
    kw = CASES[name]
    shared = dict(nx=kw["nx"], ny=kw["ny"], nz=kw["nz"], tau=0.6,
                  inlet_velocity=0.05, cylinder_x=0.23, cylinder_y=0.47,
                  cylinder_radius=0.12, collision=kw["collision"])
    params = SimulationParams(
        problem="cylinder3d" if kw["nz"] else "cylinder", precision="f64",
        backend="jax", enable_vtk=False, **shared)
    problem = make_problem(params)
    step = step_torch.make_step_rolled(problem, "cpu")
    force = forces.forces_fn(problem, "cpu")
    fields = diagnostics.fields_fn(problem, "cpu")
    ref = Case({**shared, "mrt_rates": kw.get("mrt_rates")})
    assert torch.equal(torch.as_tensor(problem.solid), ref.solid)
    f = torch.from_numpy(problem.initial_state())
    g = ref.initial()
    assert torch.equal(f, g)
    for k in range(30):
        if k % 10 == 0:
            np.testing.assert_allclose(ref.force(g)[:2],
                                       force(f).numpy()[:2], rtol=1e-12,
                                       atol=1e-13)
        f, g = step(f), ref.step(g)
    torch.testing.assert_close(g, f, rtol=1e-12, atol=1e-13)
    rho, u = fields(f)
    rho_r, u_r = ref.fields(g)
    np.testing.assert_allclose(rho_r, rho.numpy(), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(u_r, u.numpy(), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("d", [2, 3])
def test_mrt_basis_is_orthogonal_and_complete(d):
    from lbmbench.reference.lbm import D2Q9_C, D3Q19_C
    c = np.array(D2Q9_C if d == 2 else D3Q19_C)
    M, names = mrt_basis(c)
    assert M.shape == (len(c), len(c)) and len(set(names)) == len(c)
    assert np.linalg.matrix_rank(M) == len(c)


def test_final_fields_take_the_edges_one_step_later():
    ref = Case(dict(nx=64, ny=32, nz=0, tau=0.6, inlet_velocity=0.05,
                    cylinder_x=0.3, cylinder_y=0.5, cylinder_radius=0.1,
                    collision="bgk"))
    f = ref.run(ref.initial(), 5)
    rho, u, last = ref.final_fields(f)
    rho_f, u_f = ref.fields(f)
    rho_l, u_l = ref.fields(last)
    np.testing.assert_array_equal(rho[:, 1:-1], rho_f[:, 1:-1])
    np.testing.assert_array_equal(u[:, :, 0], u_l[:, :, 0])
    np.testing.assert_array_equal(rho[:, -1], rho_l[:, -1])
