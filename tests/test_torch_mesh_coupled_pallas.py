"""The kernel module on a mesh for the thermal problems and multiphase
(tpulbm_torch/parallel/sharded_step.py with backend="pallas", whose CPU
path is each shard's plain ring step) against tpulbm's Pallas rows 8 and
9 in interpret mode through make_chunk_fn(backend="pallas") on tpulbm's
virtual CPU devices, f32, two chunks from a seeded ±10% perturbed state
(from rest every ring holds the frozen equilibrium and would hide a ring
that is never read):

* row 8, make_local_step_thermal_pallas: its ring rows rb/rt and edge
  flags on (2, 1), its x_halo columns rl/rr on (2, 2), for
  Rayleigh-Bénard, its Smagorinsky closure (tpulbm's `les` gate), the
  heated cavity (the x-wall flags) and the passive scalar (a periodic y);
* row 9, make_local_step_multiphase_pallas: its depth-2 ring rows on
  (2, 1) and its x_halo columns on (2, 2), the droplet and the band.

Tolerance rtol 2e-5 / atol 1e-7, tpulbm's own gate for its ring kernels
(tests/test_pallas_tiled.py:48-57): the Pallas kernels take ψ of the
equilibrium ring at a wall and sum in their own order.
"""
import jax
import numpy as np
import pytest

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.parallel.mesh import make_mesh as jax_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state as jax_shard_state
from test_torch_mesh import _port_chunks, perturbed
from test_torch_mesh_multiphase import CASES as MP_CASES
from test_torch_mesh_thermal import CASES as THERMAL_CASES

TOL = dict(rtol=2e-5, atol=1e-7)


def _compare(kw, mesh_shape, chunk_len=2):
    params = SimulationParams(precision="f32", nx=64, ny=32, **kw)
    problem = jax_problem(params)
    f0 = perturbed(problem)
    mesh = jax_mesh(mesh_shape,
                    devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    ref = jax_chunk_fn(problem, mesh, chunk_len, backend="pallas")
    f, solid = jax_shard_state(mesh, f0, np.zeros(problem.spatial_shape,
                                                  bool))
    got, chunk = _port_chunks(params, mesh_shape, chunk_len, 2, f0,
                              backend="pallas")
    assert chunk.mode == ("tiled" if mesh_shape[1] > 1 else "rows")
    for k in range(2):
        f = ref(f, solid)
        assert np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], np.asarray(jax.device_get(f)),
                                   err_msg=f"chunk {k}", **TOL)


@pytest.mark.parametrize("case", sorted(THERMAL_CASES))
@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
def test_thermal_rings_match_pallas_row_8(case, mesh_shape):
    _compare(THERMAL_CASES[case], mesh_shape)


@pytest.mark.parametrize("case", sorted(MP_CASES))
@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
def test_multiphase_rings_match_pallas_row_9(case, mesh_shape):
    _compare(MP_CASES[case], mesh_shape)
