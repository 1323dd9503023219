"""The kernel module on a 3-D mesh (tpulbm_torch/parallel/sharded_step.py
with backend="pallas", whose CPU path is each shard's plain ring step)
against tpulbm's 3-D Pallas cascade on a mesh in interpret mode
(make_chunk_fn(backend="pallas"): make_local_step_pallas3d_tiled with its
ring rows and, on a mesh that cuts x, its x_halo columns), on tpulbm's
virtual CPU devices, f32, one chunk from a seeded ±10% perturbed state,
at rtol 5e-6 / atol 1e-7 (tests/test_torch_3d.py's F32_TOL: the Pallas
kernels multiply by 1/rho where the plain step divides):

* the sphere on (2, 2) at tpulbm's mixed depths, 5 steps as [(3, 1),
  (2, 1)];
* the sphere on (1, 2), the x-cut mesh (x_halo), at depth 3;
* the bounce-back sphere under TRT on (2, 2) at depth 2, straddling both
  shard edges (tpulbm's test_3d_tiled_pallas_2d_mesh_bounce_back).

Each case takes 15-35 s of interpret-mode compilation and execution.
"""
import jax
import numpy as np
import pytest

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from test_torch_3d import F32_TOL
from test_torch_3d_blocking import _setenv
from test_torch_compat import port_problem
from test_torch_mesh import perturbed
from test_torch_mesh3d import SPHERE, _port_chunks, _tpulbm_chunks


@pytest.mark.parametrize("mesh_shape,env,chunk_len,extra,depths", [
    ((2, 2), {}, 5, {}, [3, 2]),
    ((1, 2), {"TPULBM_SUBSTEPS": "3"}, 3, {}, [3]),
    ((2, 2), {"TPULBM_SUBSTEPS": "2"}, 2,
     dict(obstacle_bc="bounce_back", collision="trt"), [2]),
], ids=["2x2-mixed-depths", "1x2-x-cut", "2x2-bounce-back-trt"])
def test_kernel_module_3d_mesh_matches_pallas(monkeypatch, mesh_shape, env,
                                              chunk_len, extra, depths):
    _setenv(monkeypatch, env)
    # 16 rows a shard: tpulbm's interpret-mode tile of 16 rows holds 4
    # halo rows at depths 2 and 3
    params = SimulationParams(precision="f32", **dict(
        SPHERE, ny=16 * mesh_shape[0], nx=16 * mesh_shape[1] + 16, nz=6,
        cylinder_radius=0.25, **extra))
    f0 = perturbed(jax_problem(params))
    want, ref = _tpulbm_chunks(params, mesh_shape, chunk_len, 1, f0,
                               backend="pallas")
    assert ref.pallas3d_depths == depths
    got, chunk = _port_chunks(port_problem(params), mesh_shape, chunk_len,
                              1, f0, backend="pallas")
    assert [d for d, _ in chunk.plan] == depths
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], want[0], **F32_TOL)
