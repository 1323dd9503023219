"""The kernel module on a mesh (tpulbm_torch/parallel/sharded_step.py with
backend="pallas", whose CPU path is the plain ring step of each shard)
against tpulbm's Pallas kernels in interpret mode through
make_chunk_fn(backend="pallas") on tpulbm's virtual CPU devices, f32, two
chunks from a seeded ±10% perturbed state (from rest every ring holds the
frozen equilibrium and would hide a ring that is never read), at tpulbm's
own gate for its x-tiled kernel, rtol 2e-5 / atol 1e-7
(tests/test_pallas_tiled.py:48-57), on tpulbm's setups:

* rows 1-3 with ring rows on a mesh that keeps x whole: the 1-step kernel
  (TPULBM_NO_FUSED2), make_local_step_pallasN (N = 3) and
  make_local_step_pallas2;
* row 4 and row 2's ranged cascade under TPULBM_HALO_OVERLAP;
* row 5, the x-tiled kernel: TPULBM_FORCE_TILED on (1,1), (2, 2) with
  the bounce-back obstacle straddling both shard edges (N = 2) and TRT
  with the clean corners on (2, 2) (its depths on (1, 2) and (2, 2) are
  in tests/test_torch_mesh_tiled.py, which shares this file's helper; the
  two keep each file near a minute and a half on one worker).

The cylinder sits at the centre, across the shard edges of every mesh
here (tpulbm's test_tiled_cylinder_straddling_x_boundary and
test_tiled_bounce_back_straddling_2d).
"""
import jax
import numpy as np
import pytest

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.parallel.mesh import make_mesh as jax_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state as jax_shard_state
from test_torch_3d_blocking import _setenv
from test_torch_mesh import _port_chunks, perturbed

TOL = dict(rtol=2e-5, atol=1e-7)
CYL = dict(nx=64, ny=48, tau=0.6, inlet_velocity=0.05, cylinder_x=0.5,
           cylinder_y=0.5, cylinder_radius=0.15)


def _compare(params, mesh_shape, chunk_len, mode, depth):
    f0 = perturbed(jax_problem(params))
    problem = jax_problem(params)
    mesh = jax_mesh(mesh_shape,
                    devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    ref = jax_chunk_fn(problem, mesh, chunk_len, backend="pallas")
    assert ref.pallas_substeps == depth
    solid = (problem.solid if problem.solid is not None
             else np.zeros(problem.spatial_shape, bool))
    f, solid = jax_shard_state(mesh, f0, solid)
    got, chunk = _port_chunks(params, mesh_shape, chunk_len, 2, f0,
                              backend="pallas")
    assert (chunk.mode, chunk.substeps) == (mode, depth)
    for k in range(2):
        f = ref(f, solid)
        assert np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], np.asarray(jax.device_get(f)),
                                   err_msg=f"chunk {k}", **TOL)


@pytest.mark.parametrize("env,chunk_len,mode,depth", [
    ({"TPULBM_NO_FUSED2": "1"}, 2, "rows", 1),
    ({"TPULBM_SUBSTEPS": "3"}, 3, "rows", 3),
    ({"TPULBM_SUBSTEPS": "2"}, 2, "rows", 2),
    ({"TPULBM_HALO_OVERLAP": "1", "TPULBM_NO_FUSED2": "1"}, 2, "overlap", 1),
    ({"TPULBM_HALO_OVERLAP": "1", "TPULBM_SUBSTEPS": "2"}, 2, "overlap", 2),
], ids=["row1", "row2", "row3", "row4-ranged", "row2-ranged"])
def test_full_width_kernels_with_rings_match_pallas(monkeypatch, env,
                                                    chunk_len, mode, depth):
    # slabs of 2 rows: the ranged cascade needs 3 (N + 1) slabs a shard
    _setenv(monkeypatch, dict(env, TPULBM_PALLAS_TY="2"))
    _compare(SimulationParams(precision="f32", **CYL), (2, 1), chunk_len,
             mode, depth)


@pytest.mark.parametrize("mesh_shape,n_sub,extra", [
    ((1, 1), 2, {}),
    ((2, 2), 2, dict(obstacle_bc="bounce_back")),
    ((2, 2), 1, dict(collision="trt", zou_he_corners="clean")),
], ids=["force-tiled", "2x2-bounce-back", "2x2-trt-clean-corners"])
def test_tiled_kernel_matches_pallas(monkeypatch, mesh_shape, n_sub, extra):
    compare_tiled(monkeypatch, mesh_shape, n_sub, extra)


def compare_tiled(monkeypatch, mesh_shape, n_sub, extra):
    """Row 5 at depth n_sub (TPULBM_SUBSTEPS; TPULBM_NO_FUSED2 for 1)."""
    env = ({"TPULBM_NO_FUSED2": "1"} if n_sub == 1
           else {"TPULBM_SUBSTEPS": str(n_sub)})
    if mesh_shape == (1, 1):
        env["TPULBM_FORCE_TILED"] = "1"
    _setenv(monkeypatch, env)
    _compare(SimulationParams(precision="f32", **dict(CYL, **extra)),
             mesh_shape, n_sub, "tiled", n_sub)
