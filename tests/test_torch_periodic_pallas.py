"""The kernel module in the periodic box (ops/step_cuda.py, the ring
builds of parallel/sharded_step.py and ops/step_thermal_cuda.py, whose CPU
paths are the plain versions) against tpulbm's Pallas kernels in
interpret mode through make_chunk_fn(backend="pallas"), f32, one chunk
from a seeded ±10% perturbed state (a y edge rule that survived into the
box would show only away from equilibrium):

* rows 1-3 on one device (make_local_step_pallas, make_local_step_pallasN
  at N = 4 and 3, make_local_step_pallas2): Taylor-Green, Kolmogorov's
  force along y and tpulbm's test force along x;
* rows 1 and 4 with ring rows on (2,1): the 1-step kernel with the rings
  wrapping in y, and the overlap mode's ranged 1-step kernel;
* row 5, the x-tiled kernel, on (1,2) and (2,2) with either force;
* row 8, the thermal kernel, on the stirred passive scalar.

Tolerances are tpulbm's own pallas-vs-jax gates: rtol 5e-6 / atol 1e-7
(tests/test_periodic.py), atol 5e-7 with a force
(tests/test_kolmogorov.py:138, 179), rtol 2e-5 for the x-tiled kernel
(tests/test_pallas_tiled.py:48-57).
"""
import dataclasses

import jax
import numpy as np
import pytest

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.parallel.mesh import make_mesh as jax_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state as jax_shard_state
from tpulbm_torch.convert import split_state
from tpulbm_torch.parallel import sharded_step
from test_torch_3d_blocking import _setenv
from test_torch_compat import port_problem
from test_torch_mesh import cpu_mesh
from test_torch_periodic import _noisy, _x_force

TOL = dict(rtol=5e-6, atol=1e-7)
FORCE_TOL = dict(rtol=5e-6, atol=5e-7)
TILED_TOL = dict(rtol=2e-5, atol=5e-7)
BOX = dict(nx=32, ny=16, tau=0.8, inlet_velocity=0.04, kolmogorov_n=2,
           periodic_x=True, cylinder_radius=0.0, precision="f32")


def _compare(name, mesh_shape, chunk_len, tol, x_force=False, mode=None,
             depth=None, **kw):
    params = SimulationParams(problem=name, **{**BOX, **kw})
    ref, mine = jax_problem(params), port_problem(params)
    if x_force:
        fn, prof = _x_force(params)
        ref = dataclasses.replace(ref, force_fn=fn)
        mine = dataclasses.replace(mine, force_profile=prof)
    f0 = _noisy(ref.initial_state(), 13)
    n = mesh_shape[0] * mesh_shape[1]
    mesh = jax_mesh(mesh_shape, devices=jax.devices()[:n])
    chunk = jax_chunk_fn(ref, mesh, chunk_len, backend="pallas")
    if depth is not None:
        assert chunk.pallas_substeps == depth
    f, solid = jax_shard_state(mesh, f0, np.zeros(ref.spatial_shape, bool))
    want = np.asarray(jax.device_get(chunk(f, solid)))
    port = sharded_step.make_chunk_fn(mine, cpu_mesh(mesh_shape), chunk_len)
    if mode is not None:
        assert (port.mode, port.substeps) == (mode, depth)
    got = sharded_step.gather(port(split_state(f0, mine,
                                               cpu_mesh(mesh_shape))))
    got = got.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("name,x_force,env,chunk_len,depth", [
    ("kolmogorov", False, {}, 5, 1),
    ("kolmogorov", True, {}, 5, 1),
    ("kolmogorov", False, {"TPULBM_SUBSTEPS": "4", "TPULBM_PALLAS_TY": "4"},
     4, 4),
    ("kolmogorov", True, {"TPULBM_SUBSTEPS": "3"}, 3, 3),
    ("taylor-green", False, {"TPULBM_SUBSTEPS": "2"}, 2, 2)],
    ids=["row1-y", "row1-x", "row2-n4-y", "row2-n3-x", "row3-n2"])
def test_one_device_kernels_match_pallas(monkeypatch, name, x_force, env,
                                         chunk_len, depth):
    _setenv(monkeypatch, {"TPULBM_PALLAS_TY": "8", **env})
    tol = FORCE_TOL if name == "kolmogorov" else TOL
    _compare(name, (1, 1), chunk_len, tol, x_force,
             mode="one-device", depth=depth)


@pytest.mark.parametrize("name,env,mode", [
    ("kolmogorov", {"TPULBM_NO_FUSED2": "1"}, "rows"),
    ("taylor-green", {"TPULBM_HALO_OVERLAP": "1", "TPULBM_NO_FUSED2": "1"},
     "overlap")], ids=["row1-rings", "row4-ranged"])
def test_ring_rows_match_pallas(monkeypatch, name, env, mode):
    # slabs of 2 rows: the ranged kernel needs 3 slabs a shard
    _setenv(monkeypatch, {"TPULBM_PALLAS_TY": "2", **env})
    _compare(name, (2, 1), 2, FORCE_TOL, mode=mode, depth=1)


@pytest.mark.parametrize("mesh_shape,x_force,n_sub", [
    ((1, 2), False, 1), ((2, 2), True, 2)], ids=["1x2-y-n1", "2x2-x-n2"])
def test_tiled_kernel_matches_pallas(monkeypatch, mesh_shape, x_force,
                                     n_sub):
    _setenv(monkeypatch, {"TPULBM_SUBSTEPS": str(n_sub)} if n_sub > 1
            else {"TPULBM_NO_FUSED2": "1"})
    _compare("kolmogorov", mesh_shape, 2, TILED_TOL, x_force, mode="tiled",
             depth=n_sub)


def test_thermal_kernel_matches_pallas_on_the_passive_scalar(monkeypatch):
    _setenv(monkeypatch, {})
    _compare("passive-scalar", (1, 1), 3, TOL, thermal_tau=0.5704)
