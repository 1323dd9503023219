"""The deep forced depths against tpulbm, on the CPU: TPULBM_SUBSTEPS =
5-8 in 2-D and 4-8 in 3-D, which the deep builds of the N-step kernels
run on the card (-DTPULBM_DEEP=1).

* The plans: the 2-D depth (one device) and the 3-D plan's depths against
  tpulbm's make_chunk_fn(backend="pallas") for chunk lengths each depth
  divides and does not, on grids where only the conditions the port keeps
  decide (2-D: 96 rows at TPULBM_PALLAS_TY=8 hold 12 slabs, more than
  N + 1; 3-D: nz 10, and nz 6 below N + 1 from N = 6 on); a forced 3-D
  depth above tpulbm's halo height of 8 gets no plan (tpulbm's TPU
  dispatch; its interpret mode widens the halo to the depth and plans it);
  an x-cut mesh at depth 5 raises as tpulbm's x-tiled builder asserts
  (step_pallas_tiled.py:133).
* The kernel module (its plain path on the CPU, N plain steps a launch)
  from a seeded ±10% perturbed state, one launch at N times the one-step
  tolerance (rtol 5e-6, atol 1e-7: the Pallas kernels multiply by 1/rho
  where the plain step divides): against make_local_step_pallas3d_tiled
  in interpret mode at n_sub 4; against tpulbm's N steps (its jax tier in
  f32) at 2-D N = 5 and 8 and at 3-D n_sub 8 on D3Q19 and D3Q27, where
  tpulbm's Pallas cascades in interpret mode miss tpulbm's own steps
  (pinned at 2-D N = 5: by more than 100 tolerances).
* Meshes: (4, 1) at 2-D N=8 in the "rows" and the overlap modes (shards
  of 28 rows, at least the overlap mode's 3 (N + 1)) and (2, 1) at 3-D
  N=6, each against one device (rtol 1e-5, atol 1e-6: a float32 rounding
  a step, as tests/test_torch_mesh.py).
"""
import jax
import numpy as np
import pytest
import torch

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state
from tpulbm_torch import stepper
from tpulbm_torch.convert import state_from_numpy, state_to_numpy
from tpulbm_torch.ops import step_cuda
from tpulbm_torch.parallel import sharded_step
from test_torch_compat import port_problem
from test_torch_mesh import _port_chunks, cpu_mesh, perturbed

ONE_STEP = dict(rtol=5e-6, atol=1e-7)
MESH_TOL = dict(rtol=1e-5, atol=1e-6)
ENV = ("TPULBM_NO_FUSED2", "TPULBM_SUBSTEPS", "TPULBM_FORCE_TILED",
       "TPULBM_HALO_OVERLAP", "TPULBM_PALLAS_TY")


def _setenv(monkeypatch, env):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _n_tol(n):
    return dict(rtol=n * ONE_STEP["rtol"], atol=n * ONE_STEP["atol"])


def _params2d(**kw):
    d = dict(nx=64, ny=96, tau=0.6, inlet_velocity=0.05, precision="f32")
    d.update(kw)
    return SimulationParams(**d)


def _params3d(**kw):
    d = dict(problem="cylinder3d", nx=32, ny=16, nz=10, tau=0.6,
             inlet_velocity=0.05, precision="f32")
    d.update(kw)
    return SimulationParams(**d)


def _one_mesh():
    return make_mesh((1, 1), devices=jax.devices()[:1])


# ---- the plans ---------------------------------------------------------

@pytest.mark.parametrize("chunk_len", [840, 10, 7, 24, 42])
@pytest.mark.parametrize("forced", step_cuda.DEEP_DEPTHS)
def test_2d_depth_matches_tpulbm(monkeypatch, forced, chunk_len):
    _setenv(monkeypatch, {"TPULBM_PALLAS_TY": "8",
                          "TPULBM_SUBSTEPS": str(forced)})
    params = _params2d()
    ref = jax_chunk_fn(jax_problem(params), _one_mesh(), chunk_len,
                       backend="pallas")
    port = stepper.make_chunk_fn(port_problem(params), "cpu", chunk_len)
    assert port.substeps == ref.pallas_substeps
    assert port.substeps == (forced if chunk_len % forced == 0 else 1)


@pytest.mark.parametrize("nz", [10, 6])
@pytest.mark.parametrize("chunk_len", [840, 12, 7])
@pytest.mark.parametrize("forced", step_cuda.DEEP_DEPTHS_3D)
def test_3d_plan_matches_tpulbm(monkeypatch, forced, chunk_len, nz):
    _setenv(monkeypatch, {"TPULBM_SUBSTEPS": str(forced)})
    params = _params3d(nz=nz)
    ref = jax_chunk_fn(jax_problem(params), _one_mesh(), chunk_len,
                       backend="pallas")
    port = stepper.make_chunk_fn(port_problem(params), "cpu", chunk_len)
    assert port.pallas3d_depths == ref.pallas3d_depths
    held = chunk_len % forced == 0 and nz >= forced + 1
    assert port.plan == ([(forced, chunk_len // forced)] if held
                         else [(1, chunk_len)])


def test_3d_depth_above_the_halo_height_gets_no_plan(monkeypatch):
    _setenv(monkeypatch, {"TPULBM_SUBSTEPS": "9"})
    params = _params3d()
    port = stepper.make_chunk_fn(port_problem(params), "cpu", 18)
    assert port.plan == [(1, 18)] and port.pallas3d_depths is None
    # tpulbm's interpret mode widens its halo height to the depth, where
    # its TPU build keeps H = 8 and plans nothing: the CPU differs here
    ref = jax_chunk_fn(jax_problem(params), _one_mesh(), 18,
                       backend="pallas")
    assert ref.pallas3d_depths == [9]
    assert sharded_step.plan_3d(port_problem(params), cpu_mesh((2, 1)),
                                18) == ("rows", [(1, 18)])


@pytest.mark.parametrize("env,shape", [
    ({"TPULBM_SUBSTEPS": "5"}, (2, 2)),
    ({"TPULBM_SUBSTEPS": "8"}, (1, 2)),
    ({"TPULBM_SUBSTEPS": "5", "TPULBM_FORCE_TILED": "1"}, (2, 1))],
    ids=["2x2", "1x2", "forced_tiled"])
def test_x_tiled_deep_depth_raises_as_tpulbm(monkeypatch, env, shape):
    _setenv(monkeypatch, env)
    params = _params2d(nx=64, ny=64)
    jmesh = make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
    with pytest.raises(AssertionError):
        jax_chunk_fn(jax_problem(params), jmesh, 40, backend="pallas")
    with pytest.raises(ValueError, match=r"step_pallas_tiled\.py:133"):
        sharded_step.plan(port_problem(params), cpu_mesh(shape), 40)
    # a forced depth that does not divide the chunk never reaches the
    # x-tiled builder
    assert sharded_step.plan(port_problem(params), cpu_mesh(shape), 39)[1] \
        == 1


@pytest.mark.parametrize("env,want", [
    ({"TPULBM_SUBSTEPS": "8"}, ("rows", 8)),
    ({"TPULBM_SUBSTEPS": "8", "TPULBM_HALO_OVERLAP": "1"}, ("overlap", 8)),
    ({"TPULBM_SUBSTEPS": "7", "TPULBM_HALO_OVERLAP": "1"}, ("overlap", 7))])
def test_mesh_plan_at_deep_depths(monkeypatch, env, want):
    _setenv(monkeypatch, env)
    problem = port_problem(_params2d(nx=48, ny=112))
    assert sharded_step.plan(problem, cpu_mesh((4, 1)), 56) == want
    # shards of 28 rows hold the overlap mode's 3 (N + 1) at N = 8, shards
    # of 26 do not: the 1-step ranged kernel takes the chunk
    if "TPULBM_HALO_OVERLAP" in env and want[1] == 8:
        small = port_problem(_params2d(nx=48, ny=104))
        assert sharded_step.plan(small, cpu_mesh((4, 1)), 56) == \
            ("overlap", 1)


# ---- the kernel module against tpulbm ----------------------------------

def _tpulbm_chunk(params, n_sub, backend):
    """One chunk of n_sub steps of tpulbm's make_chunk_fn from the
    perturbed state: (the state, the chunk)."""
    jproblem = jax_problem(params)
    mesh = _one_mesh()
    chunk = jax_chunk_fn(jproblem, mesh, n_sub, backend=backend)
    f, solid = shard_state(mesh, perturbed(jproblem), jproblem.solid)
    return np.asarray(jax.device_get(chunk(f, solid))), chunk


def _port_launch(params, n_sub):
    """One launch of the port's N-step kernel module (N plain steps on the
    CPU) from the perturbed state."""
    problem = port_problem(params)
    chunk = stepper.make_chunk_fn(problem, "cpu", n_sub)
    assert chunk.plan == [(n_sub, 1)]
    f0 = perturbed(jax_problem(params))
    return state_to_numpy(chunk(state_from_numpy(f0, problem, "cpu")))


@pytest.mark.parametrize("n_sub", [5, 8])
def test_2d_deep_launch_matches_tpulbm_steps(monkeypatch, n_sub):
    # tpulbm's N-step cascade misses its own steps above N = 4 (the next
    # test), so the port's deep launch is held to tpulbm's N steps: its
    # jax tier in f32
    _setenv(monkeypatch, {"TPULBM_SUBSTEPS": str(n_sub)})
    params = _params2d(nx=64, ny=80)
    want, _ = _tpulbm_chunk(params, n_sub, "jax")
    np.testing.assert_allclose(_port_launch(params, n_sub), want,
                               **_n_tol(n_sub))


def test_tpulbm_2d_cascade_above_four_misses_its_steps(monkeypatch):
    # tpulbm's make_local_step_pallasN in interpret mode agrees with its
    # own jax tier at N = 4 (its tests/test_pallas.py::test_pallasN_cylinder)
    # and misses it at N = 5 by far more than a rounding: the port does not
    # follow its Pallas kernel above N = 4
    _setenv(monkeypatch, {"TPULBM_PALLAS_TY": "8", "TPULBM_SUBSTEPS": "5"})
    params = _params2d(nx=64, ny=48)
    got, chunk = _tpulbm_chunk(params, 5, "pallas")
    assert chunk.pallas_substeps == 5
    want, _ = _tpulbm_chunk(params, 5, "jax")
    tol = _n_tol(5)
    miss = np.abs(got - want) / (tol["atol"] + tol["rtol"] * np.abs(want))
    assert miss.max() > 100
    np.testing.assert_allclose(_port_launch(params, 5), want, **tol)


def test_3d_deep_launch_matches_pallas3d_cascade(monkeypatch):
    _setenv(monkeypatch, {"TPULBM_SUBSTEPS": "4"})
    params = _params3d(nx=16, ny=8)
    want, chunk = _tpulbm_chunk(params, 4, "pallas")
    assert chunk.pallas3d_depths == [4]
    np.testing.assert_allclose(_port_launch(params, 4), want, **_n_tol(4))


@pytest.mark.parametrize("lattice", ["d3q19", "d3q27"])
def test_3d_deepest_launch_matches_tpulbm_steps(monkeypatch, lattice):
    # at n_sub 8 tpulbm's 3-D cascade in interpret mode misses its own
    # steps too (PERF.md): the port is held to its jax tier in f32
    _setenv(monkeypatch, {"TPULBM_SUBSTEPS": "8"})
    params = _params3d(nx=16, ny=8, lattice3d=lattice)
    want, _ = _tpulbm_chunk(params, 8, "jax")
    np.testing.assert_allclose(_port_launch(params, 8), want, **_n_tol(8))


# ---- meshes against one device ----------------------------------------

@pytest.mark.parametrize("env,mode", [
    ({"TPULBM_SUBSTEPS": "8"}, "rows"),
    ({"TPULBM_SUBSTEPS": "8", "TPULBM_HALO_OVERLAP": "1"}, "overlap")])
def test_2d_mesh_at_depth_eight_matches_one_device(monkeypatch, env, mode):
    _setenv(monkeypatch, env)
    params = _params2d(nx=48, ny=112)
    f0 = perturbed(jax_problem(params))
    got, chunk = _port_chunks(params, (4, 1), 16, 2, f0, backend="pallas")
    assert (chunk.mode, chunk.substeps) == (mode, 8)
    one = stepper.make_chunk_fn(port_problem(params), "cpu", 16)
    assert one.plan == [(8, 2)]
    g = torch.from_numpy(f0.copy())
    for k in range(2):
        g = one(g)
        np.testing.assert_allclose(got[k], g.numpy(), err_msg=f"chunk {k}",
                                   **MESH_TOL)


def test_3d_mesh_at_depth_six_matches_one_device(monkeypatch):
    _setenv(monkeypatch, {"TPULBM_SUBSTEPS": "6"})
    params = _params3d(nz=8)
    problem = port_problem(params)
    f0 = perturbed(jax_problem(params))
    got, chunk = _port_chunks(params, (2, 1), 12, 1, f0, backend="pallas")
    assert (chunk.mode, chunk.plan) == ("rows", [(6, 2)])
    one = stepper.make_chunk_fn(problem, "cpu", 12)
    assert one.plan == [(6, 2)]
    g = one(state_from_numpy(f0, problem, "cpu"))
    np.testing.assert_allclose(got[0], state_to_numpy(g), **MESH_TOL)
