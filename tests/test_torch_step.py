"""The port's steps against tpulbm's on the same initial states.

* plain step (ops/step_torch.py) vs tpulbm.ops.step_jax.make_step_rolled,
  f64, 60 steps, rtol 1e-12: same algorithm, same operation order, so the
  two agree to f64 round-off;
* plain step and forces vs the loop-based NumPy oracle of the reference
  solver (tests/test_step_oracle.py), f64, on fluid cells;
* the kernel module (ops/step_cuda.py, whose CPU path is the plain
  version) through the port's chunk stepper vs tpulbm's Pallas 1-step
  kernel in interpret mode through make_chunk_fn(backend="pallas") on a
  (1,1) mesh, f32, rtol 5e-6 / atol 1e-7 (tests/test_pallas.py's
  pallas-vs-jax tolerance: the Pallas kernel multiplies by 1/rho where the
  plain step divides);
* the same against tpulbm's main-path kernel, the N=4 cascade.
"""
import time

import jax
import numpy as np
import pytest
import torch

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.ops.step_jax import make_step_rolled as jax_step_rolled
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state
from tpulbm_torch.convert import state_from_numpy, state_to_numpy
from tpulbm_torch.ops.forces import forces_fn
from tpulbm_torch.ops.step_torch import make_step_rolled
from tpulbm_torch.stepper import make_chunk_fn
from test_torch_compat import port_problem

F32_TOL = dict(rtol=5e-6, atol=1e-7)


def _params(**kw):
    d = dict(nx=64, ny=32, tau=0.6, inlet_velocity=0.05, precision="f32")
    d.update(kw)
    return SimulationParams(**d)


def test_plain_step_matches_jax_rolled_f64():
    params = _params(precision="f64")
    jstep = jax.jit(jax_step_rolled(jax_problem(params)))
    problem = port_problem(params)
    tstep = make_step_rolled(problem, "cpu")
    fj = problem.initial_state()
    ft = state_from_numpy(fj, problem, "cpu")
    for _ in range(60):
        fj = jstep(fj)
        ft = tstep(ft)
    np.testing.assert_allclose(state_to_numpy(ft), np.asarray(fj),
                               rtol=1e-12, atol=0.0)


def test_plain_step_and_forces_match_numpy_oracle():
    # tests/test_step_oracle.py's loop-for-loop NumPy re-creation of the
    # reference solver, f64; fluid cells only (the reference's solid cells
    # hold dynamically dead values, the port's the rest equilibrium)
    from test_step_oracle import Oracle
    params = _params(nx=48, ny=24, precision="f64")
    problem = port_problem(params)
    oracle = Oracle(params, problem.solid)
    step = make_step_rolled(problem, "cpu")
    force = forces_fn(problem, "cpu")
    f = state_from_numpy(problem.initial_state(), problem, "cpu")
    fluid = ~problem.solid
    for t in range(12):
        oracle.collision()
        np.testing.assert_allclose(force(f).numpy(), oracle.record_forces(),
                                   rtol=1e-10, atol=1e-14,
                                   err_msg=f"force {t}")
        oracle.exchange_ghost_cells()
        oracle.streaming()
        oracle.boundary_conditions()
        f = step(f)
        np.testing.assert_allclose(state_to_numpy(f)[:, fluid],
                                   oracle.interior()[:, fluid], rtol=1e-12,
                                   atol=1e-15, err_msg=f"step {t}")


def _jax_pallas_chunks(params, chunk_len, n_chunks):
    problem = jax_problem(params)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    chunk = jax_chunk_fn(problem, mesh, chunk_len, backend="pallas")
    f, solid = shard_state(mesh, problem.initial_state(), problem.solid)
    out = []
    for _ in range(n_chunks):
        f = chunk(f, solid)
        out.append(np.asarray(jax.device_get(f)))
    return chunk, out


def _port_chunks(params, chunk_len, n_chunks):
    problem = port_problem(params)
    chunk = make_chunk_fn(problem, "cpu", chunk_len, backend="pallas")
    f = state_from_numpy(problem.initial_state(), problem, "cpu")
    out = []
    for _ in range(n_chunks):
        f = chunk(f)
        out.append(state_to_numpy(f).copy())
    return out


# the third case puts solid cells on the inlet column and the bottom wall
# row, corner included: the BCs must leave them to the obstacle pin
@pytest.mark.parametrize("kw", [
    dict(nx=256, ny=64, tau=0.6, inlet_velocity=0.05),
    dict(nx=128, ny=96, tau=0.55, inlet_velocity=0.04),
    dict(nx=64, ny=32, cylinder_x=0.03, cylinder_y=0.06,
         cylinder_radius=0.12)])
def test_kernel_module_matches_pallas_1step(kw):
    # chunk_len=5 divides by none of 2, 3, 4: tpulbm runs its 1-step kernel
    params = _params(**kw)
    chunk, ref = _jax_pallas_chunks(params, 5, 3)
    assert chunk.pallas_substeps == 1
    got = _port_chunks(params, 5, 3)
    for k, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(g, r, err_msg=f"chunk {k}", **F32_TOL)


def test_kernel_module_matches_pallas_main_path_cascade(monkeypatch):
    # chunk_len=4 selects the N=4 cascade, tpulbm's main-path kernel
    monkeypatch.setenv("TPULBM_PALLAS_TY", "8")
    params = _params(nx=128, ny=64)
    t0 = time.perf_counter()
    chunk, ref = _jax_pallas_chunks(params, 4, 2)
    assert chunk.pallas_substeps == 4
    got = _port_chunks(params, 4, 2)
    for k, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(g, r, err_msg=f"chunk {k}", **F32_TOL)
    print(f"N=4 cascade comparison: {time.perf_counter() - t0:.1f} s")


def test_plain_backend_chunk_runs_f64():
    params = _params(precision="f64")
    problem = port_problem(params)
    f = state_from_numpy(problem.initial_state(), problem, "cpu")
    chunk = make_chunk_fn(problem, "cpu", 7, backend="jax")
    step = make_step_rolled(problem, "cpu")
    want = f.clone()
    for _ in range(7):
        want = step(want)
    torch.testing.assert_close(chunk(f), want, rtol=0.0, atol=0.0)


def test_kernel_backend_refuses_f64():
    problem = port_problem(_params(precision="f64"))
    with pytest.raises(NotImplementedError):
        make_chunk_fn(problem, "cpu", 5, backend="pallas")
