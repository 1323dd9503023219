"""The kernel module (ops/step_cuda.py, whose CPU path is the plain
version) under each 3-D collision operator, through the port's chunk
stepper, against tpulbm's 3-D Pallas kernels in interpret mode through
make_chunk_fn(backend="pallas") on a (1,1) mesh, f32, on tpulbm's 3-D test
grid (32x16x8 sphere, tau 0.6, U 0.05), two chunks.

Tolerances are tpulbm's own pallas-vs-jax gates: rtol 5e-6 / atol 1e-7
(tests/test_3d.py, test_mrt.py, test_les.py, test_regularized.py), and
rtol 1e-4 / atol 1e-7 for the power law (tests/test_power_law.py's
_PLAW_RTOL: its Newton solve on exp and log).

* each operator at depth 1 on the full-plane kernel
  (make_local_step_pallas3d, TPULBM_NO_FUSED2), as test_torch_3d.py holds
  BGK; the port's 1-step wrapper;
* the heaviest collisions, MRT (rank 10) and the power law, through the
  y-tiled cascade (make_local_step_pallas3d_tiled) forced at n_sub 3 and
  2; the port's N-step wrapper.
"""
import jax
import numpy as np
import pytest

from tpulbm.models import make_problem as jax_problem
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state
from tpulbm_torch import stepper
from tpulbm_torch.convert import state_from_numpy, state_to_numpy
from test_torch_3d import F32_TOL, _pallas3d_chunks, _params, _port_chunks
from test_torch_3d_blocking import _setenv, _spy_tiled
from test_torch_3d_collisions import OPERATORS
from test_torch_compat import port_problem

PLAW_TOL = dict(rtol=1e-4, atol=1e-7)


def _tol(op):
    return PLAW_TOL if op == "power_law" else F32_TOL


@pytest.mark.parametrize("op", OPERATORS)
def test_kernel_module_matches_pallas3d_1step(monkeypatch, op):
    params = _params(precision="f32", **OPERATORS[op])
    ref = _pallas3d_chunks(monkeypatch, params, "full_plane")
    got = _port_chunks(params)
    for k, (r, g) in enumerate(zip(ref, got)):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, err_msg=f"chunk {k}", **_tol(op))


@pytest.mark.parametrize("n_sub", [3, 2])
@pytest.mark.parametrize("op", ["mrt", "power_law"])
def test_kernel_module_matches_pallas3d_cascade(monkeypatch, op, n_sub):
    _setenv(monkeypatch, {"TPULBM_SUBSTEPS": str(n_sub)})
    built = _spy_tiled(monkeypatch)
    params = _params(precision="f32", **OPERATORS[op])
    jproblem = jax_problem(params)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    chunk_len = 2 * n_sub
    ref = jax_chunk_fn(jproblem, mesh, chunk_len, backend="pallas")
    assert ref.pallas3d_depths == [n_sub]
    assert [d for d, ok in built if ok] == [n_sub]
    problem = port_problem(params)
    port = stepper.make_chunk_fn(problem, "cpu", chunk_len)
    assert port.plan == [(n_sub, 2)]
    f, solid = shard_state(mesh, jproblem.initial_state(), jproblem.solid)
    g = state_from_numpy(jproblem.initial_state(), problem, "cpu")
    for k in range(2):
        f = ref(f, solid)
        g = port(g)
        np.testing.assert_allclose(state_to_numpy(g),
                                   np.asarray(jax.device_get(f)),
                                   err_msg=f"chunk {k}", **_tol(op))
