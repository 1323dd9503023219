"""The kernel module (ops/step_cuda.py, whose CPU path is the plain
version) in the new modes of rows 1-3 and 7, through the port's chunk
stepper, against tpulbm's Pallas kernels in interpret mode through
make_chunk_fn(backend="pallas") on a (1,1) mesh, f32, two chunks from the
initial state:

* rows 1-3 (make_local_step_pallas, make_local_step_pallasN at N = 4, 3,
  make_local_step_pallas2): the body-forced channel (src, periodic_x),
  the lid-driven cavity (walls_x, lid_u and the corner closure) and the
  cylinder with the bounce-back obstacle and a body force (bounce_back,
  src);
* row 7 (make_local_step_pallas3d_tiled) on the periodic duct at n_sub 1,
  2 and 3, where tpulbm's one-device dispatch takes the y-tiled kernel
  (its full-plane kernel refuses a periodic x).

Tolerances are tpulbm's own pallas-vs-jax gates: rtol 5e-6 / atol 1e-7
(tests/test_duct3d.py:87, test_pallas.py), and rtol 2e-5 / atol 5e-7 for
the cavity (tests/test_cavity.py:116: its corner residual cancels terms of
~0.5 down to ~1e-5).
"""
import jax
import numpy as np
import pytest

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state
from tpulbm_torch.convert import state_from_numpy, state_to_numpy
from tpulbm_torch.stepper import make_chunk_fn
from test_torch_3d_blocking import _setenv, _spy_tiled
from test_torch_compat import port_problem

F32_TOL = dict(rtol=5e-6, atol=1e-7)
CAVITY_TOL = dict(rtol=2e-5, atol=5e-7)
CASES_2D = {
    "channel": dict(problem="poiseuille", nx=32, ny=16, tau=0.8,
                    inlet_velocity=0.0, body_force=(1e-4, 2e-5)),
    "cavity": dict(problem="cavity", nx=24, ny=24, tau=0.6,
                   inlet_velocity=0.1, cylinder_radius=0.0),
    "cylinder_bounce_back": dict(nx=64, ny=32, tau=0.6, inlet_velocity=0.05,
                                 obstacle_bc="bounce_back",
                                 body_force=(1e-5, 1e-5)),
}
DUCT = dict(problem="poiseuille", nx=16, ny=8, nz=8, tau=0.8,
            inlet_velocity=0.0, body_force=(1e-4, 0.0, 1e-5))


def _compare(params, chunk_len, tol, check_ref=None):
    """Two chunks of tpulbm's Pallas chunk and of the port's, from the
    initial state."""
    jproblem = jax_problem(params)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    ref = jax_chunk_fn(jproblem, mesh, chunk_len, backend="pallas")
    if check_ref is not None:
        check_ref(ref)
    solid = (np.zeros(jproblem.spatial_shape, bool) if jproblem.solid is None
             else jproblem.solid)
    f, solid = shard_state(mesh, jproblem.initial_state(), solid)
    problem = port_problem(params)
    port = make_chunk_fn(problem, "cpu", chunk_len, backend="pallas")
    g = state_from_numpy(problem.initial_state(), problem, "cpu")
    for k in range(2):
        f = ref(f, solid)
        g = port(g)
        got = state_to_numpy(g)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(jax.device_get(f)),
                                   err_msg=f"chunk {k}", **tol)
    return port


# the 1-step kernel (chunk_len 5 divides by none of 2, 3, 4) for each mode,
# and the cascade at each depth on one mode apiece
@pytest.mark.parametrize("case,n_sub", [
    ("channel", 1), ("cavity", 1), ("cylinder_bounce_back", 1),
    ("channel", 4), ("cavity", 3), ("cylinder_bounce_back", 2)])
def test_kernel_module_matches_pallas_2d(monkeypatch, case, n_sub):
    _setenv(monkeypatch, {} if n_sub == 1 else {"TPULBM_SUBSTEPS":
                                                str(n_sub)})
    monkeypatch.setenv("TPULBM_PALLAS_TY", "8")
    params = SimulationParams(precision="f32", **CASES_2D[case])
    chunk_len = 5 if n_sub == 1 else n_sub

    def check(ref):
        assert ref.pallas_substeps == n_sub

    port = _compare(params, chunk_len,
                    CAVITY_TOL if case == "cavity" else F32_TOL, check)
    assert port.substeps == n_sub


@pytest.mark.parametrize("n_sub", [1, 2, 3])
def test_kernel_module_matches_pallas3d_tiled_on_the_duct(monkeypatch,
                                                           n_sub):
    _setenv(monkeypatch, {"TPULBM_NO_FUSED2": "1"} if n_sub == 1
            else {"TPULBM_SUBSTEPS": str(n_sub)})
    built = _spy_tiled(monkeypatch)
    params = SimulationParams(precision="f32", **DUCT)

    def check(ref):
        # the y-tiled kernel at this depth, no fallback to the jax tier
        assert [d for d, ok in built if ok] == [n_sub]
        if n_sub > 1:
            assert ref.pallas3d_depths == [n_sub]

    port = _compare(params, 2 * n_sub, F32_TOL, check)
    assert port.plan == ([(n_sub, 2)] if n_sub > 1 else [(1, 2)])
