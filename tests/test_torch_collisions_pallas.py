"""The kernel module (ops/step_cuda.py, whose CPU path is the plain
version) under each 2-D collision operator and the clean Zou-He corners,
through the port's chunk stepper, against tpulbm's Pallas kernels in
interpret mode through make_chunk_fn(backend="pallas") on a (1,1) mesh,
f32, on tpulbm's gate grid (128x64 cylinder, tau 0.55 or 0.6, U 0.05):
one chunk from the initial state and one from tpulbm's state after it.

Tolerances are tpulbm's own pallas-vs-jax gates: rtol 5e-6 / atol 1e-7
(tests/test_pallas.py, test_trt.py, test_mrt.py, test_les.py), and rtol
1e-4 / atol 1e-7 for the power law (tests/test_power_law.py's _PLAW_RTOL:
its Newton solve on exp and log). KBC holds the plain tolerance here; its
own gate (tests/test_kbc.py) is the looser max|d|/max|f| < 3e-5.

* chunk_len 5 divides by none of 2, 3, 4: both sides run one step per
  launch (make_local_step_pallas; the port's 1-step wrapper);
* the cascade at N = 4 (the main path's depth), 3 and 2 (TPULBM_SUBSTEPS
  forced, TPULBM_PALLAS_TY=8): make_local_step_pallasN and
  make_local_step_pallas2; the port's N-step wrapper.
"""
import numpy as np
import pytest

from tpulbm_torch.convert import state_from_numpy, state_to_numpy
from tpulbm_torch.stepper import make_chunk_fn
from test_torch_collisions import OPERATORS
from test_torch_compat import port_problem
from test_torch_step import F32_TOL, _jax_pallas_chunks, _params

PLAW_TOL = dict(rtol=1e-4, atol=1e-7)
# (overrides, tau) per 1-step case. TRT runs at tpulbm's own gate, the
# reference corners at tau 0.55 (tests/test_trt.py), and the clean corners
# at theirs, BGK at tau 0.6 (tests/test_pallas.py). TRT with the clean
# corners has no such gate: there the outlet corners' residual, a
# difference of nearly equal sums, puts tpulbm's own Pallas kernel at 1.4x
# the f32 tolerance from its jax tier after five steps at tau 0.55. That
# combination is held in f64 against tpulbm's plain step
# (test_torch_collisions.py) and at N=4 below.
ONE_STEP_CASES = {
    **{op: (kw, 0.55) for op, kw in OPERATORS.items() if op != "trt"},
    "trt": (dict(collision="trt"), 0.55),
    "bgk_clean_corners": (dict(zou_he_corners="clean"), 0.6)}


def _tol(kw):
    return PLAW_TOL if "power_law_n" in kw else F32_TOL


def _compare(kw, chunk_len, n_sub, tau=0.55):
    # each chunk from the same input state: the initial state, then
    # tpulbm's state after one chunk (f32 rounding differences grow over
    # chunks at tau 0.55, faster than tpulbm's tolerance allows for a
    # plain step in float32: TRT's odd modes relax at 0.235 a step)
    params = _params(nx=128, ny=64, tau=tau, **kw)
    chunk, ref = _jax_pallas_chunks(params, chunk_len, 2)
    assert chunk.pallas_substeps == n_sub
    problem = port_problem(params)
    port = make_chunk_fn(problem, "cpu", chunk_len, backend="pallas")
    assert port.substeps == n_sub
    starts = [problem.initial_state(), ref[0]]
    for k, (start, r) in enumerate(zip(starts, ref)):
        g = state_to_numpy(port(state_from_numpy(start, problem, "cpu")))
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, err_msg=f"chunk {k}", **_tol(kw))


@pytest.mark.parametrize("case", list(ONE_STEP_CASES))
def test_kernel_module_matches_pallas_1step(case):
    kw, tau = ONE_STEP_CASES[case]
    _compare(kw, 5, 1, tau)


# one operator per depth, the cheapest in interpret mode first: TRT with
# the clean corners at the main path's depth
@pytest.mark.parametrize("case,n_sub", [("trt", 4), ("mrt", 3), ("les", 2)])
def test_kernel_module_matches_pallas_cascade(monkeypatch, case, n_sub):
    monkeypatch.setenv("TPULBM_PALLAS_TY", "8")
    monkeypatch.setenv("TPULBM_SUBSTEPS", str(n_sub))
    _compare(OPERATORS[case], n_sub, n_sub)
