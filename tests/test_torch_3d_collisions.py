"""The D3Q19 sphere in a duct under tpulbm's 3-D collision operators (TRT,
MRT, regularized, Smagorinsky, power law) against tpulbm, on the CPU.

* the Problem's operator fields equal tpulbm's for each operator; KBC in
  3-D raises tpulbm's ValueError;
* each operator's collide_block, momentum-exchange force and the plain step
  (60 steps) against tpulbm's jax tier in f64 at rtol 1e-12, on the sphere
  and the ragged grid of test_torch_3d.py;
* the D3Q19 kernels' mode coefficients (ops/step_cuda.py::mode_floats)
  against those tpulbm's two 3-D Pallas builders compute, and MRT's rank
  zero-padded to the kernels' ten; the kernels' collision code itself
  (csrc/d3q19_common.cuh), built for the host with g++, against tpulbm's
  _collide_planes_core in float32;
* the Runner's launch plan under each operator equals BGK's (735 N=3, 17
  N=2, 1 one-step launch at the 3-D cell's cadence), all of the operator's
  libraries; MRT's and the power law's Runner artifacts against tpulbm's
  Runner; the CLI runs an operator on the sphere.

The kernel module against tpulbm's 3-D Pallas kernels in interpret mode
is tests/test_torch_3d_collisions_pallas.py; the CUDA kernels themselves
run only on the card (tests/test_torch_cuda.py).
"""
import dataclasses
import shutil
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulbm.ops.step_pallas3d as jax_pallas3d
from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.ops import forces as jforces
from tpulbm.ops.step_jax import _collide_block as jax_collide_block
from tpulbm.ops.step_jax import make_step_rolled as jax_step_rolled
from tpulbm_torch.convert import state_from_numpy, state_to_numpy
from tpulbm_torch.ops import forces, step_cuda, step_torch
from tpulbm_torch.ops.step_torch import make_step_rolled
from tpulbm_torch.utils import cuda_build
from tpulbm.runner import Runner as JaxRunner
from tpulbm_torch.runner import Runner
from test_torch_3d import (F64_TOL, _assert_artifacts_close, _noisy_state,
                           _params, _runner_params)
from test_torch_compat import port_params, port_problem

# the operators as a user sets them, tpulbm's defaults unless a case names
# another value: TRT at the magic 3/16, MRT at D3Q19's default ghost rates
# (rank 10), regularized, Smagorinsky Cs 0.17, the power law at n 0.7 (k =
# nu, as SimulationParams.power_law() sets it)
OPERATORS = {
    "trt": dict(collision="trt"),
    "mrt": dict(collision="mrt"),
    "regularized": dict(collision="regularized"),
    "les": dict(smagorinsky=0.17),
    "power_law": dict(power_law_n=0.7),
}
FIELDS = ("collision", "trt_magic", "mrt_rates", "smagorinsky", "power_law")


@pytest.mark.parametrize("op", list(OPERATORS) + ["trt_magic", "mrt_rates",
                                                  "power_law_k"])
def test_problem_fields_match_tpulbm(op):
    extra = {"trt_magic": dict(collision="trt", trt_magic=0.25),
             "mrt_rates": dict(collision="mrt",
                               mrt_rates=(("e", 1.5), ("mx", 1.9))),
             "power_law_k": dict(power_law_n=1.3, power_law_k=0.02)}
    params = _params(**OPERATORS.get(op, extra.get(op)))
    mine, ref = port_problem(params), jax_problem(params)
    for name in FIELDS:
        assert getattr(mine, name) == getattr(ref, name), name
    assert mine.initial_state().tobytes() == ref.initial_state().tobytes()


def test_kbc_in_3d_raises_tpulbm_error():
    with pytest.raises(ValueError, match="D2Q9"):
        port_problem(_params(collision="kbc"))


# ---- the plain step against tpulbm's jax tier, f64 --------------------

@pytest.mark.parametrize("op", OPERATORS)
def test_collide_block_and_forces_match_tpulbm(op):
    params = _params("ragged", **OPERATORS[op])
    problem, jproblem = port_problem(params), jax_problem(params)
    f = _noisy_state(problem, 13)
    got = step_torch.collide_block(problem, torch.from_numpy(f))
    want = jax_collide_block(jproblem, jnp.asarray(f), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)
    # the force samples collide with the plain operator, as tpulbm's do
    fgot = forces.forces_fn(problem, "cpu")(torch.from_numpy(f))
    fwant = jforces.forces_fn(jproblem)(jnp.asarray(f))
    np.testing.assert_allclose(fgot.numpy(), np.asarray(fwant), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("geometry", ["sphere", "ragged"])
@pytest.mark.parametrize("op", OPERATORS)
def test_plain_step_matches_jax_rolled_f64(op, geometry):
    params = _params(geometry, **OPERATORS[op])
    jstep = jax.jit(jax_step_rolled(jax_problem(params)))
    problem = port_problem(params)
    tstep = make_step_rolled(problem, "cpu")
    fj = _noisy_state(problem, 21)
    ft = state_from_numpy(fj, problem, "cpu")
    for _ in range(60):
        fj = jstep(fj)
        ft = tstep(ft)
    np.testing.assert_allclose(state_to_numpy(ft), np.asarray(fj), **F64_TOL)


# ---- the kernels' mode coefficients -----------------------------------

def _pallas_cfgs(monkeypatch, problem):
    """The _Cfg3d of each of tpulbm's two 3-D builders for `problem`."""
    cfgs = []
    real = jax_pallas3d._Cfg3d

    def spy(**kw):
        cfg = real(**kw)
        cfgs.append(cfg)
        return cfg

    monkeypatch.setattr(jax_pallas3d, "_Cfg3d", spy)
    shape = problem.spatial_shape
    assert jax_pallas3d.make_local_step_pallas3d(
        problem, shape, interpret=True) is not None
    assert jax_pallas3d.make_local_step_pallas3d_tiled(
        problem, shape, 2, interpret=True) is not None
    assert len(cfgs) == 2
    return cfgs


def _expected_mode_floats(cfg) -> np.ndarray:
    """d3q19_common.cuh's ModeConsts as _collide_planes_core forms each
    coefficient from its _Cfg3d (step_pallas3d.py:160-321)."""
    Q, rank = 19, step_cuda.MRT_RANK_3D
    trt, reg, smag, plaw = np.zeros(2), np.zeros(1 + 6 * Q), np.zeros(3), \
        np.zeros(4)
    mrt_u, mrt_v = np.zeros((Q, rank)), np.zeros((rank, Q))
    if cfg.omega_minus is not None:
        trt[:] = (0.5 * cfg.inv_tau, 0.5 * cfg.omega_minus)
    if cfg.mrt_uv is not None:
        U, V = (np.array(m, np.float64) for m in cfg.mrt_uv)
        mrt_u[:, :U.shape[1]], mrt_v[:V.shape[0]] = U, V
    if cfg.reg:
        reg[0] = 1.0 - cfg.inv_tau
        reg[1:] = [4.5 * cfg.w[i] * (cfg.c[i][a] * cfg.c[i][a] - 1.0 / 3.0)
                   for a in range(3) for i in range(Q)] + [
            9.0 * cfg.w[i] * cfg.c[i][a] * cfg.c[i][b]
            for a, b in ((0, 1), (0, 2), (1, 2)) for i in range(Q)]
    if cfg.smag:
        tau0 = 1.0 / cfg.inv_tau
        smag[:] = (tau0, tau0 * tau0, 18.0 * cfg.smag * cfg.smag)
    if cfg.plaw is not None:
        k, n = cfg.plaw
        plaw[:] = (float(n) - 1.0, np.log(3.0 * k), np.log(0.5005 - 0.5),
                   np.log(20.0 - 0.5))
    return np.concatenate([trt, mrt_u.ravel(), mrt_v.ravel(), reg, smag,
                           plaw])


@pytest.mark.parametrize("op", list(OPERATORS) + ["bgk"])
def test_mode_floats_match_tpulbm_3d_builders(monkeypatch, op):
    params = _params(precision="f32", **OPERATORS.get(op, {}))
    got = np.array(step_cuda.mode_floats(port_problem(params)))
    assert got.shape == (step_cuda.MODE_FLOATS_3D,) == (504,)
    for cfg in _pallas_cfgs(monkeypatch, jax_problem(params)):
        np.testing.assert_array_equal(got, _expected_mode_floats(cfg))
    consts = step_cuda.StepConstants.of(port_problem(params))
    assert consts.mode == (op if op in ("trt", "mrt", "regularized",
                                        "power_law", "bgk")
                           else "smagorinsky")
    assert consts.modes == tuple(got)
    if op == "bgk":
        assert not got.any()


# the collisions of csrc/d3q19_common.cuh built for the host: the CUDA
# qualifiers defined away, g++ without contraction (the libraries' -fmad=false)
_HOST_COLLIDE = r"""
#define __device__
#define __forceinline__ inline
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include "d3q19_common.cuh"
int main(int argc, char** argv) {
  const int n = atoi(argv[1]);
  float* f = (float*)malloc(sizeof(float) * 19 * n);
  float mode[tpulbm3d::kModeFloats], sc[39];
  FILE* fp = fopen(argv[2], "rb");
  if (fread(sc, 4, 39, fp) != 39 ||
      fread(mode, 4, tpulbm3d::kModeFloats, fp) != tpulbm3d::kModeFloats ||
      fread(f, 4, 19 * n, fp) != (size_t)(19 * n)) return 1;
  fclose(fp);
  const tpulbm3d::Consts k = tpulbm3d::make_consts(sc[0], sc + 1, sc + 20, mode);
  for (int c = 0; c < n; ++c) tpulbm3d::collide(f + 19 * c, k);
  fp = fopen(argv[3], "wb");
  fwrite(f, 4, 19 * n, fp);
  fclose(fp);
  return 0;
}
"""


@pytest.mark.parametrize("op", OPERATORS)
def test_kernel_collisions_follow_pallas_arithmetic(monkeypatch, tmp_path, op):
    # the kernels' collision code, compiled for the CPU, against tpulbm's
    # _collide_planes_core in float32 on 4,000 perturbed cells: the same
    # operations in the same order (MRT's rank-r U/V, TRT's closed form,
    # the Pi_ab and Q-bar sums in Pallas's order) give the same floats to a
    # few ulp; the power law's Newton solve to 12 (the host's expf and logf
    # are neither the card's nor XLA's)
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the collisions for the host")
    src = tmp_path / "collide.cpp"
    src.write_text(_HOST_COLLIDE)
    exe = tmp_path / "collide"
    define = step_cuda.mode_defines(step_torch.collision_mode(port_problem(
        _params(**OPERATORS[op]))))
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", *define,
                    "-I", str(cuda_build.SOURCE_DIR), str(src), "-o",
                    str(exe)], check=True, capture_output=True)
    params = _params(precision="f32", **OPERATORS[op])
    problem = port_problem(params)
    rng = np.random.default_rng(17)
    n = 4000
    f = (problem.initial_state()[:, 0, 0, :1]
         * rng.uniform(0.6, 1.4, (19, n))).astype(np.float32)
    consts = step_cuda.StepConstants.of(problem)
    np.concatenate([np.array([consts.inv_tau, *consts.eq_in, *consts.w],
                             np.float32),
                    np.array(consts.modes, np.float32),
                    f.T.ravel()]).tofile(tmp_path / "in.bin")
    subprocess.run([str(exe), str(n), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True)
    got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(n, 19).T
    cfg = _pallas_cfgs(monkeypatch, jax_problem(params))[0]
    want = np.stack([np.asarray(v) for v in jax_pallas3d._collide_planes_core(
        cfg, [jnp.asarray(f[i]) for i in range(19)], None)])
    np.testing.assert_array_max_ulp(got, want,
                                    maxulp=12 if op == "power_law" else 2)


def test_mrt_rank_is_ten_and_lower_ranks_are_zero_padded():
    rank = step_cuda.MRT_RANK_3D
    block = slice(2, 2 + 2 * 19 * rank)
    default = np.array(step_cuda.mode_floats(
        port_problem(_params(collision="mrt"))))[block]
    u, v = default[:19 * rank].reshape(19, rank), \
        default[19 * rank:].reshape(rank, 19)
    assert (np.abs(v).sum(axis=1) > 0).all()      # rank 10: every row live
    # e and mx at 1/tau drop out of the correction: rank 8, the last two
    # columns of U and rows of V zero
    inv_tau = 1.0 / 0.6
    params = _params(collision="mrt", mrt_rates=(("e", inv_tau),
                                                 ("mx", inv_tau)))
    low = np.array(step_cuda.mode_floats(port_problem(params)))[block]
    lu, lv = low[:19 * rank].reshape(19, rank), \
        low[19 * rank:].reshape(rank, 19)
    assert not lu[:, 8:].any() and not lv[8:].any()
    assert (np.abs(lv[:8]).sum(axis=1) > 0).all()
    # the rows that stay are the default rows less e's (the first) and mx's
    keep = [k for k in range(rank) if k not in (0, 7)]
    np.testing.assert_array_equal(lv[:8], v[keep])
    np.testing.assert_array_equal(lu[:, :8], u[:, keep])


def test_3d_kernel_wrappers_refuse_what_the_libraries_do_not_hold():
    problem = port_problem(_params(precision="f32"))
    for bad in (dataclasses.replace(problem, collision="kbc"),
                dataclasses.replace(problem, collision="unknown")):
        with pytest.raises(ValueError):
            step_cuda.make_local_step_cuda_3d(bad, "cpu")
    with pytest.raises(ValueError, match="D2Q9"):   # tpulbm's KBC error
        step_cuda.mode_floats(dataclasses.replace(problem, collision="kbc"))
    assert step_cuda.COLLISION_MODES_3D == (
        "bgk", "trt", "mrt", "regularized", "smagorinsky", "power_law")
    # the defines follow the shared numbering of collision_modes.cuh
    assert [step_cuda.mode_defines(m) for m in step_cuda.COLLISION_MODES_3D] \
        == [(), ("-DTPULBM_COLLISION=1",), ("-DTPULBM_COLLISION=2",),
            ("-DTPULBM_COLLISION=3",), ("-DTPULBM_COLLISION=5",),
            ("-DTPULBM_COLLISION=6",)]


def _fake_library(mode: int, floats: int) -> types.SimpleNamespace:
    """What _bind reads of a built library: a launcher to type, the error
    string, and the mode and coefficient count the library reports."""
    return types.SimpleNamespace(
        launch=types.SimpleNamespace(),
        tpulbm_cuda_error_string=types.SimpleNamespace(),
        tpulbm_collision_mode=lambda: mode, tpulbm_mode_floats=lambda: floats)


# a library is bound only if it reports the mode it was built for and the
# coefficient count the host fills; the thermal library (no count) only
# its mode
@pytest.mark.parametrize("held,floats,n_floats,ok", [
    (2, step_cuda.MODE_FLOATS_3D, step_cuda.MODE_FLOATS_3D, True),
    (0, step_cuda.MODE_FLOATS_3D, step_cuda.MODE_FLOATS_3D, False),
    (2, step_cuda.MODE_FLOATS, step_cuda.MODE_FLOATS_3D, False),
    (2, 0, None, True), (5, 0, None, False)],
    ids=["holds", "other_mode", "other_count", "mode_only", "mode_only_other"])
def test_bind_checks_the_mode_a_library_holds(monkeypatch, held, floats,
                                              n_floats, ok):
    built, fake = [], _fake_library(held, floats)

    def load(source, defines=()):
        built.append(defines)
        return types.SimpleNamespace(lib=fake)
    monkeypatch.setattr(cuda_build, "load", load)
    if ok:
        assert step_cuda._bind("step_d3q19.cu", "launch", [], "mrt",
                               n_floats) is fake
    else:
        with pytest.raises(RuntimeError, match="built for 'mrt' holds"):
            step_cuda._bind("step_d3q19.cu", "launch", [], "mrt", n_floats)
    assert built == [("-DTPULBM_COLLISION=2",)]


# ---- the Runner's launch plan and the CLI -----------------------------

@pytest.mark.parametrize("op", OPERATORS)
def test_runner_launch_plan_equals_bgks(monkeypatch, tmp_path, op):
    # the 3-D cell's cadence (2240 steps every 140) under the operator:
    # tpulbm's plan does not depend on the collision, so exactly BGK's
    # 735 N=3, 17 N=2 and 1 one-step launches, every one of the operator's
    # libraries (the state is held: the schedule alone)
    for k in ("TPULBM_NO_FUSED2", "TPULBM_SUBSTEPS"):
        monkeypatch.delenv(k, raising=False)
    launches = {}
    for name in ("collide_stream_3d", "collide_stream_3d_blocked"):
        def spy(f, out, solid, consts, *rest, _name=name):
            depth = rest[0] if _name.endswith("blocked") else 1
            key = (consts.mode, depth)
            launches[key] = launches.get(key, 0) + 1
            return out.copy_(f)

        monkeypatch.setattr(step_cuda, name, spy)
    params = _params(nx=8, ny=6, nz=4, precision="f32", num_timesteps=2240,
                     output_frequency=140, enable_vtk=False,
                     backend="pallas", output_dir=str(tmp_path),
                     **OPERATORS[op])
    result = Runner(port_params(params), device="cpu", verbose=False).run()
    assert result.success and result.final_step == 2240
    mode = step_torch.collision_mode(port_problem(params))
    assert launches == {(mode, 3): 735, (mode, 2): 17, (mode, 1): 1}


@pytest.mark.parametrize("op", ["mrt", "power_law"])
def test_runner_artifacts_match_tpulbm(tmp_path, op):
    # the heaviest operators through the port's Runner (the kernel module's
    # CPU path, f32) against tpulbm's Runner on its jax tier: forces.csv and
    # fields3d.npz at test_torch_3d.py's artifact tolerances
    kw = dict(enable_vtk=False, **OPERATORS[op])
    ref = _runner_params(tmp_path / "ref", **kw)
    assert JaxRunner(ref, verbose=False).run().success
    got = _runner_params(tmp_path / "port", backend="pallas", **kw)
    result = Runner(port_params(got), device="cpu", verbose=False).run()
    assert result.success and result.final_step == 60
    _assert_artifacts_close(tmp_path / "port", tmp_path / "ref", got)


@pytest.mark.parametrize("flags", [["--collision", "regularized"],
                                   ["--power-law-n", "0.7"]],
                         ids=["regularized", "power_law"])
def test_cli_runs_an_operator_on_the_sphere(tmp_path, capsys, flags):
    from tpulbm_torch.__main__ import main
    rc = main(["--problem", "cylinder3d", "--nx", "16", "--ny", "8", "--nz",
               "6", "--inlet-velocity", "0.05", "--num-timesteps", "12",
               "--output-frequency", "6", "--no-vtk", "--cpu",
               "--output-dir", str(tmp_path), *flags])
    assert rc == 0
    rows = np.loadtxt(tmp_path / "forces.csv", delimiter=",", skiprows=1)
    assert rows.shape == (2, 5) and np.isfinite(rows).all()
