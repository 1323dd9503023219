"""The D3Q27 velocity set (ROADMAP Queue 1 item 16) against tpulbm, on the
CPU: the sphere in a duct, the body-forced duct and the periodic boxes on
tpulbm's `--lattice3d d3q27`.

* the lattice (velocities, weights, opposites) and the problem arrays
  byte for byte; the kernels' D3Q27 table (csrc/d3q19_common.cuh) against
  the lattice;
* the plain step against tpulbm.ops.step_jax.make_step_rolled in f64 at
  1e-12: the sphere under BGK and TRT with bounce-back and under the
  other closures, the duct, the box under each 3-D collision but MRT;
* MRT on D3Q27 raises tpulbm's ValueError (and _mrt_basis its
  AssertionError); the Bouzidi obstacle on D3Q27 builds tpulbm's Problem
  and its own library (tests/test_torch_bouzidi_d3q27.py holds it);
* the kernel module (its CPU path, the plain step) against tpulbm's 3-D
  Pallas kernels in interpret mode from a ±10% perturbed state, f32 at
  rtol 5e-6 / atol 1e-7: the sphere through the cascade at N = 3 and 2
  (row 7) and TRT with bounce-back through the full-plane 1-step kernel
  (row 6);
* the kernels' per-cell code built with g++ for the host (the sphere's
  edge rule on the corner directions, its walls, inlet, outlet and
  obstacle; the duct) against the plain step;
* the libraries (the D3Q27 bit, its 712 mode floats, the bind check of
  the library's set), the Runner's 735 / 17 / 1 launches at the 3-D
  cells' cadence (the D3Q27 sphere, and the Kolmogorov box with its
  statistics), and the Runner's forces.csv and fields3d.npz against
  tpulbm's Runner, f32 at the artifact tolerance.
"""
import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulbm import lattice as jlat
from tpulbm import physics as jphysics
from tpulbm.config import SimulationParams
from tpulbm.config import validate_params as jvalidate
from tpulbm.models import make_problem as jax_problem
from tpulbm.ops import step_jax
from tpulbm.parallel.mesh import make_mesh as jax_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state as jax_shard_state
from tpulbm.runner import Runner as JaxRunner
from tpulbm_torch import physics, stepper
from tpulbm_torch.config import validate_params
from tpulbm_torch.convert import state_from_numpy, state_to_numpy
from tpulbm_torch.lattice import D3Q27
from tpulbm_torch.ops import step_cuda, step_torch
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import cuda_build
from test_torch_3d_blocking import _setenv, _spy_tiled
from test_torch_3d_periodic import F32_TOL, PLAW_TOL, host_step
from test_torch_compat import port_params, port_problem

ART = dict(rtol=1e-4, atol=5e-6)
OPERATORS = {"bgk": {}, "trt": dict(collision="trt"),
             "regularized": dict(collision="regularized"),
             "les": dict(smagorinsky=0.17),
             "power_law": dict(power_law_n=0.7, power_law_k=0.02)}
CASES = {
    "sphere": dict(problem="cylinder3d", nx=32, ny=16, nz=8, tau=0.6,
                   inlet_velocity=0.05),
    "sphere_bounce_back": dict(problem="cylinder3d", nx=32, ny=16, nz=8,
                               tau=0.6, inlet_velocity=0.05,
                               obstacle_bc="bounce_back"),
    "duct": dict(problem="poiseuille", nx=8, ny=9, nz=7, tau=0.8,
                 periodic_x=True, cylinder_radius=0.0,
                 body_force=(1e-4, 0.0, 1e-5)),
    "box": dict(problem="kolmogorov", nx=16, ny=8, nz=12, tau=0.8,
                kolmogorov_n=2, inlet_velocity=0.05, periodic_x=True,
                cylinder_radius=0.0),
}


def _params(case, precision="f64", **kw):
    return SimulationParams(precision=precision,
                            **{"lattice3d": "d3q27", **CASES[case], **kw})


def _noisy(problem, seed):
    """The initial state times ±10% noise, the solid cells at rest."""
    f = problem.initial_state()
    rng = np.random.default_rng(seed)
    noisy = f * (1.0 + 0.1 * (2.0 * rng.random(f.shape) - 1.0))
    if problem.solid is not None:
        noisy[:, problem.solid] = f[:, problem.solid]
    return noisy.astype(f.dtype)


def test_lattice_matches_tpulbm():
    ref = jlat.D3Q27
    assert (D3Q27.name, D3Q27.D, D3Q27.velocities, D3Q27.weights) == \
        (ref.name, ref.D, ref.velocities, ref.weights)
    np.testing.assert_array_equal(D3Q27.opposite, ref.opposite)
    assert D3Q27.w.tobytes() == ref.w.tobytes()


def test_velocity_table_in_the_kernel_source_is_d3q27():
    src = (cuda_build.SOURCE_DIR / "d3q19_common.cuh").read_text()

    def block(name):
        body = src.split(f"#define {name}(X)", 1)[1].split("\n\n", 1)[0]
        return re.findall(r"X\((\d+), (-?\d), (-?\d), (-?\d), (\d+)\)", body)

    assert "TPULBM_D3Q19(X)" in src.split("#define TPULBM_D3Q27(X)", 1)[1]
    table = np.array(block("TPULBM_D3Q19") + block("TPULBM_D3Q27"),
                     dtype=int)
    assert len(table) == D3Q27.Q
    np.testing.assert_array_equal(table[:, 0], np.arange(D3Q27.Q))
    np.testing.assert_array_equal(table[:, 1:4], D3Q27.c)
    np.testing.assert_array_equal(table[:, 4], D3Q27.opposite)


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("case", ["sphere", "duct"])
def test_problem_arrays_match_tpulbm_bytewise(case, precision):
    params = _params(case, precision)
    mine, ref = port_problem(params), jax_problem(params)
    assert mine.lattice.name == ref.lattice.name == "D3Q27"
    assert (mine.body_force, mine.init_u, mine.walls_z) == \
        (ref.body_force, ref.init_u, ref.walls_z)
    for got, want in ((mine.ghost_ring_values(), ref.ghost_ring_values()),
                      (mine.initial_state(), ref.initial_state())):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    if case == "sphere":
        assert mine.solid.tobytes() == ref.solid.tobytes()


# ---- the plain step ---------------------------------------------------------

PLAIN = [(case, op) for case in ("sphere", "box") for op in OPERATORS] + [
    ("sphere_bounce_back", "bgk"), ("sphere_bounce_back", "trt"),
    ("duct", "bgk"), ("duct", "trt")]


@pytest.mark.parametrize("case,op", PLAIN,
                         ids=[f"{c}-{o}" for c, o in PLAIN])
def test_plain_step_matches_jax_rolled_f64(case, op):
    params = _params(case, **OPERATORS[op])
    ref, mine = jax_problem(params), port_problem(params)
    f = _noisy(ref, 3)
    jstep = jax.jit(step_jax.make_step_rolled(ref))
    pstep = step_torch.make_step_rolled(mine, "cpu")
    a, b = jnp.asarray(f), torch.from_numpy(f)
    for _ in range(4):
        a, b = jstep(a), pstep(b)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                               atol=1e-15)


def test_mrt_on_d3q27_raises_tpulbms_error():
    params = _params("sphere", collision="mrt")
    with pytest.raises(ValueError) as want:
        jvalidate(params)
    with pytest.raises(ValueError) as got:
        validate_params(port_params(params))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="MRT is implemented for D2Q9/D3Q19"):
        port_problem(params)
    with pytest.raises(AssertionError):
        jphysics._mrt_basis(jlat.D3Q27)
    with pytest.raises(AssertionError, match="orthogonal"):
        physics._mrt_basis(D3Q27)


def test_bouzidi_on_d3q27_builds_tpulbms_problem_and_library():
    # once refused (item 16): the Problem is tpulbm's and the kernels take
    # it through the D3Q27 Bouzidi library (tests/test_torch_bouzidi_d3q27.py)
    params = _params("sphere", obstacle_bc="bouzidi")
    mine, ref = port_problem(params), jax_problem(params)
    assert mine.solid.tobytes() == ref.solid.tobytes()
    assert mine.obstacle_bc == ref.obstacle_bc == "bouzidi"
    consts = step_cuda.kernel_constants(port_problem(
        _params("sphere", "f32", obstacle_bc="bouzidi")), 19)
    assert consts.library == "bgk+bouzidi+d3q27"
    assert consts.variant == step_cuda.BOUZIDI | step_cuda.D3Q27


# ---- the kernel module against tpulbm's Pallas kernels ------------------

@pytest.mark.parametrize("case,op,chunk_len,depths", [
    ("sphere", "bgk", 5, [3, 2]),
    ("sphere_bounce_back", "trt", 1, None)],
    ids=["sphere-cascade", "bounce-back-trt-full-plane"])
def test_kernel_module_matches_pallas3d(monkeypatch, case, op, chunk_len,
                                        depths):
    _setenv(monkeypatch, {})
    built = _spy_tiled(monkeypatch)
    params = _params(case, "f32", **OPERATORS[op])
    ref = jax_problem(params)
    mesh = jax_mesh((1, 1), devices=jax.devices()[:1])
    jchunk = jax_chunk_fn(ref, mesh, chunk_len, backend="pallas")
    assert jchunk.pallas3d_depths == depths
    assert [d for d, ok in built if ok] == (depths or [])
    mine = port_problem(params)
    pchunk = stepper.make_chunk_fn(mine, "cpu", chunk_len)
    assert pchunk.pallas3d_depths == depths
    f0 = _noisy(ref, 17)
    f, solid = jax_shard_state(mesh, f0, ref.solid)
    g = state_from_numpy(f0, mine, "cpu")
    for k in range(1 if depths else 2):
        f = jchunk(f, solid)
        g = pchunk(g)
        np.testing.assert_allclose(state_to_numpy(g),
                                   np.asarray(jax.device_get(f)),
                                   err_msg=f"chunk {k}", **F32_TOL)


# ---- the kernels' per-cell code on the host ---------------------------------

HOST = [("sphere", "bgk"), ("sphere", "power_law"),
        ("sphere_bounce_back", "trt"), ("duct", "regularized"),
        ("box", "les")]


@pytest.mark.parametrize("case,op", HOST, ids=[f"{c}-{o}" for c, o in HOST])
def test_kernel_code_matches_plain_step(tmp_path, case, op):
    # the sphere's ragged grid puts the sphere's edge rule, walls, inlet,
    # outlet and obstacle on the corner directions
    kw = dict(nx=21, ny=11, nz=9) if case.startswith("sphere") else {}
    mine = port_problem(_params(case, "f32", **OPERATORS[op], **kw))
    f = _noisy(mine, 29)
    got = host_step(tmp_path, mine, f)
    want = step_torch.make_step_rolled(mine, "cpu")(torch.from_numpy(f))
    np.testing.assert_allclose(got, want.numpy(),
                               **(PLAW_TOL if op == "power_law"
                                  else F32_TOL))
    # the corners act: the same step on D3Q19 differs
    d3q19 = port_problem(_params(case, "f32", lattice3d="d3q19",
                                 **OPERATORS[op], **kw))
    assert d3q19.lattice.Q == 19 and got.shape[0] == 27


# ---- libraries, launches, the Runner ----------------------------------------

@pytest.mark.parametrize("case,op,library", [
    ("sphere", "bgk", "bgk+d3q27"),
    ("sphere_bounce_back", "trt", "trt+bounce_back+d3q27"),
    ("duct", "les", "smagorinsky+duct+source+d3q27"),
    ("box", "power_law", "power_law+box+force+d3q27")])
def test_step_constants_pick_the_d3q27_library(case, op, library):
    mine = port_problem(_params(case, "f32", **OPERATORS[op]))
    consts = step_cuda.kernel_constants(mine, 19)
    assert consts.library == library
    assert consts.variant & step_cuda.D3Q27
    assert "-DTPULBM_Q=27" in step_cuda.build_defines(consts.mode,
                                                      consts.variant)
    assert len(consts.w) == len(consts.eq_in) == 27
    assert len(consts.modes) == step_cuda.mode_floats_3d(27) == 712
    # tpulbm's Pallas cfg reads the same coefficients where it has them
    if op == "trt":
        assert consts.modes[:2] == (
            0.5 / mine.params.tau,
            0.5 * physics.omega_minus_trt(1.0 / mine.params.tau,
                                          mine.trt_magic))


@pytest.mark.parametrize("held_q,ok", [(27, True), (19, False)])
def test_bind_checks_the_set_a_library_holds(monkeypatch, held_q, ok):
    fake = types.SimpleNamespace(
        launch=types.SimpleNamespace(),
        tpulbm_cuda_error_string=types.SimpleNamespace(),
        tpulbm_collision_mode=lambda: 0,
        tpulbm_mode_floats=lambda: step_cuda.mode_floats_3d(27),
        tpulbm_build_variant=lambda: step_cuda.D3Q27,
        tpulbm_lattice_q=lambda: held_q)
    built = []

    def load(source, defines=()):
        built.append(defines)
        return types.SimpleNamespace(lib=fake)

    monkeypatch.setattr(cuda_build, "load", load)
    if ok:
        assert step_cuda._bind_3d("step_d3q19.cu", "launch", [], "bgk",
                                  step_cuda.D3Q27) is fake
    else:
        with pytest.raises(RuntimeError, match="built for D3Q27 holds D3Q19"):
            step_cuda._bind_3d("step_d3q19.cu", "launch", [], "bgk",
                               step_cuda.D3Q27)
    assert built == [("-DTPULBM_Q=27",)]


@pytest.mark.parametrize("case,kw", [
    ("sphere", {}), ("box", dict(lattice3d="d3q19", stats_from=1120))],
    ids=["sphere-d3q27", "kolmogorov-box-stats"])
def test_runner_launch_plan(monkeypatch, tmp_path, case, kw):
    # the 3-D cells' cadence (2240 steps every 140): tpulbm's plan does not
    # depend on the set or on periodicity, so exactly 735 N=3, 17 N=2 and
    # 1 one-step launches of the case's library (the state is held: the
    # schedule alone)
    _setenv(monkeypatch, {})
    launches = {}
    for name in ("collide_stream_3d", "collide_stream_3d_blocked"):
        def spy(f, out, solid, consts, *rest, _name=name):
            depth = rest[0] if _name.endswith("blocked") else 1
            key = (consts.library, depth)
            launches[key] = launches.get(key, 0) + 1
            return out.copy_(f)

        monkeypatch.setattr(step_cuda, name, spy)
    params = _params(case, "f32", **{**dict(nx=8, ny=6, nz=4),
                                     **kw}).replace(
        num_timesteps=2240, output_frequency=140, enable_vtk=False,
        output_dir=str(tmp_path))
    result = Runner(port_params(params), device="cpu", verbose=False).run()
    assert result.success and result.final_step == 2240
    library = step_cuda.kernel_constants(port_problem(params), 19).library
    assert launches == {(library, 3): 735, (library, 2): 17,
                        (library, 1): 1}
    if "stats_from" in kw:
        with np.load(tmp_path / "stats_fields.npz") as st:
            assert int(st["n_samples"]) == 8
            assert int(st["first_step"]) == 1120


@pytest.mark.parametrize("case", ["sphere_bounce_back", "duct"])
def test_runner_artifacts_match_tpulbm(tmp_path, case):
    kw = dict(num_timesteps=60, output_frequency=20, enable_vtk=False)
    op = OPERATORS["trt"] if case == "sphere_bounce_back" else {}
    ref = _params(case, "f32", backend="jax", output_dir=str(tmp_path / "ref"),
                  **op, **kw)
    assert JaxRunner(ref, verbose=False).run().success
    got = port_params(ref.replace(backend="pallas",
                                  output_dir=str(tmp_path / "port")))
    result = Runner(got, device="cpu", verbose=False).run()
    assert result.success and result.final_step == 60
    with np.load(tmp_path / "port" / "fields3d.npz") as a, \
            np.load(tmp_path / "ref" / "fields3d.npz") as b:
        for k in ("rho", "ux", "uy", "uz"):
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **ART)
    if case.startswith("sphere"):
        rows = [np.loadtxt(tmp_path / d / "forces.csv", delimiter=",",
                           skiprows=1) for d in ("port", "ref")]
        np.testing.assert_array_equal(rows[0][:, 0], rows[1][:, 0])
        np.testing.assert_allclose(rows[0][:, 1:3], rows[1][:, 1:3], **ART)


def test_cli_runs_the_d3q27_sphere(tmp_path):
    from tpulbm_torch.__main__ import main
    assert main(["--problem", "cylinder3d", "--lattice3d", "d3q27", "--nx",
                 "16", "--ny", "8", "--nz", "6", "--inlet-velocity", "0.05",
                 "--num-timesteps", "12", "--output-frequency", "6",
                 "--no-vtk", "--cpu", "--output-dir", str(tmp_path)]) == 0
    rows = np.loadtxt(tmp_path / "forces.csv", delimiter=",", skiprows=1)
    assert rows.shape == (2, 5) and np.isfinite(rows).all()
    with np.load(tmp_path / "fields3d.npz") as data:
        assert data["ux"].shape == (6, 8, 16)
