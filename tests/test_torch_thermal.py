"""The thermal slice (D2Q9 flow + D2Q5 temperature, Boussinesq):
Rayleigh-Bénard and the side-heated cavity, against tpulbm.

* the Problem: initial state and ghost values byte-identical to tpulbm's;
* the physics pieces (thermal equilibrium, the Dirichlet wall, the
  collision) on random inputs, f64 at rtol 1e-12;
* the plain step against tpulbm's make_step_thermal, f64, 60 steps,
  rtol 1e-12;
* the kernel module through stepper.make_chunk_fn(backend="pallas"), which
  takes the plain version on CPU tensors, against tpulbm's Pallas kernel
  in interpret mode (make_chunk_fn on a (1, 1) mesh): f32, 12 steps, rtol
  2e-5 / atol 1e-6, tpulbm's own pallas-vs-jax tolerance for this kernel
  (tests/test_thermal.py, tests/test_thermal_cavity.py);
* the Runner's artifacts against tpulbm's Runner, checkpoints both ways,
  the CLI, and the CUDA source's plane table against the lattices.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import os
import re

import jax
import numpy as np
import pytest
import torch

from tpulbm import physics as jphys
from tpulbm.config import PRESETS, SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.ops import boundaries as jbc
from tpulbm.ops import step_thermal as jthermal
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state
from tpulbm.runner import Runner as JaxRunner
from tpulbm_torch import physics as tphys
from tpulbm_torch import stepper
from tpulbm_torch.config import check_collision
from tpulbm_torch.convert import state_from_numpy, state_to_numpy
from tpulbm_torch.lattice import D2Q5, D2Q9
from tpulbm_torch.ops import boundaries, step_cuda, step_thermal
from tpulbm_torch.ops import step_thermal_cuda
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import cuda_build
from test_torch_compat import port_params, port_problem

F64_TOL = dict(rtol=1e-12, atol=1e-15)
PALLAS_TOL = dict(rtol=2e-5, atol=1e-6)
PROBLEMS = ("rayleigh-benard", "heated-cavity")


def _params(problem="rayleigh-benard", **kw):
    d = dict(nx=32, ny=32, problem=problem, tau=0.55, thermal_tau=0.5704,
             rayleigh=5000.0, inlet_velocity=0.0, cylinder_radius=0.0,
             periodic_x=problem == "rayleigh-benard", precision="f64")
    d.update(kw)
    return SimulationParams(**d)


def _noisy_state(problem, seed):
    rng = np.random.default_rng(seed)
    s = problem.initial_state() * rng.uniform(
        0.95, 1.05, (problem.state_q,) + problem.spatial_shape)
    return s.astype(problem.dtype)


# ---- the Problem ------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("grid", [None, (24, 16), (33, 9)],
                         ids=["preset", "24x16", "33x9"])
@pytest.mark.parametrize("preset", PROBLEMS)
def test_problem_arrays_match_tpulbm_bytewise(preset, grid, precision):
    params = PRESETS[preset].replace(precision=precision)
    if grid is not None:
        params = params.replace(nx=grid[0], ny=grid[1])
    mine, ref = port_problem(params), jax_problem(params)
    assert mine.state_q == ref.state_q == 14
    assert (mine.walls_x, mine.walls_y, mine.periodic_x, mine.periodic_y) == \
        (ref.walls_x, ref.walls_y, ref.periodic_x, ref.periodic_y)
    th, jth = mine.thermal, ref.thermal
    assert (th.tau_g, th.t_bottom, th.t_top, th.buoyancy, th.perturb,
            th.buoyancy_axis, th.t_ref, th.alpha) == \
        (jth.tau_g, jth.t_bottom, jth.t_top, jth.buoyancy, jth.perturb,
         jth.buoyancy_axis, jth.t_ref, jth.alpha)
    for got, want in ((mine.ghost_ring_values(), ref.ghost_ring_values()),
                      (mine.initial_state(), ref.initial_state())):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    for got, want in zip(step_thermal.ghost_rows(mine),
                         jthermal._ghost_rows(ref)):
        assert got.tobytes() == want.tobytes()


# the thermal problems on a mesh, refused until their ring builds: the
# Problem builds, tpulbm's (tests/test_torch_mesh_thermal.py runs them)
@pytest.mark.parametrize("override", [
    dict(problem="passive-scalar", mesh_shape=(2, 1)),
    dict(mesh_shape=(2, 1))], ids=["passive-scalar", "thermal-mesh"])
def test_thermal_mesh_options_build_tpulbms_problem(override):
    params = _params(**override)
    mine, ref = port_problem(params), jax_problem(params)
    assert mine.params.mesh_shape == (2, 1)
    assert (mine.walls_y, mine.periodic_x, mine.periodic_y, mine.state_q) \
        == (ref.walls_y, ref.periodic_x, ref.periodic_y, ref.state_q)


# the LES closure of the thermal step, once refused: the Problem carries
# tpulbm's field; the other operators stay refused, as tpulbm refuses them
@pytest.mark.parametrize("problem", PROBLEMS)
def test_thermal_les_fields_match_tpulbm(problem):
    params = _params(problem, smagorinsky=0.17)
    mine, ref = port_problem(params), jax_problem(params)
    assert (mine.collision, mine.smagorinsky, mine.power_law) == \
        (ref.collision, ref.smagorinsky, ref.power_law) == ("bgk", 0.17, ())
    assert mine.initial_state().tobytes() == ref.initial_state().tobytes()
    for bad in (dict(collision="trt"), dict(power_law_n=0.7)):
        with pytest.raises(ValueError, match="thermal"):
            port_problem(_params(problem, **bad))


def test_rayleigh_benard_in_3d_raises_tpulbm_error():
    with pytest.raises(ValueError, match="2-D"):
        port_problem(_params(nz=8))


# ---- physics pieces ---------------------------------------------------

def test_thermal_equilibrium_matches_tpulbm():
    rng = np.random.default_rng(1)
    T = rng.uniform(0.0, 1.0, (6, 9))
    u = rng.normal(0.0, 0.05, (2, 6, 9))
    want = np.asarray(jphys.thermal_equilibrium(jax_problem(
        _params()).thermal.lattice, jax.numpy.asarray(T),
        jax.numpy.asarray(u)))
    got = tphys.thermal_equilibrium(D2Q5, torch.from_numpy(T),
                                    torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, **F64_TOL)


@pytest.mark.parametrize("wall", ["bottom", "top"])
def test_thermal_wall_matches_tpulbm(wall):
    rng = np.random.default_rng(2)
    g = rng.uniform(0.0, 0.4, (5, 6, 9))
    yy = np.arange(6)[:, None]
    mask, sign, t_wall = ((yy == 0, +1, 1.25) if wall == "bottom"
                          else (yy == 5, -1, -0.5))
    want = [jax.numpy.asarray(p) for p in g]
    jbc.apply_thermal_wall(jax_problem(_params()).thermal.lattice, want,
                           jax.numpy.asarray(mask), 1, sign, t_wall, None)
    got = [torch.from_numpy(p) for p in g]
    boundaries.apply_thermal_wall(D2Q5, got, torch.from_numpy(mask), 1, sign,
                                  t_wall, None)
    np.testing.assert_allclose(np.stack([p.numpy() for p in got]),
                               np.stack([np.asarray(p) for p in want]),
                               **F64_TOL)


@pytest.mark.parametrize("problem", PROBLEMS)
def test_collide_thermal_matches_tpulbm(problem):
    params = _params(problem, nx=20, ny=12)
    mine, ref = port_problem(params), jax_problem(params)
    s = _noisy_state(mine, 3)
    want = np.asarray(jthermal.collide_thermal(ref, jax.numpy.asarray(s)))
    got = step_thermal.collide_thermal(mine, torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, **F64_TOL)


# ---- the plain step and the kernel module -----------------------------

@pytest.mark.parametrize("problem,nx,ny", [
    ("rayleigh-benard", 32, 32), ("heated-cavity", 32, 32),
    ("heated-cavity", 40, 24)])
def test_plain_step_matches_tpulbm_f64(problem, nx, ny):
    params = _params(problem, nx=nx, ny=ny)
    mine, ref = port_problem(params), jax_problem(params)
    s0 = _noisy_state(mine, nx + ny)
    jstep = jax.jit(jthermal.make_step_thermal(ref))
    step = step_thermal.make_step_thermal(mine, "cpu")
    want, got = jax.numpy.asarray(s0), torch.from_numpy(s0)
    for _ in range(60):
        want, got = jstep(want), step(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)


@pytest.mark.parametrize("problem", PROBLEMS)
def test_kernel_chunk_matches_tpulbm_pallas_interpret(problem):
    params = _params(problem, precision="f32")
    mine, ref = port_problem(params), jax_problem(params)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    jchunk = jax_chunk_fn(ref, mesh, 6, backend="pallas")
    s, solid = shard_state(mesh, ref.initial_state(),
                           np.zeros(ref.spatial_shape, bool))
    chunk = stepper.make_chunk_fn(mine, "cpu", 6, backend="pallas")
    assert chunk.substeps == 1
    t = state_from_numpy(mine.initial_state(), mine, "cpu")
    for _ in range(2):
        s, t = jchunk(s, solid), chunk(t)
    np.testing.assert_allclose(t.numpy(), np.asarray(jax.device_get(s)),
                               **PALLAS_TOL)


# ---- the Smagorinsky closure of the thermal step ----------------------

@pytest.mark.parametrize("problem,nx,ny", [
    ("rayleigh-benard", 32, 32), ("heated-cavity", 40, 24)])
def test_les_plain_step_matches_tpulbm_f64(problem, nx, ny):
    # Cs 0.17 at tau 0.55: the closure's per-cell rate, then the buoyancy
    # source (tpulbm/ops/step_thermal.py:52-56), 60 steps
    params = _params(problem, nx=nx, ny=ny, smagorinsky=0.17)
    mine, ref = port_problem(params), jax_problem(params)
    s0 = _noisy_state(mine, nx * ny)
    np.testing.assert_allclose(
        step_thermal.collide_thermal(mine, torch.from_numpy(s0)).numpy(),
        np.asarray(jthermal.collide_thermal(ref, jax.numpy.asarray(s0))),
        **F64_TOL)
    jstep = jax.jit(jthermal.make_step_thermal(ref))
    step = step_thermal.make_step_thermal(mine, "cpu")
    want, got = jax.numpy.asarray(s0), torch.from_numpy(s0)
    for _ in range(60):
        want, got = jstep(want), step(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)
    # the closure moves the result: BGK's step is not the LES step
    bgk = step_thermal.make_step_thermal(port_problem(_params(
        problem, nx=nx, ny=ny)), "cpu")(torch.from_numpy(s0))
    assert not torch.allclose(bgk, step(torch.from_numpy(s0)), rtol=1e-9,
                              atol=0.0)


@pytest.mark.parametrize("problem", PROBLEMS)
def test_les_kernel_chunk_matches_tpulbm_pallas_interpret(problem):
    # tpulbm's own LES gate of the thermal kernel (tests/test_thermal.py,
    # the `les` case: 32x32, Ra 5000, Cs 0.17, 12 steps, rtol 2e-5 / atol
    # 1e-6), the kernel module against the Pallas kernel
    params = _params(problem, precision="f32", smagorinsky=0.17)
    mine, ref = port_problem(params), jax_problem(params)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    jchunk = jax_chunk_fn(ref, mesh, 6, backend="pallas")
    s, solid = shard_state(mesh, ref.initial_state(),
                           np.zeros(ref.spatial_shape, bool))
    chunk = stepper.make_chunk_fn(mine, "cpu", 6, backend="pallas")
    assert chunk.plan == [(1, 6)]     # one step per launch, as under BGK
    t = state_from_numpy(mine.initial_state(), mine, "cpu")
    for _ in range(2):
        s, t = jchunk(s, solid), chunk(t)
    np.testing.assert_allclose(t.numpy(), np.asarray(jax.device_get(s)),
                               **PALLAS_TOL)


def test_les_kernel_constants_and_library_mode():
    les = port_problem(_params(precision="f32", smagorinsky=0.17))
    consts = step_thermal_cuda.ThermalConstants.of(les)
    tau0 = 1.0 / (1.0 / 0.55)
    assert consts.mode == "smagorinsky"
    assert consts.scalars[4:] == (tau0, tau0 * tau0, 18.0 * 0.17 * 0.17)
    bgk = step_thermal_cuda.ThermalConstants.of(port_problem(_params(
        precision="f32")))
    assert bgk.mode == "bgk" and bgk.scalars[4:] == (0.0, 0.0, 0.0)
    assert bgk.scalars[:4] == consts.scalars[:4]
    assert step_thermal_cuda.MODES == ("bgk", "smagorinsky")
    assert step_cuda.mode_defines("smagorinsky") == ("-DTPULBM_COLLISION=5",)
    src = (cuda_build.SOURCE_DIR / "step_thermal.cu").read_text()
    assert "tpulbm::kMode == tpulbm::kSmagorinsky" in src
    # on the CPU the wrapper runs the plain LES step and counts no launch
    step_cuda.reset_launch_counts()
    step = step_thermal_cuda.make_local_step_thermal_cuda(les, "cpu")
    s = torch.from_numpy(les.initial_state())
    assert torch.equal(step(s, torch.empty_like(s)),
                       step_thermal.make_step_thermal(les, "cpu")(s))
    assert step_cuda.launches_by_mode(
        step_thermal_cuda.collide_stream_thermal) == {"bgk": 0,
                                                      "smagorinsky": 0}
    # the other collisions are refused before a Problem is built, by the
    # check that validate_params shares
    with pytest.raises(ValueError, match="thermal"):
        check_collision(les.params.replace(collision="trt"))


def test_thermal_chunk_ignores_forced_depth(monkeypatch):
    # one step per launch, as tpulbm's body_thermal_pallas: TPULBM_SUBSTEPS
    # (and the depth choice) do not apply to thermal problems
    monkeypatch.setenv("TPULBM_SUBSTEPS", "4")
    problem = port_problem(_params(precision="f32", nx=16, ny=8))
    launches = []
    real = step_thermal_cuda.collide_stream_thermal

    def counting(*args, **kw):
        launches.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(step_thermal_cuda, "collide_stream_thermal", counting)
    chunk = stepper.make_chunk_fn(problem, "cpu", 8, backend="pallas")
    s = state_from_numpy(problem.initial_state(), problem, "cpu")
    got = chunk(s.clone())
    assert chunk.substeps == 1 and len(launches) == 8
    want = stepper.make_chunk_fn(problem, "cpu", 8, backend="jax")(s)
    assert torch.equal(got, want)


def test_kernel_wrapper_on_cpu_counts_no_launch():
    problem = port_problem(_params(precision="f32", nx=16, ny=8))
    step = step_thermal_cuda.make_local_step_thermal_cuda(problem, "cpu")
    step_cuda.reset_launch_counts()
    s = torch.from_numpy(problem.initial_state())
    out = step(s, torch.empty_like(s))
    assert bool(out.isfinite().all())
    wrapper = step_thermal_cuda.collide_stream_thermal
    assert step_cuda.launches(wrapper) == 0
    step_cuda._count(wrapper, "smagorinsky")
    assert step_cuda.launches_by_mode(wrapper) == {"bgk": 0,
                                                   "smagorinsky": 1}
    step_cuda.reset_launch_counts()
    assert step_cuda.launches(wrapper) == 0


@pytest.mark.parametrize("bad,exc", [
    ("f64", TypeError), ("q9", ValueError), ("out_shape", ValueError),
    ("noncontig", ValueError), ("alias", ValueError), ("meta", ValueError)])
def test_kernel_wrapper_rejects_bad_inputs(bad, exc):
    s = torch.rand(14, 6, 10)
    out = torch.empty_like(s)
    if bad == "f64":
        s = s.double()
    elif bad == "q9":
        s, out = s[:9].clone(), out[:9].clone()
    elif bad == "out_shape":
        out = out[:, :, :-1].clone()
    elif bad == "noncontig":
        s = torch.rand(14, 10, 6).transpose(1, 2)
    elif bad == "alias":
        out = s
    elif bad == "meta":
        s, out = s.to("meta"), out.to("meta")
    with pytest.raises(exc):
        step_thermal_cuda.check_inputs(s, out)


def test_thermal_kernel_refuses_f64_and_other_problems():
    with pytest.raises(NotImplementedError, match="float32"):
        stepper.make_chunk_fn(port_problem(_params()), "cpu", 4,
                              backend="pallas")
    with pytest.raises(NotImplementedError, match="thermal"):
        step_thermal_cuda.make_local_step_thermal_cuda(
            port_problem(SimulationParams(nx=40, ny=20)), "cpu")
    with pytest.raises(NotImplementedError, match="float32"):
        Runner(port_params(_params(backend="pallas")), device="cpu")


def test_kernel_source_table_matches_lattices():
    # the .cu's X-macro plane table: planes 0-8 are D2Q9, 9-13 are D2Q5
    src = (cuda_build.SOURCE_DIR / "step_thermal.cu").read_text()
    rows = re.findall(r"^\s*X\((\d+), (-?\d), (-?\d), (\d+)\)", src,
                      flags=re.M)
    table = np.array(rows, dtype=int)
    assert len(table) == 14
    np.testing.assert_array_equal(table[:, 0], np.arange(14))
    np.testing.assert_array_equal(table[:9, 1:3], D2Q9.c)
    np.testing.assert_array_equal(table[9:, 1:3], D2Q5.c)
    np.testing.assert_array_equal(table[:9, 3], D2Q9.opposite)
    np.testing.assert_array_equal(table[9:, 3], 9 + D2Q5.opposite)


def test_state_round_trip_thermal():
    problem = port_problem(_params(precision="f32", nx=16, ny=8))
    s = _noisy_state(problem, 4)
    t = state_from_numpy(s, problem, "cpu")
    assert t.shape == (14, 8, 16)
    assert state_to_numpy(t).tobytes() == s.tobytes()
    with pytest.raises(ValueError):
        state_from_numpy(s[:9], problem, "cpu")
    with pytest.raises(ValueError):
        state_to_numpy(t[:, 0])


# ---- the Runner against tpulbm's --------------------------------------

def _runner_params(tmp, problem, **kw):
    # Ra 3000 on 32x32, 400 steps every 100: the 8-interval super-chunk is
    # too long here, so the per-interval tail runs; the super path is held
    # to it below
    d = dict(rayleigh=3000.0, num_timesteps=400, output_frequency=100,
             output_dir=str(tmp), backend="jax", enable_vtk=False)
    d.update(kw)
    return _params(problem, **d)


def _table(path):
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


RUNNER_CASES = {
    # plain tiers in f64: the two frameworks agree to round-off
    "f64": (dict(precision="f64", backend="jax"),
            dict(rtol=1e-9, atol=1e-12), dict(rtol=1e-9, atol=1e-12)),
    # the kernel module (its CPU path) in f32 against tpulbm's Pallas
    # kernel in interpret mode: fields at tests/test_torch_runner.py's
    # drift tolerance (measured here: 1.9e-6 in T, 1.7e-6 in u after 400
    # steps; tpulbm's own f32 jax tier is 1.8e-5 from its Pallas tier in
    # T). Nu = 1 + <u_y T> H / (alpha dT) multiplies the f32 rounding of
    # the mean by H / (alpha dT) = 1.4e3: the port is 2.6e-5 from tpulbm's
    # Pallas tier, and tpulbm's f32 jax tier 1.2e-4 from its f64 run, so
    # Nu is held at atol 1e-4.
    "f32": (dict(precision="f32", backend="pallas"),
            dict(rtol=1e-5, atol=5e-6), dict(rtol=0.0, atol=1e-4)),
    # the same under the Smagorinsky closure, Cs 0.17
    "les_f32": (dict(precision="f32", backend="pallas", smagorinsky=0.17),
                dict(rtol=1e-5, atol=5e-6), dict(rtol=0.0, atol=1e-4)),
}


@pytest.mark.parametrize("case", RUNNER_CASES)
@pytest.mark.parametrize("problem", PROBLEMS)
def test_runner_artifacts_match_tpulbm(tmp_path, problem, case):
    kw, tol, nu_tol = RUNNER_CASES[case]
    vtk = case == "f64"
    ref_p = _runner_params(tmp_path / "ref", problem, enable_vtk=vtk, **kw)
    ref = JaxRunner(ref_p, verbose=False).run()
    got = Runner(port_params(_runner_params(tmp_path / "port", problem,
                                            enable_vtk=vtk, **kw)),
                 device="cpu", verbose=False).run()
    assert ref.success and got.success and got.final_step == 400
    assert got.forces_path is None
    for d in ("ref", "port"):
        assert not (tmp_path / d / "forces.csv").exists()
    nu_got = _table(tmp_path / "port" / "nusselt.csv")
    nu_ref = _table(tmp_path / "ref" / "nusselt.csv")
    assert list(nu_got[:, 0]) == list(nu_ref[:, 0]) == [0, 100, 200, 300]
    np.testing.assert_allclose(nu_got, nu_ref, **nu_tol)
    for name in ("velocity_field.csv", "temperature_field.csv"):
        got_t = _table(tmp_path / "port" / name)
        ref_t = _table(tmp_path / "ref" / name)
        assert got_t.shape == ref_t.shape == (32 * 32, got_t.shape[1])
        np.testing.assert_array_equal(got_t[:, :2], ref_t[:, :2])
        np.testing.assert_allclose(got_t, ref_t, err_msg=name, **tol)
    rows = [_table_rows(tmp_path / d / "simulation_params.csv")
            for d in ("port", "ref")]
    assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]]
    np.testing.assert_allclose([float(r[1]) for r in rows[0]],
                               [float(r[1]) for r in rows[1]], **tol)
    np.testing.assert_allclose(got.stats["nusselt"], ref.stats["nusselt"],
                               **nu_tol)
    assert set(got.stats) == {"nusselt"}
    if vtk:
        frames = sorted(os.listdir(tmp_path / "port" / "vtk_output"))
        assert frames == sorted(os.listdir(tmp_path / "ref" / "vtk_output"))
        assert len(frames) == 3                     # t = 100, 200, 300
        for name in frames:
            body = (tmp_path / "port" / "vtk_output" / name).read_text()
            assert body.count("SCALARS temperature double") == 1
            ref_body = (tmp_path / "ref" / "vtk_output" / name).read_text()
            assert body.splitlines()[:9] == ref_body.splitlines()[:9]
            _, got_v = body.split("SCALARS temperature double\n")
            _, ref_v = ref_body.split("SCALARS temperature double\n")
            np.testing.assert_allclose(
                np.array(got_v.split()[2:], float),
                np.array(ref_v.split()[2:], float), rtol=1e-9, atol=1.5e-8)


def _table_rows(path):
    return [ln.split(",") for ln in open(path).read().splitlines()[1:]]


def test_vtk_frame_bytes_match_tpulbm(tmp_path):
    # one frame from the same f64 state written by both Runners: the
    # fields and temperature go through the same writer, byte for byte
    params = _params("heated-cavity", nx=16, ny=12, num_timesteps=2,
                     output_frequency=1, backend="jax", enable_vtk=True)
    for d, cls in (("ref", JaxRunner), ("port", Runner)):
        p = params.replace(output_dir=str(tmp_path / d))
        if cls is Runner:
            Runner(port_params(p), device="cpu", verbose=False).run()
        else:
            cls(p, verbose=False).run()
    a = (tmp_path / "port" / "vtk_output" / "lbm_000001.vtk").read_bytes()
    b = (tmp_path / "ref" / "vtk_output" / "lbm_000001.vtk").read_bytes()
    assert b"SCALARS temperature double" in a
    assert a == b


@pytest.mark.parametrize("problem", PROBLEMS)
def test_super_chunk_path_matches_interval_path(tmp_path, monkeypatch,
                                                problem):
    # 8 intervals of 10 steps per fetch against one fetch per interval:
    # the same nusselt.csv, temperature field and VTK frames, byte for byte
    import tpulbm_torch.runner as runner_mod
    base = dict(num_timesteps=100, output_frequency=10, enable_vtk=True,
                precision="f32", backend="pallas", nx=16, ny=12)
    p = port_params(_runner_params(tmp_path / "super", problem, **base))
    result = Runner(p, device="cpu", verbose=False).run()
    monkeypatch.setattr(runner_mod, "_SUPER_K", 10 ** 9)
    Runner(p.replace(output_dir=str(tmp_path / "plain")), device="cpu",
           verbose=False).run()
    # the super path ran: 1 window fetch instead of 8 interval fetches
    assert result.host_fetches < 15
    names = ["nusselt.csv", "temperature_field.csv", "velocity_field.csv"]
    frames = sorted(os.listdir(tmp_path / "super" / "vtk_output"))
    assert len(frames) == 9
    names += [os.path.join("vtk_output", f) for f in frames]
    for name in names:
        assert (tmp_path / "super" / name).read_bytes() == \
            (tmp_path / "plain" / name).read_bytes(), name


@pytest.mark.parametrize("problem", PROBLEMS)
def test_checkpoint_resume_reproduces_run(tmp_path, problem):
    kw = dict(precision="f32", backend="pallas", nx=16, ny=12)
    straight = port_params(_runner_params(tmp_path / "full", problem, **kw))
    Runner(straight, device="cpu", verbose=False).run()
    half = straight.replace(num_timesteps=200, checkpoint_every=1,
                            output_dir=str(tmp_path / "resumed"))
    Runner(half, device="cpu", verbose=False).run()
    assert os.listdir(tmp_path / "resumed" / "checkpoints")
    result = Runner(half.replace(num_timesteps=400), device="cpu",
                    verbose=False).run(resume=True)
    assert result.success and result.final_step == 400
    for name in ("nusselt.csv", "temperature_field.csv",
                 "velocity_field.csv"):
        assert (tmp_path / "resumed" / name).read_bytes() == \
            (tmp_path / "full" / name).read_bytes(), name


@pytest.mark.parametrize("direction", ["port_to_tpulbm", "tpulbm_to_port"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, direction):
    # f64 plain tiers: the moved run agrees with the reader's straight run
    # at round-off
    def run(which, params, **kw):
        if which == "port":
            return Runner(port_params(params), device="cpu",
                          verbose=False).run(**kw)
        return JaxRunner(params, verbose=False).run(**kw)

    writer, reader = (("port", "tpulbm") if direction == "port_to_tpulbm"
                      else ("tpulbm", "port"))
    kw = dict(precision="f64", nx=16, ny=12)
    run(reader, _runner_params(tmp_path / "straight", "rayleigh-benard",
                               **kw))
    half = _runner_params(tmp_path / "moved", "rayleigh-benard",
                          num_timesteps=200, checkpoint_every=1, **kw)
    run(writer, half)
    result = run(reader, half.replace(num_timesteps=400), resume=True)
    assert result.success and result.final_step == 400
    for name in ("nusselt.csv", "temperature_field.csv"):
        got = _table(tmp_path / "moved" / name)
        want = _table(tmp_path / "straight" / name)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12,
                                   err_msg=name)


def test_profile_breakdown_of_a_trace(tmp_path):
    # a synthetic chrome trace: the initial copy before the loop, two
    # thermal launches with a diagnostics kernel overlapping the first,
    # the final fetch after it, and a host event that must not count
    import json
    from tpulbm_torch.utils.profile_run import device_breakdown
    events = [("gpu_memcpy", "Memcpy HtoD", -100, 20),
              ("kernel", "_ZN12_GLOBAL__N_119thermal_step_kernelEPKf", 0, 50),
              ("kernel", "void at::native::reduce_kernel<512, 1>", 40, 20),
              ("kernel", "_ZN12_GLOBAL__N_119thermal_step_kernelEPKf", 100,
               50),
              ("gpu_memset", "Memset (Device)", 120, 5),
              ("gpu_memcpy", "Memcpy DtoH", 300, 10),
              ("cpu_op", "aten::add", 0, 500)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": ts, "dur": d}
        for c, n, ts, d in events]}))
    out = device_breakdown(str(path))
    assert out["groups"] == {
        "copies": {"ms": 0.03, "count": 2},
        "thermal": {"ms": 0.1, "count": 2},
        "other kernels": {"ms": 0.02, "count": 1},
        "sets": {"ms": 0.005, "count": 1}}
    # busy: 20 + 60 (union of 0-50 and 40-60) + 50 + 10 of a 410 window;
    # the loop runs from the first thermal launch to the end of the last
    assert out["window"]["ms"] == pytest.approx(0.41)
    assert out["window"]["idle_ms"] == pytest.approx(0.27)
    assert out["loop"]["ms"] == pytest.approx(0.15)
    assert out["loop"]["idle_ms"] == pytest.approx(0.04)
    assert out["loop"]["idle_share"] == pytest.approx(0.04 / 0.15)


def test_profile_run_needs_a_card(capsys):
    from tpulbm_torch.utils.profile_run import main
    assert main(["--preset", "heated-cavity", "--nx", "8", "--ny", "8"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_heated_cavity_writes_thermal_artifacts(tmp_path, capsys):
    from tpulbm_torch.__main__ import main
    assert main(["--cpu", "--preset", "heated-cavity", "--nx", "24",
                 "--ny", "24", "--num-timesteps", "40",
                 "--output-frequency", "10", "--output-dir",
                 str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "heated-cavity LBM Parameters:" in out
    assert "Nusselt number = " in out and "Cylinder:" not in out
    nu = _table(tmp_path / "nusselt.csv")
    assert list(nu[:, 0]) == [0, 10, 20, 30]
    assert np.isfinite(nu).all()
    temp = _table(tmp_path / "temperature_field.csv")
    assert temp.shape == (24 * 24, 3) and np.isfinite(temp).all()
    assert (tmp_path / "velocity_field.csv").exists()
    assert not (tmp_path / "forces.csv").exists()
