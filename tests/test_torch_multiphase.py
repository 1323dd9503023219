"""The Shan-Chen multiphase slice (a droplet or a liquid band in an
x-periodic channel with exact-mass y walls), against tpulbm.

* the Problem: initial state and ghost values byte-identical to tpulbm's
  for the droplet and the band, wall densities 0 (neutral) and 1.6, f32
  and f64;
* the physics pieces (ψ, the equation of state, the forced collision, the
  ψ-stencil force) on random inputs, f64 at rtol 1e-12;
* the plain step against tpulbm's make_step_multiphase, f64, 60 steps,
  rtol 1e-12, for the droplet, the band and a wetting wall;
* the kernel module through stepper.make_chunk_fn(backend="pallas"), which
  takes the plain version on CPU tensors, against tpulbm's multiphase
  Pallas kernel in interpret mode (make_chunk_fn on a (1, 1) mesh): f32,
  64x32, two chunks of 5, rtol 2e-5 / atol 1e-7, tpulbm's own
  pallas-vs-jax tolerance for this kernel (tests/test_multiphase.py);
* the physical velocity of the fields, the Runner's artifacts against
  tpulbm's Runner, resume, checkpoints both ways, the CLI, and the CUDA
  source's direction table against the lattice.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import os
import re

import jax
import numpy as np
import pytest
import torch

from tpulbm import physics as jphys
from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.ops import diagnostics as jdiag
from tpulbm.ops import step_multiphase as jmp
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state
from tpulbm.runner import Runner as JaxRunner
from tpulbm_torch import physics as tphys
from tpulbm_torch import stepper
from tpulbm_torch.convert import state_from_numpy
from tpulbm_torch.lattice import D2Q9
from tpulbm_torch.ops import diagnostics, step_cuda, step_multiphase
from tpulbm_torch.ops import step_multiphase_cuda
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import cuda_build
from test_torch_compat import port_params, port_problem

F64_TOL = dict(rtol=1e-12, atol=1e-15)
PALLAS_TOL = dict(rtol=2e-5, atol=1e-7)
# (cylinder_radius, mp_wall_rho): the droplet, the band, a wetting wall
# under a sessile droplet
SETUPS = {"droplet": dict(cylinder_radius=0.2),
          "band": dict(cylinder_radius=0.0),
          "wetting": dict(cylinder_radius=0.25, cylinder_y=0.0,
                          mp_wall_rho=1.6)}


def _params(**kw):
    d = dict(nx=64, ny=32, tau=1.0, problem="multiphase", shan_chen_g=-5.0,
             cylinder_radius=0.0, inlet_velocity=0.0, precision="f64")
    d.update(kw)
    return SimulationParams(**d)


def _noisy_state(problem, seed):
    rng = np.random.default_rng(seed)
    f = problem.initial_state() * rng.uniform(
        0.95, 1.05, (9,) + problem.spatial_shape)
    return f.astype(problem.dtype)


# ---- the Problem ------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("wall_rho", [0.0, 1.6])
@pytest.mark.parametrize("radius", [0.15, 0.0], ids=["droplet", "band"])
def test_problem_arrays_match_tpulbm_bytewise(radius, wall_rho, precision):
    params = _params(nx=48, ny=20, cylinder_radius=radius,
                     cylinder_x=0.4, cylinder_y=0.6, mp_wall_rho=wall_rho,
                     precision=precision)
    mine, ref = port_problem(params), jax_problem(params)
    assert mine.init_rho == ref.init_rho == (wall_rho or 1.0)
    assert mine.shan_chen == ref.shan_chen == (-5.0, 1.0)
    assert (mine.walls_y, mine.periodic_x, mine.solid) == \
        (ref.walls_y, ref.periodic_x, None)
    assert mine.init_rho_map.tobytes() == ref.init_rho_map.tobytes()
    for got, want in ((mine.ghost_ring_values(), ref.ghost_ring_values()),
                      (mine.initial_state(), ref.initial_state())):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


# multiphase on a mesh, refused until its ring build: the Problem builds,
# tpulbm's (tests/test_torch_mesh_multiphase.py runs it)
@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)])
def test_multiphase_mesh_builds_tpulbms_problem(mesh):
    params = _params(mesh_shape=mesh)
    mine, ref = port_problem(params), jax_problem(params)
    assert mine.params.mesh_shape == mesh
    assert mine.init_rho_map.tobytes() == ref.init_rho_map.tobytes()


def test_multiphase_needs_g_as_tpulbm_does():
    params = port_params(_params())
    with pytest.raises(ValueError, match="shan-chen-g"):
        port_problem(params.replace(shan_chen_g=0.0))


# ---- physics pieces ---------------------------------------------------

def test_psi_and_pressure_match_tpulbm():
    rho = np.random.default_rng(1).uniform(0.05, 2.5, (6, 9))
    for name, args in (("shan_chen_psi", (1.0,)),
                       ("shan_chen_pressure", (-5.0, 1.0))):
        want = np.asarray(getattr(jphys, name)(jax.numpy.asarray(rho),
                                               *args))
        got = getattr(tphys, name)(torch.from_numpy(rho), *args).numpy()
        np.testing.assert_allclose(got, want, **F64_TOL)


@pytest.mark.parametrize("zero_force", [False, True])
def test_collide_shan_chen_matches_tpulbm(zero_force):
    rng = np.random.default_rng(2)
    f = (D2Q9.w.reshape((9, 1, 1))
         * (1.0 + 0.02 * rng.standard_normal((9, 6, 8))))
    F = (np.zeros((2, 6, 8)) if zero_force
         else 1e-3 * rng.standard_normal((2, 6, 8)))
    got = tphys.collide_shan_chen(D2Q9, torch.from_numpy(f), 1.0 / 0.8,
                                  torch.from_numpy(F)).numpy()
    want = np.asarray(jphys.collide_shan_chen(
        jax_problem(_params()).lattice, jax.numpy.asarray(f), 1.0 / 0.8,
        jax.numpy.asarray(F)))
    np.testing.assert_allclose(got, want, **F64_TOL)
    if zero_force:   # no force: plain BGK
        bgk = tphys.collide(D2Q9, torch.from_numpy(f), 1.0 / 0.8).numpy()
        np.testing.assert_allclose(got, bgk, rtol=1e-14, atol=1e-16)


@pytest.mark.parametrize("wall_rho", [1.0, 1.6, 0.16])
def test_shan_chen_force_matches_tpulbm(wall_rho):
    psi = np.random.default_rng(3).uniform(0.1, 0.9, (7, 11))
    problem = port_problem(_params(mp_wall_rho=wall_rho))
    wall = step_multiphase.wall_psi(problem)
    np.testing.assert_allclose(wall, 1.0 - np.exp(-wall_rho), rtol=1e-15)
    got = step_multiphase.shan_chen_force(D2Q9, torch.from_numpy(psi), -5.0,
                                          wall).numpy()
    want = np.asarray(jmp.shan_chen_force(
        jax_problem(_params()).lattice, jax.numpy.asarray(psi), -5.0, wall))
    np.testing.assert_allclose(got, want, **F64_TOL)


# ---- the plain step and the kernel module -----------------------------

@pytest.mark.parametrize("setup", SETUPS)
def test_plain_step_matches_tpulbm_f64(setup):
    params = _params(**SETUPS[setup])
    mine, ref = port_problem(params), jax_problem(params)
    f0 = mine.initial_state()
    jstep = jax.jit(jmp.make_step_multiphase(ref))
    step = step_multiphase.make_step_multiphase(mine, "cpu")
    want, got = jax.numpy.asarray(f0), torch.from_numpy(f0)
    for _ in range(60):
        want, got = jstep(want), step(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)


def test_kernel_chunk_matches_tpulbm_pallas_interpret():
    params = _params(cylinder_radius=0.2, precision="f32")
    mine, ref = port_problem(params), jax_problem(params)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    jchunk = jax_chunk_fn(ref, mesh, 5, backend="pallas")
    f, solid = shard_state(mesh, ref.initial_state(),
                           np.zeros(ref.spatial_shape, bool))
    chunk = stepper.make_chunk_fn(mine, "cpu", 5, backend="pallas")
    assert chunk.substeps == 1
    t = state_from_numpy(mine.initial_state(), mine, "cpu")
    for _ in range(2):
        f, t = jchunk(f, solid), chunk(t)
    np.testing.assert_allclose(t.numpy(), np.asarray(jax.device_get(f)),
                               **PALLAS_TOL)


def test_multiphase_chunk_ignores_forced_depth(monkeypatch):
    # one step per launch, as tpulbm's body_multiphase_pallas:
    # TPULBM_SUBSTEPS (and the depth choice) do not apply
    monkeypatch.setenv("TPULBM_SUBSTEPS", "4")
    problem = port_problem(_params(precision="f32", nx=16, ny=8))
    launches = []
    real = step_multiphase_cuda.collide_stream_multiphase

    def counting(*args, **kw):
        launches.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(step_multiphase_cuda, "collide_stream_multiphase",
                        counting)
    chunk = stepper.make_chunk_fn(problem, "cpu", 8, backend="pallas")
    f = state_from_numpy(problem.initial_state(), problem, "cpu")
    got = chunk(f.clone())
    assert chunk.substeps == 1 and len(launches) == 8
    want = stepper.make_chunk_fn(problem, "cpu", 8, backend="jax")(f)
    assert torch.equal(got, want)


def test_fields_report_physical_velocity():
    # velocity_field.csv and the VTK frames carry u + F/(2 rho), as tpulbm
    # writes them, not the bare moments
    params = _params(cylinder_radius=0.2)
    mine, ref = port_problem(params), jax_problem(params)
    f = _noisy_state(mine, 4)
    rho, u = diagnostics.fields_fn(mine, "cpu")(torch.from_numpy(f))
    rho_p, u_p = jmp.physical_velocity(ref, jax.numpy.asarray(f))
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_p), **F64_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_p), **F64_TOL)
    _, u_jit = jax.jit(jdiag.fields_fn(ref))(f)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_jit), rtol=1e-6,
                               atol=1e-9)
    _, u_bare = tphys.moments(D2Q9, torch.from_numpy(f))
    assert float((u - u_bare).abs().max()) > 1e-6
    # max |u| keeps the bare moments, as in tpulbm
    mv = diagnostics.max_velocity_fn(mine, "cpu")(torch.from_numpy(f))
    assert float(mv) == pytest.approx(
        float(torch.sqrt((u_bare * u_bare).sum(0).max())), rel=1e-15)


def test_kernel_wrapper_on_cpu_counts_no_launch():
    problem = port_problem(_params(precision="f32", nx=16, ny=8))
    step = step_multiphase_cuda.make_local_step_multiphase_cuda(problem,
                                                                "cpu")
    step_cuda.reset_launch_counts()
    f = torch.from_numpy(problem.initial_state())
    out = step(f, torch.empty_like(f))
    assert bool(out.isfinite().all())
    assert step_multiphase_cuda.collide_stream_multiphase.launches == 0
    step_multiphase_cuda.collide_stream_multiphase.launches = 5
    step_cuda.reset_launch_counts()
    assert step_multiphase_cuda.collide_stream_multiphase.launches == 0


@pytest.mark.parametrize("bad,exc", [
    ("f64", TypeError), ("q14", ValueError), ("out_shape", ValueError),
    ("noncontig", ValueError), ("alias", ValueError), ("meta", ValueError)])
def test_kernel_wrapper_rejects_bad_inputs(bad, exc):
    f = torch.rand(9, 6, 10)
    out = torch.empty_like(f)
    if bad == "f64":
        f = f.double()
    elif bad == "q14":
        f, out = torch.rand(14, 6, 10), torch.empty(14, 6, 10)
    elif bad == "out_shape":
        out = out[:, :, :-1].clone()
    elif bad == "noncontig":
        f = torch.rand(9, 10, 6).transpose(1, 2)
    elif bad == "alias":
        out = f
    elif bad == "meta":
        f, out = f.to("meta"), out.to("meta")
    with pytest.raises(exc):
        step_multiphase_cuda.check_inputs(f, out)


def test_multiphase_kernel_refuses_f64_and_other_problems(tmp_path):
    with pytest.raises(NotImplementedError, match="float32"):
        stepper.make_chunk_fn(port_problem(_params()), "cpu", 4,
                              backend="pallas")
    with pytest.raises(NotImplementedError, match="Shan-Chen"):
        step_multiphase_cuda.make_local_step_multiphase_cuda(
            port_problem(SimulationParams(nx=40, ny=20)), "cpu")
    with pytest.raises(NotImplementedError, match="float32"):
        Runner(port_params(_params(backend="pallas",
                                   output_dir=str(tmp_path))), device="cpu")


def test_kernel_constants_are_the_plain_steps():
    problem = port_problem(_params(tau=0.7, shan_chen_g=-5.5,
                                   mp_wall_rho=1.6, precision="f32"))
    consts = step_multiphase_cuda.MultiphaseConstants.of(problem)
    inv_tau = 1.0 / 0.7
    assert consts.scalars == (inv_tau, 1.0 / inv_tau, 5.5, 1.0,
                              step_multiphase.wall_psi(problem))
    assert consts.w == tuple(float(v) for v in D2Q9.w)
    assert [float(v) for v in consts.arrays[0]] == [
        float(np.float32(v)) for v in consts.scalars]


def test_kernel_source_table_matches_lattice():
    src = (cuda_build.SOURCE_DIR / "step_multiphase.cu").read_text()
    rows = re.findall(r"^\s*X\((\d+), (-?\d), (-?\d), (\d+)\)", src,
                      flags=re.M)
    table = np.array(rows, dtype=int)
    np.testing.assert_array_equal(table[:, 0], np.arange(9))
    np.testing.assert_array_equal(table[:, 1:3], D2Q9.c)
    np.testing.assert_array_equal(table[:, 3], D2Q9.opposite)


# ---- the Runner against tpulbm's --------------------------------------

def _runner_params(tmp, **kw):
    # 200 steps every 50: the 8-interval super-chunk is too long here, so
    # the per-interval tail runs; the super path is held to it below
    d = dict(cylinder_radius=0.2, num_timesteps=200, output_frequency=50,
             output_dir=str(tmp), backend="jax", enable_vtk=False)
    d.update(kw)
    return _params(**d)


def _table(path):
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


RUNNER_CASES = {
    # plain tiers in f64: the two frameworks agree to round-off
    "f64": (dict(precision="f64", backend="jax"),
            dict(rtol=1e-9, atol=1e-12)),
    # the kernel module (its CPU path) in f32 against tpulbm's Pallas
    # kernel in interpret mode, 200 steps of a droplet: atol 1e-6 for the
    # velocities (measured here: 1.6e-7), rtol 1e-5 for rho (measured:
    # 4.9e-6 at rho ~ 2, f32 rounding amplified at the interface; tpulbm
    # holds its own f32 tiers to rtol 2e-5)
    "f32": (dict(precision="f32", backend="pallas"),
            dict(rtol=1e-5, atol=1e-6)),
}


@pytest.mark.parametrize("case", RUNNER_CASES)
def test_runner_artifacts_match_tpulbm(tmp_path, case):
    kw, tol = RUNNER_CASES[case]
    vtk = case == "f64"
    ref_p = _runner_params(tmp_path / "ref", enable_vtk=vtk, **kw)
    ref = JaxRunner(ref_p, verbose=False).run()
    got = Runner(port_params(_runner_params(tmp_path / "port",
                                            enable_vtk=vtk, **kw)),
                 device="cpu", verbose=False).run()
    assert ref.success and got.success and got.final_step == 200
    assert got.forces_path is None and got.stats is None
    for d in ("ref", "port"):
        assert not (tmp_path / d / "forces.csv").exists()
    got_t = _table(tmp_path / "port" / "velocity_field.csv")
    ref_t = _table(tmp_path / "ref" / "velocity_field.csv")
    assert got_t.shape == ref_t.shape == (64 * 32, 6)
    np.testing.assert_array_equal(got_t[:, :2], ref_t[:, :2])
    np.testing.assert_allclose(got_t, ref_t, **tol)
    rows = [_table_rows(tmp_path / d / "simulation_params.csv")
            for d in ("port", "ref")]
    assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]]
    np.testing.assert_allclose([float(r[1]) for r in rows[0]],
                               [float(r[1]) for r in rows[1]], **tol)
    if vtk:
        frames = sorted(os.listdir(tmp_path / "port" / "vtk_output"))
        assert frames == sorted(os.listdir(tmp_path / "ref" / "vtk_output"))
        assert len(frames) == 3                     # t = 50, 100, 150
        for name in frames:
            body = (tmp_path / "port" / "vtk_output" / name).read_text()
            ref_body = (tmp_path / "ref" / "vtk_output" / name).read_text()
            assert body.splitlines()[:9] == ref_body.splitlines()[:9]
            got_v, ref_v = _vtk_numbers(body), _vtk_numbers(ref_body)
            # u (3 per cell), |u| and rho: the physical velocity in both;
            # atol: a last printed digit (%.8f) may round the other way
            assert got_v.shape == ref_v.shape == (5 * 64 * 32,)
            np.testing.assert_allclose(got_v, ref_v, rtol=1e-9, atol=1.5e-8)


def _table_rows(path):
    return [ln.split(",") for ln in open(path).read().splitlines()[1:]]


def _vtk_numbers(body):
    data = body.split("VECTORS velocity double\n", 1)[1]
    return np.array([float(t) for t in data.split()
                     if re.fullmatch(r"[-+0-9.eE]+", t)])


def test_super_chunk_path_matches_interval_path(tmp_path, monkeypatch):
    # 8 intervals of 10 steps per fetch against one fetch per interval:
    # the same velocity field and VTK frames, byte for byte
    import tpulbm_torch.runner as runner_mod
    base = dict(num_timesteps=100, output_frequency=10, enable_vtk=True,
                precision="f32", backend="pallas", nx=24, ny=12)
    p = port_params(_runner_params(tmp_path / "super", **base))
    result = Runner(p, device="cpu", verbose=False).run()
    monkeypatch.setattr(runner_mod, "_SUPER_K", 10 ** 9)
    Runner(p.replace(output_dir=str(tmp_path / "plain")), device="cpu",
           verbose=False).run()
    assert result.host_fetches < 15
    frames = sorted(os.listdir(tmp_path / "super" / "vtk_output"))
    assert len(frames) == 9
    names = ["velocity_field.csv"] + [os.path.join("vtk_output", f)
                                      for f in frames]
    for name in names:
        assert (tmp_path / "super" / name).read_bytes() == \
            (tmp_path / "plain" / name).read_bytes(), name


def test_checkpoint_resume_reproduces_run(tmp_path):
    kw = dict(precision="f32", backend="pallas", nx=24, ny=12)
    straight = port_params(_runner_params(tmp_path / "full", **kw))
    Runner(straight, device="cpu", verbose=False).run()
    half = straight.replace(num_timesteps=100, checkpoint_every=1,
                            output_dir=str(tmp_path / "resumed"))
    Runner(half, device="cpu", verbose=False).run()
    assert os.listdir(tmp_path / "resumed" / "checkpoints")
    result = Runner(half.replace(num_timesteps=200), device="cpu",
                    verbose=False).run(resume=True)
    assert result.success and result.final_step == 200
    assert (tmp_path / "resumed" / "velocity_field.csv").read_bytes() == \
        (tmp_path / "full" / "velocity_field.csv").read_bytes()


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
    kw = dict(precision="f64", nx=24, ny=12)
    run(reader, _runner_params(tmp_path / "straight", **kw))
    half = _runner_params(tmp_path / "moved", num_timesteps=100,
                          checkpoint_every=1, **kw)
    run(writer, half)
    result = run(reader, half.replace(num_timesteps=200), resume=True)
    assert result.success and result.final_step == 200
    got = _table(tmp_path / "moved" / "velocity_field.csv")
    want = _table(tmp_path / "straight" / "velocity_field.csv")
    assert got.shape == want.shape == (24 * 12, 6)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_cli_multiphase_writes_artifacts(tmp_path, capsys):
    from tpulbm_torch.__main__ import main
    assert main(["--cpu", "--problem", "multiphase", "--shan-chen-g", "-5",
                 "--nx", "32", "--ny", "16", "--tau", "1.0",
                 "--inlet-velocity", "0", "--cylinder-radius", "0.25",
                 "--cylinder-x", "0.5", "--cylinder-y", "0.5",
                 "--num-timesteps", "40", "--output-frequency", "10",
                 "--no-vtk", "--output-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "multiphase LBM Parameters:" in out and "Cylinder:" not in out
    assert "Files written: velocity_field.csv, simulation_params.csv" in out
    field = _table(tmp_path / "velocity_field.csv")
    assert field.shape == (32 * 16, 6) and np.isfinite(field).all()
    # the droplet is still there: liquid inside, vapour outside
    rho = field[:, 4].reshape(16, 32)
    assert rho[8, 16] > 1.5 and rho[0, 0] < 0.5
    assert not (tmp_path / "forces.csv").exists()
    assert (tmp_path / "simulation_params.csv").exists()


def test_profile_groups_the_multiphase_kernel():
    from tpulbm_torch.utils.profile_run import _group
    name = "_ZN12_GLOBAL__N_122multiphase_step_kernelEPKfPfii16MultiphaseConsts"
    assert _group({"cat": "kernel", "name": name}) == "multiphase"
