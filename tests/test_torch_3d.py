"""The port's D3Q19 sphere-in-duct slice against tpulbm's, on the CPU.

Grids: tpulbm's own 3-D test grid (32x16x8, tests/test_3d.py), a ragged
33x17x9 grid with a sphere of radius 2, a 32x32x8 sphere that pierces the
inlet plane (tests/test_3d.py:260-261) and one that reaches the outlet
plane and its neighbour, where the zero-gradient outlet copies from solid
cells. Inputs are tpulbm's initial states or NumPy noise from a seed.

* Problem arrays byte for byte; physics, boundaries, forces and
  diagnostics against tpulbm in f64 at rtol 1e-12 (same operations in the
  same order);
* the plain step against tpulbm's make_step_rolled, 60 steps in f64 at
  rtol 1e-12;
* the kernel module (ops/step_cuda.py, whose CPU path is the plain step)
  through the port's chunk stepper against tpulbm's two 3-D Pallas
  kernels at depth 1 in interpret mode, 8 f32 steps at rtol 5e-6 / atol
  1e-7 (tests/test_3d.py:107; the Pallas kernels multiply by 1/rho where
  the plain step divides): the full-plane kernel with TPULBM_NO_FUSED2,
  the y-tiled kernel with TPULBM_FORCE_TILED as well;
* the Runner's artifacts against tpulbm's Runner (forces rtol 1e-4 / atol
  5e-6, fields rtol 1e-5 / atol 5e-6: tests/test_torch_runner.py's gates
  and their reason), through the super-chunk path and the tail;
* checkpoints both ways between the packages; the stepper's plan and the
  guards of the 3-D slice (tpulbm's blocked cascade:
  tests/test_torch_3d_blocking.py).
"""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulbm.ops.step_pallas3d as jax_pallas3d
from tpulbm import physics as jphys
from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.ops import boundaries as jbc
from tpulbm.ops import diagnostics as jdiag
from tpulbm.ops import forces as jforces
from tpulbm.ops.step_jax import _coords as jax_coords
from tpulbm.ops.step_jax import make_step_rolled as jax_step_rolled
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state
from tpulbm.runner import Runner as JaxRunner
from tpulbm_torch import physics as tphys
from tpulbm_torch import stepper
from tpulbm_torch.convert import state_from_numpy, state_to_numpy
from tpulbm_torch.lattice import D3Q19
from tpulbm_torch.ops import boundaries, diagnostics, forces, step_cuda
from tpulbm_torch.ops.step_torch import coords, make_step_rolled
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import cuda_build
from test_torch_compat import port_params, port_problem

F64_TOL = dict(rtol=1e-12, atol=0.0)
F32_TOL = dict(rtol=5e-6, atol=1e-7)
GEOMETRIES = {
    "sphere": dict(),
    "ragged": dict(nx=33, ny=17, nz=9, cylinder_x=0.5, cylinder_radius=0.15),
    "inlet_piercing": dict(ny=32, cylinder_y=0.5, cylinder_radius=0.2),
    "outlet_reaching": dict(ny=32, cylinder_x=0.9, cylinder_y=0.5,
                            cylinder_radius=0.2),
}


def _params(geometry="sphere", **kw):
    d = dict(nx=32, ny=16, nz=8, problem="cylinder3d", tau=0.6,
             inlet_velocity=0.05, precision="f64")
    d.update(GEOMETRIES[geometry])
    d.update(kw)
    return SimulationParams(**d)


def _noisy_state(problem, seed):
    rng = np.random.default_rng(seed)
    f = problem.initial_state() * rng.uniform(
        0.8, 1.2, (problem.lattice.Q,) + problem.spatial_shape)
    return f.astype(problem.dtype)


def test_geometries_touch_what_they_claim():
    s = {g: port_problem(_params(g)).solid for g in GEOMETRIES}
    assert s["sphere"].shape == (8, 16, 32) and s["sphere"].sum() == 1
    assert s["ragged"].shape == (9, 17, 33) and s["ragged"].sum() > 1
    assert s["inlet_piercing"][..., 0].any()
    assert not s["inlet_piercing"][..., -2:].any()
    assert s["outlet_reaching"][..., -1].any()
    assert s["outlet_reaching"][..., -2].any()


def test_velocity_table_in_the_kernel_source_is_d3q19():
    # the table lives in the header both D3Q19 kernels include
    for kernel in ("step_d3q19.cu", "step_d3q19_blocked.cu"):
        assert '#include "d3q19_common.cuh"' in \
            (cuda_build.SOURCE_DIR / kernel).read_text()
    # the TPULBM_D3Q19 block (D3Q27's rows follow in TPULBM_D3Q27)
    src = (cuda_build.SOURCE_DIR / "d3q19_common.cuh").read_text()
    src = src.split("#define TPULBM_D3Q19(X)", 1)[1].split("\n\n", 1)[0]
    rows = re.findall(r"^\s*X\((\d+), (-?\d), (-?\d), (-?\d), (\d+)\)", src,
                      flags=re.M)
    table = np.array(rows, dtype=int)
    assert len(table) == D3Q19.Q
    np.testing.assert_array_equal(table[:, 0], np.arange(D3Q19.Q))
    np.testing.assert_array_equal(table[:, 1:4], D3Q19.c)
    np.testing.assert_array_equal(table[:, 4], D3Q19.opposite)


# ---- models, physics, boundaries ---------------------------------------

@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_problem_arrays_match_tpulbm_bytewise(geometry, precision):
    params = _params(geometry, precision=precision)
    mine, ref = port_problem(params), jax_problem(params)
    # the port's own copy of the lattice, equal to tpulbm's
    lat = (mine.lattice.name, mine.lattice.velocities, mine.lattice.weights)
    assert lat == (ref.lattice.name, ref.lattice.velocities,
                   ref.lattice.weights)
    assert (mine.walls_y, mine.walls_z, mine.inlet_equilibrium,
            mine.outlet_zero_grad, mine.init_u) == \
        (ref.walls_y, ref.walls_z, ref.inlet_equilibrium,
         ref.outlet_zero_grad, ref.init_u)
    for got, want in ((mine.solid, ref.solid),
                      (mine.ghost_ring_values(), ref.ghost_ring_values()),
                      (mine.initial_state(), ref.initial_state())):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_physics_matches_tpulbm(dtype):
    tol = F64_TOL if dtype == np.float64 else F32_TOL
    problem = port_problem(_params("ragged"))
    f = _noisy_state(problem, 3).astype(dtype)
    ft, fj = torch.from_numpy(f), jnp.asarray(f)
    rho_t, u_t = tphys.moments(D3Q19, ft)
    rho_j, u_j = jphys.moments(D3Q19, fj)
    assert tuple(u_t.shape) == (3,) + problem.spatial_shape
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j), **tol)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), **tol)
    np.testing.assert_allclose(tphys.equilibrium(D3Q19, rho_t, u_t).numpy(),
                               np.asarray(jphys.equilibrium(D3Q19, rho_j,
                                                            u_j)), **tol)
    np.testing.assert_allclose(tphys.collide(D3Q19, ft, 1 / 0.6).numpy(),
                               np.asarray(jphys.collide(D3Q19, fj, 1 / 0.6)),
                               **tol)
    solid = problem.solid
    np.testing.assert_allclose(
        float(tphys.max_velocity(D3Q19, ft, torch.from_numpy(solid))),
        float(jphys.max_velocity(D3Q19, fj, jnp.asarray(solid))), **tol)
    assert bool(tphys.is_stable(ft))
    f[7, 1, 2, 3] = np.inf
    assert not bool(tphys.is_stable(torch.from_numpy(f)))


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_boundary_stack_matches_tpulbm(geometry):
    # seeded random planes through the whole stack (y walls, z walls,
    # equilibrium inlet, zero-gradient outlet, obstacle pin), f64
    params = _params(geometry)
    problem, jproblem = port_problem(params), jax_problem(params)
    f = _noisy_state(problem, 11)
    got = boundaries.apply_all(problem, list(torch.from_numpy(f)),
                               coords(problem, "cpu"))
    jc = jax_coords(jproblem)
    jc["solid"] = jnp.asarray(jproblem.solid)
    want = jbc.apply_all(jproblem, list(jnp.asarray(f)), jc)
    np.testing.assert_allclose(torch.stack(got).numpy(),
                               np.asarray(jnp.stack(want)), **F64_TOL)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_plain_step_matches_jax_rolled_f64(geometry):
    params = _params(geometry)
    jstep = jax.jit(jax_step_rolled(jax_problem(params)))
    problem = port_problem(params)
    tstep = make_step_rolled(problem, "cpu")
    fj = problem.initial_state()
    ft = state_from_numpy(fj, problem, "cpu")
    for _ in range(60):
        fj = jstep(fj)
        ft = tstep(ft)
    np.testing.assert_allclose(state_to_numpy(ft), np.asarray(fj), **F64_TOL)


# ---- the kernel module against tpulbm's 3-D Pallas kernels ------------

PALLAS_3D = {
    "full_plane": {"TPULBM_NO_FUSED2": "1"},
    "tiled": {"TPULBM_NO_FUSED2": "1", "TPULBM_FORCE_TILED": "1"},
}


def _pallas3d_chunks(monkeypatch, params, kernel, chunk_len=4, n_chunks=2):
    """tpulbm's make_chunk_fn(backend="pallas") on a (1,1) mesh with the
    env of `kernel`; asserts that the 3-D kernel it names ran at depth 1."""
    for k, v in PALLAS_3D[kernel].items():
        monkeypatch.setenv(k, v)
    built = []
    for name in ("make_local_step_pallas3d", "make_local_step_pallas3d_tiled"):
        real = getattr(jax_pallas3d, name)

        def spy(problem, shape, *args, _real=real, _name=name, **kw):
            st = _real(problem, shape, *args, **kw)
            depth = args[0] if args else kw.get("n_sub", 1)
            built.append((_name, depth, st is not None))
            return st

        monkeypatch.setattr(jax_pallas3d, name, spy)
    problem = jax_problem(params)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    chunk = jax_chunk_fn(problem, mesh, chunk_len, backend="pallas")
    want = ("make_local_step_pallas3d" if kernel == "full_plane"
            else "make_local_step_pallas3d_tiled", 1, True)
    assert built[-1] == want, built
    f, solid = shard_state(mesh, problem.initial_state(), problem.solid)
    out = []
    for _ in range(n_chunks):
        f = chunk(f, solid)
        out.append(np.asarray(jax.device_get(f)))
    return out


def _port_chunks(params, chunk_len=4, n_chunks=2):
    problem = port_problem(params)
    chunk = stepper.make_chunk_fn(problem, "cpu", chunk_len)
    assert chunk.substeps == 1
    f = state_from_numpy(problem.initial_state(), problem, "cpu")
    out = []
    for _ in range(n_chunks):
        f = chunk(f)
        out.append(state_to_numpy(f).copy())
    return out


@pytest.mark.parametrize("geometry,kernel", [
    ("sphere", "full_plane"), ("sphere", "tiled"), ("ragged", "full_plane"),
    ("inlet_piercing", "tiled"), ("outlet_reaching", "tiled")])
def test_kernel_module_matches_pallas3d(monkeypatch, geometry, kernel):
    params = _params(geometry, precision="f32")
    ref = _pallas3d_chunks(monkeypatch, params, kernel)
    got = _port_chunks(params)
    for k, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(g, r, err_msg=f"chunk {k}", **F32_TOL)


@pytest.mark.parametrize("geometry", ["inlet_piercing", "outlet_reaching"])
def test_full_plane_pallas_declines_x_edge_solids(geometry):
    # so those geometries are held against the tiled kernel only
    problem = jax_problem(_params(geometry, precision="f32"))
    assert jax_pallas3d.make_local_step_pallas3d(
        problem, problem.spatial_shape, interpret=True) is None


# ---- forces and diagnostics -------------------------------------------

@pytest.mark.parametrize("geometry", ["ragged", "inlet_piercing",
                                      "outlet_reaching"])
def test_momentum_exchange_matches_tpulbm(geometry):
    params = _params(geometry)
    problem, jproblem = port_problem(params), jax_problem(params)
    f = _noisy_state(problem, 5)
    got = forces.forces_fn(problem, "cpu")(torch.from_numpy(f))
    want = jforces.forces_fn(jproblem)(jnp.asarray(f))
    assert tuple(got.shape) == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("params", [
    _params("ragged"), _params("inlet_piercing"),
    SimulationParams(nx=64, ny=32, tau=0.6, inlet_velocity=0.05)],
    ids=["sphere", "piercing", "cylinder2d"])
def test_force_coefficients_match_tpulbm(params):
    problem, jproblem = port_problem(params), jax_problem(params)
    force = np.array([3e-3, -1e-3, 2e-4])[:problem.lattice.D]
    assert forces.force_coefficients(problem, force) == \
        jforces.force_coefficients(jproblem, force)
    if problem.lattice.D == 3:   # q = 1/2 U^2 pi r^2, the frontal area
        r = params.get_cylinder_radius_cells()
        q = 0.5 * 0.05 ** 2 * np.pi * r * r
        np.testing.assert_allclose(
            forces.force_coefficients(problem, force), force[:2] / q,
            rtol=1e-14)


def test_diagnostics_match_tpulbm():
    params = _params("inlet_piercing")
    problem, jproblem = port_problem(params), jax_problem(params)
    f = _noisy_state(problem, 9)
    ft, fj = torch.from_numpy(f), jnp.asarray(f)
    rho, u = diagnostics.fields_fn(problem, "cpu")(ft)
    jrho, ju = jdiag.fields_fn(jproblem)(fj)
    assert tuple(u.shape) == (3,) + problem.spatial_shape
    np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), **F64_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), **F64_TOL)
    np.testing.assert_allclose(
        float(diagnostics.max_velocity_fn(problem, "cpu")(ft)),
        float(jdiag.max_velocity_fn(jproblem)(fj)), **F64_TOL)
    assert bool(diagnostics.stability_fn(problem)(ft))


# ---- stepper, wrapper and guards --------------------------------------

# tpulbm's one-device plan (sharded_step.py:32-49, :175-198) by chunk
# length: depth 3 leads, a depth-2 tail takes the remainder, and a chunk too
# short for either runs the 1-step kernel
BLOCKED_PLAN = {1: [(1, 1)], 3: [(3, 1)], 4: [(2, 2)], 6: [(3, 2)],
                140: [(3, 46), (2, 1)]}


@pytest.mark.parametrize("env", [{}, {"TPULBM_NO_FUSED2": "1"},
                                 {"TPULBM_NO_FUSED2": "1",
                                  "TPULBM_SUBSTEPS": "3"}],
                         ids=["default", "no_fused2", "no_fused2_substeps3"])
@pytest.mark.parametrize("chunk_len", [1, 3, 4, 6, 140])
def test_3d_chunks_run_one_step_per_launch(monkeypatch, env, chunk_len):
    # a chunk runs tpulbm's plan, each launch its depth's steps (one step
    # per launch with blocking off), and equals chunk_len plain steps
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    for name in ("collide_stream_3d", "collide_stream_3d_blocked"):
        real = getattr(step_cuda, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(args[4] if _name.endswith("blocked") else 1)
            return _real(*args, **kw)

        monkeypatch.setattr(step_cuda, name, spy)
    problem = port_problem(_params(nx=8, ny=6, nz=4, precision="f32"))
    chunk = stepper.make_chunk_fn(problem, "cpu", chunk_len)
    plan = ([(1, chunk_len)] if env else BLOCKED_PLAN[chunk_len])
    assert chunk.plan == plan
    assert chunk.substeps == plan[0][0]
    assert chunk.pallas3d_depths == (
        None if plan == [(1, chunk_len)] else [d for d, _ in plan])
    f = state_from_numpy(problem.initial_state(), problem, "cpu")
    want = f.clone()
    plain = make_step_rolled(problem, "cpu")
    for _ in range(chunk_len):
        want = plain(want)
    assert torch.equal(chunk(f), want)
    assert calls == [d for d, n in plan for _ in range(n)]


@pytest.mark.parametrize("forced", ["4", "5", "8", "9"])
def test_3d_blocking_depth_is_refused(monkeypatch, forced):
    # depths 4-8 run where they divide the chunk (the deep build on the
    # card, N plain steps here); one above tpulbm's halo height of 8 gets
    # no plan, as tpulbm's TPU dispatch, and the chunk runs the 1-step
    # kernel
    monkeypatch.setenv("TPULBM_SUBSTEPS", forced)
    problem = port_problem(_params(nx=8, ny=6, nz=10, precision="f32"))
    n = int(forced)
    chunk_len = 2 * n
    chunk = stepper.make_chunk_fn(problem, "cpu", chunk_len)
    held = n <= step_cuda.MAX_DEPTH
    assert chunk.plan == ([(n, 2)] if held else [(1, chunk_len)])
    assert chunk.pallas3d_depths == ([n] if held else None)
    f = state_from_numpy(problem.initial_state(), problem, "cpu")
    want = f.clone()
    plain = make_step_rolled(problem, "cpu")
    for _ in range(chunk_len):
        want = plain(want)
    assert torch.equal(chunk(f), want)
    assert stepper.make_chunk_fn(problem, "cpu", 7).plan == [(1, 7)]


def test_3d_kernel_backend_refuses_f64():
    with pytest.raises(NotImplementedError, match="float32"):
        stepper.make_chunk_fn(port_problem(_params()), "cpu", 4)


@pytest.mark.parametrize("with_fields", [False, True])
def test_3d_super_chunk_matches_interval_diagnostics(with_fields):
    problem = port_problem(_params("ragged", precision="f32"))
    f0 = state_from_numpy(problem.initial_state(), problem, "cpu")
    fn = stepper.make_super_chunk_fn(problem, "cpu", 3, 4,
                                     with_fields=with_fields)
    f_end, flat = fn(f0.clone())
    d = fn.unpack(flat)
    chunk = stepper.make_chunk_fn(problem, "cpu", 3)
    force = forces.forces_fn(problem, "cpu")
    fields = diagnostics.fields_fn(problem, "cpu")
    max_vel = diagnostics.max_velocity_fn(problem, "cpu")
    f = f0.clone()
    for j in range(4):
        assert torch.equal(d["forces"][j], force(f)[:2])
        assert torch.equal(d["max_vel"][j], max_vel(f))
        assert float(d["stable"][j]) == 1.0
        if with_fields:
            rho, u = fields(f)
            assert tuple(d["u"].shape) == (4, 3) + problem.spatial_shape
            assert torch.equal(d["rho"][j], rho)
            assert torch.equal(d["u"][j], u)
        f = chunk(f)
    assert torch.equal(f_end, f)


def test_3d_wrapper_guards_and_counts():
    problem = port_problem(_params(precision="f32"))
    step = step_cuda.make_local_step_cuda_3d(problem, "cpu")
    f = torch.from_numpy(problem.initial_state())
    before = step_cuda.launches(step_cuda.collide_stream_3d)
    out = step(f, torch.empty_like(f))
    assert torch.equal(out, make_step_rolled(problem, "cpu")(f))
    assert step_cuda.launches(step_cuda.collide_stream_3d) == before  # CPU
    solid = torch.zeros(problem.spatial_shape, dtype=torch.uint8)
    step_cuda.check_inputs(f, torch.empty_like(f), solid, q=19)
    for bad_f, exc in ((f[:9], ValueError), (f[:, 0], ValueError),
                       (f.double(), TypeError)):
        with pytest.raises(exc):
            step_cuda.check_inputs(bad_f, torch.empty_like(bad_f),
                                   solid, q=19)
    with pytest.raises(ValueError):
        step_cuda.check_inputs(f, f, solid, q=19)
    with pytest.raises(ValueError):
        step_cuda.check_inputs(f, torch.empty_like(f), solid[:-1].clone(),
                               q=19)
    step_cuda.reset_launch_counts()
    assert step_cuda.launches(step_cuda.collide_stream_3d) == 0
    with pytest.raises(NotImplementedError):
        step_cuda.make_local_step_cuda_3d(
            port_problem(SimulationParams(nx=40, ny=20)), "cpu")


def test_state_round_trip_d3q19():
    problem = port_problem(_params("ragged", precision="f32"))
    f = _noisy_state(problem, 2)
    t = state_from_numpy(f, problem, "cpu")
    assert state_to_numpy(t).tobytes() == f.tobytes()
    for bad in (t[:9], t[:, 0], t[None]):
        with pytest.raises(ValueError):
            state_to_numpy(bad)


def test_cylinder3d_preset_builds():
    from tpulbm_torch.__main__ import build_parser
    from tpulbm_torch.config import params_from_args
    params = params_from_args(build_parser().parse_args(
        ["--preset", "cylinder3d-small"]))
    problem = port_problem(params)
    assert problem.spatial_shape == (64, 64, 128)
    assert problem.solid.tobytes() == jax_problem(params).solid.tobytes()


# ---- the Runner against tpulbm's --------------------------------------

def _runner_params(tmp, **kw):
    # radius 2 sphere on tpulbm's test grid; 60 steps every 5: one
    # super-chunk of 8 intervals (t = 0..35), then the tail (t = 40..55)
    d = dict(num_timesteps=60, output_frequency=5, precision="f32",
             backend="jax", enable_vtk=True, output_dir=str(tmp),
             cylinder_radius=0.15)
    d.update(kw)
    return _params(**d)


@pytest.fixture(scope="module")
def tpulbm_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("tpulbm3d")
    assert JaxRunner(_runner_params(out), verbose=False).run().success
    return out


def _forces(path):
    return np.loadtxt(path / "forces.csv", delimiter=",", skiprows=1)


def _vtk_numbers(path):
    lines = open(path).read().splitlines()
    return lines, np.array([float(v) for ln in lines for v in ln.split()
                            if re.fullmatch(r"-?[\d.]+(e[-+]\d+)?", v)])


def _assert_artifacts_close(got_dir, ref_dir, params):
    got, ref = _forces(got_dir), _forces(ref_dir)
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got[:, 1:3], ref[:, 1:3], rtol=1e-4,
                               atol=5e-6)
    q = 0.5 * params.inlet_velocity ** 2 * np.pi \
        * params.get_cylinder_radius_cells() ** 2
    np.testing.assert_allclose(got[:, 3:5], ref[:, 3:5], rtol=1e-4,
                               atol=5e-6 / q)
    g, r = (np.load(d / "fields3d.npz") for d in (got_dir, ref_dir))
    # the same physics recorded (the run's directory and backend differ)
    got_p, ref_p = (json.loads(d["params"].tobytes()) for d in (g, r))
    for key in ("output_dir", "backend", "num_timesteps", "checkpoint_every"):
        got_p.pop(key), ref_p.pop(key)
    assert got_p == ref_p
    for name in ("rho", "ux", "uy", "uz"):
        assert g[name].shape == (params.nz, params.ny, params.nx)
        np.testing.assert_allclose(g[name], r[name], rtol=1e-5, atol=5e-6,
                                   err_msg=name)


@pytest.mark.parametrize("backend", ["pallas", "jax"])
def test_runner_artifacts_match_tpulbm(tmp_path, tpulbm_run, backend):
    params = _runner_params(tmp_path, backend=backend)
    result = Runner(port_params(params), device="cpu", verbose=False).run()
    assert result.success and result.final_step == 60
    assert result.stats is None          # no drag summary in 3-D
    # in the loop: 1 super-chunk fetch, 4 tail diagnostics and 4 VTK field
    # pairs, the one-step-short fields (2) and the final stability check
    assert result.host_fetches == 1 + 4 + 8 + 2 + 1
    assert list(_forces(tmp_path)[:, 0]) == list(range(0, 60, 5))
    _assert_artifacts_close(tmp_path, tpulbm_run, params)
    frames = sorted(os.listdir(tmp_path / "vtk_output"))
    assert frames == sorted(os.listdir(tpulbm_run / "vtk_output"))
    assert len(frames) == 12             # t = 5..55 and the final t = 60
    for name in frames:
        lines, got = _vtk_numbers(tmp_path / "vtk_output" / name)
        ref_lines, want = _vtk_numbers(tpulbm_run / "vtk_output" / name)
        assert lines[:9] == ref_lines[:9]
        assert lines[4] == "DIMENSIONS 32 16 8"
        assert len(lines[9].split()) == 3      # ux uy uz
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-6,
                                   err_msg=name)


@pytest.mark.parametrize("direction", ["port_to_tpulbm", "tpulbm_to_port"])
def test_3d_checkpoint_resumes_in_the_other_package(tmp_path, direction):
    writer, reader = ((Runner, JaxRunner) if direction == "port_to_tpulbm"
                      else (JaxRunner, Runner))

    def run(cls, params, **kw):
        if cls is Runner:
            return Runner(port_params(params.replace(backend="pallas")),
                          device="cpu", verbose=False).run(**kw)
        return JaxRunner(params, verbose=False).run(**kw)

    base = dict(output_frequency=10, enable_vtk=False)
    straight = _runner_params(tmp_path / "straight", num_timesteps=40,
                              **base)
    run(reader, straight)
    half = _runner_params(tmp_path / "moved", num_timesteps=20,
                          checkpoint_every=1, **base)
    run(writer, half)
    result = run(reader, half.replace(num_timesteps=40), resume=True)
    assert result.success and result.final_step == 40
    assert list(_forces(tmp_path / "moved")[:, 0]) == [0, 10, 20, 30]
    _assert_artifacts_close(tmp_path / "moved", tmp_path / "straight",
                            straight)
