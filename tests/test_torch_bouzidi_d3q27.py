"""The Bouzidi curved wall on D3Q27 (tpulbm's `--problem cylinder3d
--lattice3d d3q27 --obstacle-bc bouzidi`, still, and spinning through a
hand-built wall velocity as tpulbm spins only the 2-D cylinder) against
tpulbm, on the CPU.

* the 27-plane link table (54 spinning) byte for byte against tpulbm's,
  the library and the kernel mask's link bits;
* the plain step against tpulbm's make_step_rolled in f64 at 1e-12 under
  every collision tpulbm runs on D3Q27, the plain mesh chunk against
  tpulbm's backend="jax" mesh chunk on (1,1), (2,1), (2,2);
* the kernel module (its CPU path) against tpulbm's jax tier at tpulbm's
  plan (depth 3, then a depth-2 tail: pallas3d_depths [3, 2]; its Pallas
  rows 6-7 in interpret mode: tests/test_torch_slab_d3q27_pallas.py), the
  mesh plan (blocked on a y cut, depth 1 where x is cut) and the mesh
  chunk against one device;
* the cut-link force against tpulbm's; the Runner's artifacts and
  checkpoints both ways against tpulbm's Runner; the CLI (tpulbm's
  ValueError for --cylinder-omega on the sphere, as tpulbm's);
* both D3Q19 sources built with -DTPULBM_Q=27 -DTPULBM_BOUZIDI=1 for the
  host with g++ (tests/test_torch_mesh_thermal.py's FAKE_RUNTIME): one step
  against the plain step from a ±10% perturbed state under each
  collision, N = 2, 3 bitwise against N 1-step launches, the N = 3 tile
  within a block's shared memory, the ring builds bitwise one device on
  (2,1) at N = 3 and 2, (2,2) and (1,2) at depth 1, a staircase table and
  the equilibrium library off by many tolerances.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.ops import bouzidi as jbz
from tpulbm.ops import forces as jforces
from tpulbm.ops.step_jax import make_step_rolled as jax_step_rolled
from tpulbm.parallel.mesh import make_mesh as jax_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state as jax_shard_state
from tpulbm.runner import Runner as JaxRunner
from tpulbm_torch import convert
from tpulbm_torch.ops import bouzidi, forces, step_cuda, step_torch
from tpulbm_torch.parallel import sharded_step
from tpulbm_torch.runner import Runner
from tpulbm_torch.stepper import make_chunk_fn
from test_torch_compat import port_params, port_problem
from test_torch_mesh import cpu_mesh, perturbed
from test_torch_slab import (F32_TOL, SEPARATION, host_build,  # noqa: F401
                             host_kernels, host_ring_launch, host_step,
                             prebuild, separation)

F64_TOL = dict(rtol=1e-12, atol=1e-15)
PLAW_TOL = dict(rtol=1e-4, atol=1e-7)
ART = dict(rtol=1e-4, atol=5e-6)
SPHERE = dict(problem="cylinder3d", nx=24, ny=16, nz=8, tau=0.6,
              inlet_velocity=0.05, cylinder_radius=0.23,
              obstacle_bc="bouzidi", lattice3d="d3q27")
OPERATORS = {"bgk": {}, "trt": dict(collision="trt"),
             "regularized": dict(collision="regularized"),
             "les": dict(smagorinsky=0.17),
             "power_law": dict(power_law_n=0.7, power_law_k=0.02)}
LIBRARIES = {"bgk": "bgk+bouzidi+d3q27", "trt": "trt+bouzidi+d3q27",
             "regularized": "regularized+bouzidi+d3q27",
             "les": "smagorinsky+bouzidi+d3q27",
             "power_law": "power_law+bouzidi+d3q27"}


def _params(precision="f64", **kw):
    return SimulationParams(precision=precision, **{**SPHERE, **kw})


def spinning(problem):
    """The sphere spinning about z at a surface speed equal to the inlet
    speed (its wall velocity built by hand, on either package's
    Problem)."""
    p = problem.params
    c = np.array([p.get_cylinder_x(), p.get_cylinder_y(), p.nz // 2],
                 np.float64)
    omega = p.inlet_velocity / float(p.get_cylinder_radius_cells())

    def uw(pts):
        d = pts - c
        return np.stack([-omega * d[..., 1], omega * d[..., 0],
                         np.zeros_like(d[..., 0])], axis=-1)

    return dataclasses.replace(problem, obstacle_velocity=uw)


def pair(case="bgk", precision="f64", **kw):
    """(the port's Problem, tpulbm's) of the sphere under a collision of
    OPERATORS, or "spinning" (BGK)."""
    params = _params(precision, **OPERATORS.get(case, {}), **kw)
    mine, ref = port_problem(params), jax_problem(params)
    if case == "spinning":
        mine, ref = spinning(mine), spinning(ref)
    return mine, ref


# ---- the link tables, the library, the mask ---------------------------------

@pytest.mark.parametrize("case", ["bgk", "spinning"])
def test_d3q27_link_tables_match_tpulbm_bytewise(case):
    mine, ref = pair(case)
    got, want = bouzidi.link_tables(mine), jbz.link_tables(ref)
    assert got.shape == want.shape
    assert got.shape[0] == 27 * (2 if case == "spinning" else 1)
    assert got.tobytes() == want.tobytes()
    assert bouzidi.link_q(mine).tobytes() == jbz.link_q(ref).tobytes()
    assert bouzidi.active_directions(mine) == jbz.active_directions(ref)
    # the corner directions (19-26) carry cut links of their own
    assert (got[19:27] >= 0).any()
    assert got.tobytes() == bouzidi.table_block(
        mine, (0, 0, 0), mine.spatial_shape).tobytes()


@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_d3q27_bouzidi_library_and_link_bits(op):
    mine, _ = pair(op, "f32")
    consts = step_cuda.kernel_constants(mine, 19)
    assert consts.library == LIBRARIES[op]
    assert consts.variant & (step_cuda.BOUZIDI | step_cuda.D3Q27) == (
        step_cuda.BOUZIDI | step_cuda.D3Q27)
    mask = step_cuda.kernel_mask(mine)
    links = (mask & step_cuda.LINK_BIT) != 0
    np.testing.assert_array_equal(
        links, bouzidi.link_cells(bouzidi.link_tables(mine), 27))
    assert 0 < links.sum() < mine.solid.size


def test_mrt_on_d3q27_stays_tpulbms_error():
    with pytest.raises(ValueError, match="MRT"):
        port_problem(_params(collision="mrt"))


# ---- the plain tier ---------------------------------------------------------

@pytest.mark.parametrize("case", [*sorted(OPERATORS), "spinning"])
def test_plain_step_matches_jax_rolled_f64(case):
    mine, ref = pair(case)
    f = perturbed(ref, 5)
    f[:, ref.solid] = ref.lattice.w[:, None]
    got, want = torch.from_numpy(f), f
    step = step_torch.make_step_rolled(mine, "cpu")
    jstep = jax.jit(jax_step_rolled(ref))
    for _ in range(2):
        got = step(got)
        want = np.asarray(jstep(want))
    np.testing.assert_allclose(got.numpy(), want, **F64_TOL)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2)])
def test_plain_mesh_chunk_matches_tpulbm_f64(shape):
    mine, ref = pair("bgk")
    f0 = perturbed(ref, 6)
    mesh = jax_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
    chunk = jax_chunk_fn(ref, mesh, 3, backend="jax")
    s, solid = jax_shard_state(mesh, f0, ref.solid)
    want = np.asarray(jax.device_get(chunk(s, solid)))
    port = sharded_step.make_chunk_fn(mine, cpu_mesh(shape), 3,
                                      backend="jax")
    got = convert.gather_state(port(convert.split_state(
        f0, mine, cpu_mesh(shape))))
    np.testing.assert_allclose(got, want, **F64_TOL)


# ---- the kernel module on the CPU -------------------------------------------

@pytest.mark.parametrize("case", ["bgk", "spinning"])
def test_kernel_module_matches_tpulbm_jax_tier(case):
    # tpulbm's plan for a 5-step chunk: depth 3, then a depth-2 tail
    mine, ref = pair(case, "f32")
    f0 = perturbed(ref, 7)
    mesh = jax_mesh((1, 1), devices=jax.devices()[:1])
    chunk = jax_chunk_fn(ref, mesh, 5, backend="jax")
    s, solid = jax_shard_state(mesh, f0, ref.solid)
    want = np.asarray(jax.device_get(chunk(s, solid)))
    port = make_chunk_fn(mine, "cpu", 5)
    assert port.pallas3d_depths == [3, 2]
    assert port.plan == [(3, 1), (2, 1)]
    got = port(torch.from_numpy(f0))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("chunk_len,plan", [
    (140, [(3, 46), (2, 1)]), (280, [(3, 92), (2, 2)]), (139, [(3, 45),
                                                             (2, 2)]),
    (1, [(1, 1)])])
def test_one_device_plan_is_tpulbms(chunk_len, plan):
    from tpulbm.parallel.sharded_step import _blocking_split
    mine, _ = pair("bgk", "f32")
    assert make_chunk_fn(mine, "cpu", chunk_len).plan == plan
    if chunk_len > 1:
        assert _blocking_split(chunk_len, 3) == plan


@pytest.mark.parametrize("shape,mode,depths", [
    ((2, 1), "rows", [3, 2]), ((1, 2), "tiled", [1]),
    ((2, 2), "tiled", [1])])
@pytest.mark.parametrize("case", ["bgk", "spinning"])
def test_mesh_plan_and_chunk_match_one_device(case, shape, mode, depths):
    # tpulbm's Bouzidi dispatch on a mesh: the cascade with the link
    # table's rings on a y cut, depth 1 with x rings where x is cut
    mine, _ = pair(case, "f32")
    mesh = cpu_mesh(shape)
    got_mode, segments = sharded_step.plan_3d(mine, mesh, 5)
    assert got_mode == mode and [d for d, _ in segments] == depths
    f0 = torch.from_numpy(perturbed(mine, 8))
    want = make_chunk_fn(mine, "cpu", 5)(f0.clone())
    chunk = sharded_step.make_chunk_fn(mine, mesh, 5)
    got = sharded_step.gather(chunk(sharded_step.split(mesh, f0)))
    torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)
    diag = sharded_step.Diagnostics(mine, mesh)
    torch.testing.assert_close(diag.force(sharded_step.split(mesh, want)),
                               forces.forces_fn(mine, "cpu")(want),
                               rtol=1e-12, atol=1e-15)


# ---- the force, the Runner, checkpoints, the CLI ----------------------------

@pytest.mark.parametrize("case", ["bgk", "spinning"])
def test_d3q27_bouzidi_force_matches_tpulbm(case):
    mine, ref = pair(case)
    f = perturbed(ref, 9)
    want = np.asarray(jax.jit(jforces.forces_fn(ref))(
        f, jbz.link_tables(ref)))
    got = forces.forces_fn(mine, "cpu")(torch.from_numpy(f))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


def _runner_params(tmp, **kw):
    return _params("f32", num_timesteps=40, output_frequency=20,
                   enable_vtk=False, output_dir=str(tmp), backend="jax",
                   **kw)


def _same_artifacts(a, b):
    with np.load(a / "fields3d.npz") as x, np.load(b / "fields3d.npz") as y:
        for k in ("rho", "ux", "uy", "uz"):
            np.testing.assert_allclose(x[k], y[k], err_msg=k, **ART)
    rows = [np.loadtxt(d / "forces.csv", delimiter=",", skiprows=1)
            for d in (a, b)]
    np.testing.assert_array_equal(rows[0][:, 0], rows[1][:, 0])
    np.testing.assert_allclose(rows[0][:, 1:3], rows[1][:, 1:3], **ART)


def _run(pkg, params, **kw):
    if pkg == "port":
        return Runner(port_params(params.replace(backend="pallas")),
                      device="cpu", verbose=False).run(**kw)
    return JaxRunner(params, verbose=False).run(**kw)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """straight(pkg) -> the directory of the module's one 40-step run of
    _runner_params by `pkg` ("port", one device, or "tpulbm"), which the
    Runner and checkpoint tests share."""
    runs = {}

    def get(pkg):
        if pkg not in runs:
            out = tmp_path_factory.mktemp(f"straight_{pkg}")
            result = _run(pkg, _runner_params(out))
            assert result.success and result.final_step == 40
            runs[pkg] = out
        return runs[pkg]

    return get


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1)])
def test_runner_artifacts_match_tpulbm(tmp_path, straight, mesh_shape):
    if mesh_shape == (1, 1):
        port = straight("port")
    else:
        port = tmp_path / "port"
        result = _run("port", _runner_params(port, mesh_shape=mesh_shape))
        assert result.success and result.final_step == 40
    _same_artifacts(port, straight("tpulbm"))


@pytest.mark.parametrize("direction", ["port_to_tpulbm", "tpulbm_to_port"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, straight,
                                                 direction):
    writer, reader = (("port", "tpulbm") if direction == "port_to_tpulbm"
                      else ("tpulbm", "port"))
    half = _runner_params(tmp_path / "moved", checkpoint_every=1).replace(
        num_timesteps=20)
    _run(writer, half)
    result = _run(reader, half.replace(num_timesteps=40), resume=True)
    assert result.success and result.final_step == 40
    _same_artifacts(tmp_path / "moved", straight(reader))


@pytest.mark.parametrize("extra", [[], ["--mesh", "2x1"]],
                         ids=["one-device", "mesh"])
def test_cli_runs_the_d3q27_bouzidi_sphere(tmp_path, extra):
    from tpulbm_torch.__main__ import main
    assert main(["--problem", "cylinder3d", "--lattice3d", "d3q27",
                 "--obstacle-bc", "bouzidi", "--nx", "24", "--ny", "16",
                 "--nz", "8", "--cylinder-radius", "0.23",
                 "--inlet-velocity", "0.05", "--num-timesteps", "12",
                 "--output-frequency", "6", "--no-vtk", "--cpu", *extra,
                 "--output-dir", str(tmp_path)]) == 0
    rows = np.loadtxt(tmp_path / "forces.csv", delimiter=",", skiprows=1)
    assert rows.shape == (2, 5) and np.isfinite(rows).all()


def test_cli_refuses_a_spinning_sphere_as_tpulbm():
    # tpulbm spins the 2-D cylinder only: --cylinder-omega on the sphere is
    # its ValueError in both packages
    from tpulbm.config import validate_params as jvalidate
    from tpulbm_torch.__main__ import main
    params = _params(cylinder_omega=0.01)
    with pytest.raises(ValueError, match="2-D cylinder") as want:
        jvalidate(params)
    with pytest.raises(ValueError) as got:
        main(["--problem", "cylinder3d", "--lattice3d", "d3q27",
              "--obstacle-bc", "bouzidi", "--nx", "24", "--ny", "16",
              "--nz", "8", "--cylinder-omega", "0.01", "--cpu",
              "--no-vtk"])
    assert str(got.value) == str(want.value)


# ---- the kernels on the host ------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _libraries(host_build):
    """The module's host libraries, built in the background while its first
    tests run: both D3Q19 sources per collision, the ring builds, the
    equilibrium obstacle's D3Q27 library."""
    libs = [(src, step_cuda.build_defines("bgk", step_cuda.D3Q27))
            for src in ("step_d3q19.cu",)]
    for case in [*sorted(OPERATORS), "spinning"]:
        c = step_cuda.kernel_constants(pair(case, "f32")[0], 19)
        rings = (0, step_cuda.RINGS) if case in ("bgk", "spinning") else (0,)
        for src in ("step_d3q19.cu", "step_d3q19_blocked.cu"):
            for r in rings:
                libs.append((src, step_cuda.build_defines(
                    c.mode, c.variant | r)))
    pool = prebuild(host_build, libs)
    yield
    pool.shutdown(cancel_futures=True)


@pytest.mark.parametrize("case", [*sorted(OPERATORS), "spinning"])
def test_host_kernels_match_plain_and_each_other(host_kernels, case):
    mine, _ = pair(case, "f32")
    f = torch.from_numpy(perturbed(mine, 10))
    f[:, torch.from_numpy(mine.solid)] = torch.as_tensor(
        mine.lattice.w, dtype=f.dtype)[:, None]
    want = step_torch.make_step_rolled(mine, "cpu")(f)
    one = host_step(mine, f)
    torch.testing.assert_close(one, want, **(PLAW_TOL if case == "power_law"
                                            else F32_TOL))
    consts = step_cuda.kernel_constants(mine, 19)
    if case == "bgk":
        # the equilibrium obstacle's D3Q27 library, and the Bouzidi build
        # fed a staircase table (every q at 1/2), miss by many tolerances
        base = dataclasses.replace(consts, variant=step_cuda.D3Q27)
        assert separation(host_step(mine, f, consts=base), want) > SEPARATION
        table = bouzidi.device_table(mine, "cpu")
        stair = torch.where(table >= 0, torch.full_like(table, 0.5), table)
        assert separation(host_step(mine, f, links=stair), want) > SEPARATION
        lib = step_cuda._blocked_library_3d(consts.mode, consts.variant)
        # 63 floats a cell, blocks in 1 x 2 clusters: 32 x 8 at N = 2, 32 x
        # 4 at N = 3, within the 232,448 B a block may take
        assert [lib.tpulbm_d3q19_blocked_smem_bytes(n) for n in (2, 3)] == \
            [186928, 192880]
        assert [divmod(lib.tpulbm_d3q19_blocked_tile(n), 256)
                for n in (2, 3)] == [(32, 8), (32, 4)]
        assert [divmod(lib.tpulbm_d3q19_blocked_cluster(n), 256)
                for n in (2, 3)] == [(1, 2), (1, 2)]
    for n in step_cuda.BLOCKED_DEPTHS_3D:
        g = f
        for _ in range(n):
            g = host_step(mine, g)
        assert torch.equal(host_step(mine, f, n), g), n


@pytest.mark.parametrize("shape,depth,x_rings", [
    ((2, 1), 3, False), ((2, 1), 2, False), ((2, 2), 1, True),
    ((1, 2), 1, True)], ids=["rows-n3", "rows-n2", "2x2", "x-cut"])
@pytest.mark.parametrize("case", ["bgk", "spinning"])
def test_host_ring_builds_equal_one_device(host_kernels, case, shape, depth,
                                           x_rings):
    mine, _ = pair(case, "f32")
    f = torch.from_numpy(perturbed(mine, 11))
    want = host_step(mine, f, depth)
    got, plain_err, eq_off = host_ring_launch(mine, f, shape, depth,
                                              x_rings)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert plain_err <= 4e-7
    assert eq_off > 1e-4
