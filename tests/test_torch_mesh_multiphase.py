"""Shan-Chen multiphase on a mesh of shards (tpulbm_torch/parallel/, the
multiphase kernel's ring build) against tpulbm's on its virtual CPU
devices, the port's shards all on `cpu`, inputs made by numpy from a
seed, at dryrun_multichip's small shapes:

* the plain mesh chunk (--backend jax: tpulbm's body_jax, a ring refresh
  before each half of make_local_steps_multiphase) equals tpulbm's
  make_chunk_fn(backend="jax") in f64 at rtol 1e-12 / atol 1e-15 on
  (2,1) and (2,2), the droplet and the band with a wetting wall, from a
  ±10% perturbed state;
* the kernel module's CPU path (the plain ring step, rings two cells
  deep) against the port's one-device chunk, and the dispatch
  (TPULBM_FORCE_XHALO: tpulbm's mp_xh);
* the physical velocity u + F/(2ρ) on meshes (a one-cell padded block a
  shard, the wall rule at the global rows) against one device, where a
  shard that wrapped its own edges would be far off, on (1,1) bit for
  bit;
* the Runner on a mesh against its one-device run and tpulbm's,
  per-shard checkpoints both ways, the CLI's --mesh;
* the multiphase kernel's source and its ring build built with g++
  against the fake CUDA runtime of tests/test_torch_mesh_thermal.py:
  every mesh bitwise the one-device build;
* tpulbm's multi-device gate (__graft_entry__.dryrun_multichip's five
  families on its 8-device layouts) through the port's kernel module on
  CPU shards against one device.
"""
import ctypes

import jax
import numpy as np
import pytest
import torch

from tpulbm.config import PRESETS as JAX_PRESETS
from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.runner import Runner as JaxRunner
from tpulbm_torch import stepper
from tpulbm_torch.ops import step_cuda, step_multiphase, step_multiphase_cuda
from tpulbm_torch.parallel import halo, sharded_step
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import checkpoint as ckpt
from test_torch_3d_blocking import _setenv
from test_torch_compat import port_params, port_problem
from test_torch_mesh import _port_chunks, _tpulbm_chunks, cpu_mesh, perturbed
from test_torch_mesh_thermal import (ARTIFACT_TOL, F32_TOL, _csv,  # noqa: F401
                                     host_cuda, host_ring_steps)

MP = dict(problem="multiphase", tau=1.0, shan_chen_g=-5.0,
          inlet_velocity=0.0, cylinder_x=0.5, cylinder_y=0.5)
CASES = {"droplet": dict(MP, cylinder_radius=0.15),
         "band": dict(MP, cylinder_radius=0.0, mp_wall_rho=1.6)}


def params(case, precision="f64", nx=64, ny=32, **kw):
    return SimulationParams(precision=precision, nx=nx, ny=ny,
                            **dict(CASES[case], **kw))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
def test_plain_mesh_chunk_matches_tpulbm(case, mesh_shape):
    p = params(case)
    f0 = perturbed(jax_problem(p))
    want = _tpulbm_chunks(p, mesh_shape, 4, 1, f0)
    got, chunk = _port_chunks(p, mesh_shape, 4, 1, f0)
    assert chunk.mode == "plain"
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh_shape,env,mode", [
    ((2, 1), {}, "rows"), ((1, 2), {}, "tiled"), ((2, 2), {}, "tiled"),
    ((1, 1), {"TPULBM_FORCE_XHALO": "1"}, "tiled"),
    ((2, 1), {"TPULBM_FORCE_XHALO": "1"}, "tiled"),
    ((1, 1), {}, "one-device")])
def test_kernel_module_on_a_mesh_matches_one_device(monkeypatch, case,
                                                    mesh_shape, env, mode):
    _setenv(monkeypatch, env)
    p = params(case, precision="f32")
    f0 = perturbed(jax_problem(p))
    got, chunk = _port_chunks(p, mesh_shape, 6, 2, f0, backend="pallas")
    assert chunk.mode == mode
    one = stepper.make_chunk_fn(port_problem(p), "cpu", 6)
    g = torch.from_numpy(f0.copy())
    for k in range(2):
        g = one(g)
        np.testing.assert_allclose(got[k], g.numpy(), err_msg=f"chunk {k}",
                                   **F32_TOL)


def test_multiphase_ring_step_reads_its_rings():
    # rings of the frozen equilibrium in place of the neighbours' data,
    # and rings one cell deep where the kernel takes two, are refused or
    # give another step
    problem = port_problem(params("droplet", precision="f32"))
    mesh = cpu_mesh((2, 2))
    f = torch.from_numpy(perturbed(problem))
    blocks = sharded_step.split(mesh, f)
    rings = halo.exchange(blocks, eq_ring=problem.ghost_ring_values(),
                          depth=2, periodic_x=True, x_rings=True)
    local = sharded_step.block_shape(problem, mesh)
    step = step_multiphase.make_ring_step_multiphase(problem, (16, 0), local,
                                                     "cpu")
    good = step(blocks[1][0], *rings[1][0])
    eq = torch.as_tensor(problem.ghost_ring_values(),
                         dtype=torch.float32).reshape(-1, 1, 1)
    flat = [eq.expand(r.shape).contiguous() for r in rings[1][0]]
    assert float((step(blocks[1][0], *flat) - good).abs().max()) > 1e-3
    shard = step_cuda.Shard(index=(1, 0), origin=(16, 0), local_shape=local,
                            grid=problem.spatial_shape, depth=1,
                            x_rings=True)
    with pytest.raises(ValueError, match="rings 1 deep"):
        step_multiphase_cuda.collide_stream_multiphase_rings(
            blocks[1][0], torch.empty_like(blocks[1][0]), rings[1][0], shard,
            step_multiphase_cuda.MultiphaseConstants.of(problem), plain=step)


@pytest.mark.parametrize("case", sorted(CASES))
def test_physical_velocity_on_meshes(case):
    problem = port_problem(params(case, precision="f32"))
    f = torch.from_numpy(perturbed(problem))
    one = sharded_step.Diagnostics(problem, cpu_mesh((1, 1)))
    rho1, u1 = one.fields([[f]])
    # (1,1): the one-device function, bit for bit
    rho, u = step_multiphase.physical_velocity(problem, f)
    assert torch.equal(rho1, rho) and torch.equal(u1, u)
    for shape in [(2, 1), (1, 2), (2, 2), (4, 2)]:
        mesh = cpu_mesh(shape)
        blocks = sharded_step.split(mesh, f)
        diag = sharded_step.Diagnostics(problem, mesh)
        got_rho, got_u = diag.fields(blocks)
        assert torch.equal(got_rho, rho1)
        # the neighbours' ψ, up to PyTorch's sum over the planes on a
        # block of another shape (a float32 rounding of ρ in the ring)
        torch.testing.assert_close(got_u, u1, rtol=1e-5, atol=1e-8)
        # each shard on its own (its edges wrapped, a wall at each) is far
        # off at the shard edges: what the padded blocks repair
        alone = sharded_step.gather([[step_multiphase.physical_velocity(
            problem, b)[1] for b in row] for row in blocks])
        assert float((alone - u1).abs().max()) > 1e-4
        # the statistics sample the same fields
        samples = diag.stats_samples(blocks)
        torch.testing.assert_close(samples[0][1], got_u[
            :, :blocks[0][0].shape[1], :blocks[0][0].shape[2]])


def test_runner_on_a_mesh_matches_one_device(tmp_path):
    kw = dict(precision="f32", num_timesteps=160, output_frequency=10,
              stats_from=40, probe_points=((0.5, 0.5),),
              vtk_start_step=150)
    for name, mesh in (("one", (1, 1)), ("mesh", (4, 1))):
        assert Runner(params("droplet", output_dir=str(tmp_path / name),
                             mesh_shape=mesh, **kw), device="cpu",
                      verbose=False).run().success
    for name in ("velocity_field.csv", "probes.csv"):
        np.testing.assert_allclose(_csv(tmp_path / "mesh" / name),
                                   _csv(tmp_path / "one" / name),
                                   err_msg=name, **ARTIFACT_TOL)
    with np.load(tmp_path / "mesh" / "stats_fields.npz") as got, \
            np.load(tmp_path / "one" / "stats_fields.npz") as ref:
        assert int(got["n_samples"]) == int(ref["n_samples"]) == 12
        for k in ("mean_rho", "mean_ux", "mean_uy"):
            np.testing.assert_allclose(got[k], ref[k], err_msg=k,
                                       **ARTIFACT_TOL)
    frames = sorted(p.name for p in (tmp_path / "mesh" /
                                     "vtk_output").iterdir())
    assert frames and frames == sorted(
        p.name for p in (tmp_path / "one" / "vtk_output").iterdir())
    assert not (tmp_path / "mesh" / "forces.csv").exists()


def test_runner_on_a_mesh_matches_tpulbm(tmp_path):
    # tpulbm's own Runner cannot finish a multiphase run on a mesh here
    # (its physical_velocity rolls a sharded array, which this JAX
    # refuses): the port's (2, 2) mesh run against tpulbm's one-device
    # run, both packages' plain tier in f64
    kw = dict(backend="jax", num_timesteps=40, output_frequency=20,
              enable_vtk=False)
    Runner(params("band", output_dir=str(tmp_path / "port"),
                  mesh_shape=(2, 2), **kw), device="cpu", verbose=False).run()
    JaxRunner(params("band", output_dir=str(tmp_path / "jax"), **kw),
              verbose=False).run()
    np.testing.assert_allclose(_csv(tmp_path / "port" /
                                    "velocity_field.csv"),
                               _csv(tmp_path / "jax" / "velocity_field.csv"),
                               rtol=1e-10, atol=1e-12)


def _jax_mesh_state(p, f, steps):
    """tpulbm's plain mesh chunk of `steps` steps on a (2, 1) mesh of its
    virtual devices from the host state f: (the sharded state, the mesh)."""
    from tpulbm.parallel.mesh import make_mesh as jax_mesh
    from tpulbm.parallel.sharded_step import make_chunk_fn, shard_state
    problem = jax_problem(p)
    mesh = jax_mesh((2, 1), devices=jax.devices()[:2])
    state, solid = shard_state(mesh, f, np.zeros(problem.spatial_shape,
                                                 bool))
    return make_chunk_fn(problem, mesh, steps, backend="jax")(state,
                                                               solid), mesh


def test_per_shard_checkpoint_from_the_port_loads_in_tpulbm(tmp_path):
    from jax.sharding import PartitionSpec as P
    from tpulbm.utils import checkpoint as jckpt
    p = params("droplet", output_dir=str(tmp_path), num_timesteps=20,
               output_frequency=10, checkpoint_every=1, enable_vtk=False,
               backend="jax", mesh_shape=(2, 1))
    assert Runner(p, device="cpu", verbose=False).run().success
    latest = ckpt.latest(str(tmp_path / "checkpoints"))
    step, blocks = ckpt.load_sharded(latest, (2, 1), p)
    assert step == 20 and blocks[1][0].shape == (9, 16, 64)
    mine = np.concatenate([row[0] for row in blocks], axis=-2)
    from tpulbm.parallel.mesh import make_mesh as jax_mesh
    jstep, f = jckpt.load_sharded(latest, jax_mesh(
        (2, 1), devices=jax.devices()[:2]), P(None, "y", "x"), p)
    assert jstep == 20
    assert np.asarray(jax.device_get(f)).tobytes() == mine.tobytes()
    # and tpulbm's mesh steps on from it as the port does
    want, _ = _jax_mesh_state(p, mine, 10)
    got, _ = _port_chunks(p, (2, 1), 10, 1, mine)
    np.testing.assert_allclose(got[0], np.asarray(jax.device_get(want)),
                               rtol=1e-12, atol=1e-15)


def test_per_shard_checkpoint_from_tpulbm_resumes_in_the_port(tmp_path):
    from tpulbm.utils import checkpoint as jckpt
    kw = dict(backend="jax", output_frequency=10, enable_vtk=False,
              mesh_shape=(2, 1))
    Runner(params("droplet", output_dir=str(tmp_path / "straight"),
                  num_timesteps=40, **kw), device="cpu", verbose=False).run()
    half = params("droplet", output_dir=str(tmp_path / "moved"),
                  num_timesteps=40, checkpoint_every=1, **kw)
    f, _ = _jax_mesh_state(half, jax_problem(half).initial_state(), 20)
    jckpt.save_sharded(str(tmp_path / "moved" / "checkpoints"), 20, f, half)
    result = Runner(half, device="cpu", verbose=False).run(resume=True)
    assert result.success and result.final_step == 40
    np.testing.assert_allclose(_csv(tmp_path / "moved" /
                                    "velocity_field.csv"),
                               _csv(tmp_path / "straight" /
                                    "velocity_field.csv"),
                               rtol=1e-10, atol=1e-12)


def test_cli_mesh_runs_multiphase(tmp_path, capsys):
    from tpulbm_torch.__main__ import main
    assert main(["--cpu", "--mesh", "4x1", "--problem", "multiphase",
                 "--shan-chen-g", "-5", "--nx", "64", "--ny", "32",
                 "--tau", "1.0", "--inlet-velocity", "0",
                 "--cylinder-radius", "0.15", "--cylinder-x", "0.5",
                 "--cylinder-y", "0.5", "--num-timesteps", "20",
                 "--output-frequency", "10", "--no-vtk", "--output-dir",
                 str(tmp_path)]) == 0
    assert "Device mesh: 4×1" in capsys.readouterr().out
    assert _csv(tmp_path / "velocity_field.csv").shape == (64 * 32, 6)


# ---- the CUDA source on the host -----------------------------------------

def host_multiphase_step(build, problem, f):
    """One step of the one-device multiphase build on the host."""
    consts = step_multiphase_cuda.MultiphaseConstants.of(problem)
    fn = build("step_multiphase.cu").tpulbm_multiphase_step
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    out = torch.empty_like(f)
    ny, nx = f.shape[1:]
    assert fn(f.data_ptr(), out.data_ptr(), nx, ny, *consts.arrays, 0,
              None) == 0
    return out


# the row march's knobs (tests/test_torch_mp_march_host.py): the default
# build, and a widened row of 9 columns (strips of 5) with 1-row batches,
# segments of 4 rows and the copies 3 batches ahead
MARCH_KNOBS = {"default": (),
               "narrow": ("-DTPULBM_WIDTH=9", "-DTPULBM_ROWS=1",
                          "-DTPULBM_SEGMENT=4", "-DTPULBM_AHEAD=3")}


@pytest.mark.parametrize("knobs", sorted(MARCH_KNOBS))
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh_shape,x_rings", [
    ((1, 1), True), ((5, 1), False), ((2, 2), True), ((1, 4), True)])
def test_host_ring_build_equals_the_one_device_build(host_cuda, case,
                                                     mesh_shape, x_rings,
                                                     knobs):
    def build(source, defines=()):
        return host_cuda(source, (*defines, *MARCH_KNOBS[knobs]))

    problem = port_problem(params(case, precision="f32", nx=100, ny=70))
    f = torch.from_numpy(perturbed(problem))
    want = host_multiphase_step(build, problem, f)
    got, plain_err, eq_off = host_ring_steps(build, problem, f,
                                             mesh_shape, x_rings)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert plain_err <= 1e-7
    assert eq_off > 1e-4


# ---- tpulbm's multi-device gate -------------------------------------------

def _dryrun_families():
    """__graft_entry__.dryrun_multichip(8)'s families on its layouts: a
    (4, 2) mesh, 64x64 grids (32 mx x 16 my), multiphase on (8, 1)."""
    my, mx = 4, 2
    nx2, ny2 = 32 * mx, 16 * my
    return {
        "bgk-cylinder": (SimulationParams(nx=nx2, ny=ny2, tau=0.6,
                                          inlet_velocity=0.05,
                                          precision="f32"), (my, mx), {}),
        "bouzidi-blocked": (SimulationParams(
            nx=nx2, ny=ny2, tau=0.6, inlet_velocity=0.05, precision="f32",
            obstacle_bc="bouzidi"), (my, 1), {"TPULBM_SUBSTEPS": "2"}),
        "thermal-rb": (JAX_PRESETS["rayleigh-benard"].replace(
            nx=nx2, ny=ny2, precision="f32"), (my, mx), {}),
        "multiphase": (SimulationParams(
            nx=nx2, ny=ny2, problem="multiphase", tau=1.0,
            shan_chen_g=-5.0, cylinder_radius=0.15, cylinder_x=0.5,
            cylinder_y=0.5, inlet_velocity=0.0, precision="f32"), (8, 1),
            {}),
        "sphere-3d-tiled": (SimulationParams(
            nx=32, ny=4 * my, nz=8, problem="cylinder3d", tau=0.6,
            inlet_velocity=0.05, cylinder_radius=0.2, precision="f32"),
            (my, mx), {}),
    }


@pytest.mark.parametrize("family", sorted(_dryrun_families()))
def test_dryrun_multichip_families_through_the_kernel_module(monkeypatch,
                                                             family):
    # the kernel module on CPU shards (each shard's plain ring step)
    # against the port's one-device chunk, 4 steps from a ±10% perturbed
    # state, at F32_TOL (PyTorch's sums over the planes round by the
    # block's shape; on the card the ring builds are bitwise one device,
    # chip_smoke.py)
    params, mesh_shape, env = _dryrun_families()[family]
    _setenv(monkeypatch, env)
    p = port_params(params)
    problem = port_problem(params)
    f0 = perturbed(jax_problem(params))
    got, chunk = _port_chunks(params, mesh_shape, 4, 1, f0,
                              backend="pallas")
    assert chunk.mode != "one-device"
    want = stepper.make_chunk_fn(problem, "cpu", 4)(torch.from_numpy(
        f0.copy()))
    assert np.isfinite(got[0]).all() and p.precision == "f32"
    np.testing.assert_allclose(got[0], want.numpy(), **F32_TOL)
