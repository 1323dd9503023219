"""The 3-D problems on a mesh of shards (tpulbm_torch/parallel/ with
(Q, nz, nyl, nxl) blocks) against tpulbm's mesh on its 8 virtual CPU
devices, the port's shards all on `cpu`, inputs made by numpy from a seed
(a ±10% perturbed state: from rest every ring holds the frozen
equilibrium and would hide a ring that is never read):

* the 3-D rings (tpulbm's ring_rows_3d, ring_cols_3d, ring_rows_ext_3d)
  equal tpulbm's under shard_map, periodic and not;
* the plain mesh chunk (--backend jax) equals tpulbm's
  make_chunk_fn(backend="jax") in f64 at rtol 1e-12 / atol 1e-15 on
  (2,1), (1,2), (2,2) and (4,2) for the sphere (equilibrium, bounce-back
  and Bouzidi obstacles), the duct, the boxes and D3Q27;
* the kernel module on a mesh (its CPU path: each shard's plain ring
  step) equals the one-device chunk bit for bit, still and spinning;
  rings of the frozen equilibrium miss the perturbed state;
* the 3-D plan equals tpulbm's depth segments over chunk lengths and
  meshes, apart from the by-design case (the box on an x-cut mesh at
  depth 1, which tpulbm leaves for its jax tier);
* Diagnostics (forces, max velocity, mass, probes, statistics) on 3-D
  meshes equal one device; the Runner's 3-D artifacts on 2x2 equal one
  device's and tpulbm's; per-shard 3-D checkpoints both ways; the CLI's
  --mesh auto on a 3-D preset; the refusals that stay (thermal,
  multiphase, D3Q27's Bouzidi obstacle);
* the 3-D Shard's find()/locate() (csrc/d3q19_common.cuh) built with g++
  read every cell of a padded window as the plain ring assembly does.

The kernel module against tpulbm's 3-D Pallas cascade in interpret mode
is in tests/test_torch_mesh3d_pallas.py.
"""
import dataclasses
import json
import shutil
import subprocess
import warnings

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.parallel import halo as jhalo
from tpulbm.parallel.mesh import make_mesh as jax_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state as jax_shard_state
from tpulbm.runner import Runner as JaxRunner
from tpulbm.utils import checkpoint as jckpt
from tpulbm_torch import convert, stepper
from tpulbm_torch.ops import bouzidi, step_cuda, step_rings_torch
from tpulbm_torch.parallel import halo, sharded_step
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import checkpoint as ckpt
from tpulbm_torch.utils import cuda_build
from test_torch_3d_blocking import _setenv
from test_torch_compat import port_params, port_problem
from test_torch_mesh import _blocks, cpu_mesh, perturbed

SPHERE = dict(problem="cylinder3d", nx=32, ny=16, nz=8, tau=0.6,
              inlet_velocity=0.05, cylinder_x=0.5, cylinder_y=0.5,
              cylinder_radius=0.3)
FAMILIES = {
    "sphere": SPHERE,
    "bounce_back_trt": dict(SPHERE, obstacle_bc="bounce_back",
                            collision="trt"),
    "bouzidi": dict(SPHERE, obstacle_bc="bouzidi"),
    "duct_mrt": dict(problem="poiseuille", nx=32, ny=16, nz=8, tau=0.8,
                     inlet_velocity=0.0, body_force=(1e-4, 0.0, 0.0),
                     collision="mrt"),
    "taylor_green": dict(problem="taylor-green", nx=32, ny=16, nz=8,
                         tau=0.8, inlet_velocity=0.04, cylinder_radius=0.0),
    "kolmogorov": dict(problem="kolmogorov", nx=32, ny=16, nz=8, tau=0.8,
                       inlet_velocity=0.05, cylinder_radius=0.0,
                       collision="regularized"),
    "sphere_d3q27": dict(SPHERE, lattice3d="d3q27"),
    "duct_d3q27": dict(problem="poiseuille", nx=32, ny=16, nz=8, tau=0.8,
                       inlet_velocity=0.0, body_force=(1e-4, 0.0, 0.0),
                       lattice3d="d3q27"),
    "box_d3q27": dict(problem="kolmogorov", nx=32, ny=16, nz=8, tau=0.8,
                      inlet_velocity=0.05, cylinder_radius=0.0,
                      lattice3d="d3q27", smagorinsky=0.17),
}
MESHES = [(2, 1), (1, 2), (2, 2), (4, 2)]


def spinning(problem, u_s=0.05):
    """The sphere spinning about the z axis at surface speed u_s (the
    moving-wall scalars of the Bouzidi rule), built by hand: tpulbm spins
    only the 2-D cylinder."""
    p = problem.params
    c = np.array([p.get_cylinder_x(), p.get_cylinder_y(), p.nz // 2],
                 np.float64)
    omega = u_s / float(p.get_cylinder_radius_cells())

    def uw(pts):
        d = pts - c
        return np.stack([-omega * d[..., 1], omega * d[..., 0],
                         np.zeros_like(d[..., 0])], axis=-1)

    return dataclasses.replace(problem, obstacle_velocity=uw)


# ---- the rings ----------------------------------------------------------

@pytest.mark.parametrize("fn,mesh_shape", [("ring_rows", (2, 1)),
                                           ("ring_cols", (2, 2)),
                                           ("ring_rows_ext", (2, 2))])
@pytest.mark.parametrize("periodic", [False, True])
def test_3d_rings_match_tpulbm(fn, mesh_shape, periodic):
    my, mx = mesh_shape
    depth = 2
    rng = np.random.default_rng(2)
    f = rng.standard_normal((19, 4, 8 * my, 8 * mx))
    eq = rng.standard_normal(19)
    mesh = jax_mesh(mesh_shape, devices=jax.devices()[:my * mx])
    spec = P(None, None, "y", "x")

    def body(fl):
        if fn == "ring_rows":
            return jhalo.ring_rows_3d(fl, eq_ring=eq, mesh_shape=mesh_shape,
                                      depth=depth, periodic_y=periodic)
        rl, rr = jhalo.ring_cols_3d(fl, eq_ring=eq, mesh_shape=mesh_shape,
                                    depth=depth, H=depth,
                                    periodic_x=periodic)
        if fn == "ring_cols":
            return rl, rr
        return jhalo.ring_rows_ext_3d(fl, rl, rr, eq_ring=eq,
                                      mesh_shape=mesh_shape, depth=depth,
                                      periodic_y=periodic)

    want = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,),
                             out_specs=(spec, spec), check_vma=False))(f)
    want = [_blocks(np.asarray(w), my, mx) for w in want]
    shards = _blocks(torch.as_tensor(f), my, mx)
    shards = [[b.contiguous() for b in row] for row in shards]
    if fn == "ring_rows":
        got = halo.ring_rows(shards, eq_ring=eq, depth=depth,
                             periodic_y=periodic)
    else:
        got = halo.ring_cols(shards, eq_ring=eq, depth=depth,
                             periodic_x=periodic)
        if fn == "ring_rows_ext":
            got = halo.ring_rows_ext(shards, got, eq_ring=eq, depth=depth,
                                     periodic_y=periodic)
    for iy in range(my):
        for ix in range(mx):
            for k in range(2):
                np.testing.assert_array_equal(got[iy][ix][k].numpy(),
                                              want[k][iy][ix])


# ---- the plain mesh chunk against tpulbm's jax tier ----------------------

def _tpulbm_chunks(params, mesh_shape, chunk_len, n_chunks, f0,
                   backend="jax"):
    problem = jax_problem(params)
    mesh = jax_mesh(mesh_shape,
                    devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    chunk = jax_chunk_fn(problem, mesh, chunk_len, backend=backend)
    solid = (problem.solid if problem.solid is not None
             else np.zeros(problem.spatial_shape, bool))
    f, solid = jax_shard_state(mesh, f0, solid)
    out = []
    for _ in range(n_chunks):
        f = chunk(f, solid)
        out.append(np.asarray(jax.device_get(f)))
    return out, chunk


def _port_chunks(problem, mesh_shape, chunk_len, n_chunks, f0,
                 backend="jax"):
    mesh = cpu_mesh(mesh_shape)
    chunk = sharded_step.make_chunk_fn(problem, mesh, chunk_len,
                                       backend=backend)
    shards = convert.split_state(f0, problem, mesh)
    out = []
    for _ in range(n_chunks):
        shards = chunk(shards)
        out.append(convert.gather_state(shards))
    return out, chunk


# every family on (2,2) and on one other mesh, the sphere on all four
PLAIN = [("sphere", m) for m in MESHES] + [
    ("bounce_back_trt", (2, 2)), ("bounce_back_trt", (1, 2)),
    ("bouzidi", (2, 2)), ("bouzidi", (2, 1)),
    ("duct_mrt", (2, 2)), ("duct_mrt", (4, 2)),
    ("taylor_green", (2, 2)), ("taylor_green", (1, 2)),
    ("kolmogorov", (2, 2)), ("kolmogorov", (2, 1)),
    ("sphere_d3q27", (2, 2)), ("duct_d3q27", (1, 2)),
    ("box_d3q27", (4, 2))]


def _tpulbm_rolled(params, n_steps, n_chunks, f0):
    """tpulbm's one-device step (make_step_rolled) chunk by chunk."""
    from tpulbm.ops.step_jax import make_step_rolled
    step = jax.jit(make_step_rolled(jax_problem(params)))
    f, out = f0, []
    for _ in range(n_chunks):
        for _ in range(n_steps):
            f = step(f)
        out.append(np.asarray(f))
    return out


@pytest.mark.parametrize("family,mesh_shape", PLAIN)
def test_plain_3d_mesh_chunk_matches_tpulbm(family, mesh_shape):
    params = SimulationParams(precision="f64", **FAMILIES[family])
    f0 = perturbed(jax_problem(params))
    want, _ = _tpulbm_chunks(params, mesh_shape, 3, 2, f0)
    if family == "duct_d3q27":
        # tpulbm's padded tier departs from its own one-device step on the
        # D3Q27 duct (a corner population along the edges where a y wall
        # meets a z wall, ~1e-6), on every mesh, (1,1) included; the
        # port's mesh keeps one device's step (ROADMAP Queue 3)
        rolled = _tpulbm_rolled(params, 3, 2, f0)
        edge = np.abs(want[0] - rolled[0]) > 1e-12
        assert edge.any() and not edge[:, :, 1:-1, :].any()
        want = rolled
    got, chunk = _port_chunks(port_problem(params), mesh_shape, 3, 2, f0)
    assert chunk.mode == "plain"
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-15,
                                   err_msg=f"{family} {mesh_shape} chunk {k}")


# ---- the kernel module on a mesh against one device ---------------------

@pytest.mark.parametrize("family", sorted(FAMILIES) + ["bouzidi_spinning"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (1, 4)])
def test_kernel_module_3d_mesh_equals_one_device(family, mesh_shape):
    kw = FAMILIES["bouzidi" if family == "bouzidi_spinning" else family]
    problem = port_problem(SimulationParams(precision="f32", **kw))
    if family == "bouzidi_spinning":
        problem = spinning(problem)
    f0 = perturbed(problem)
    # 7 steps: tpulbm's depth-3 split [(3, 1), (2, 2)], both N-step
    # depths and their rings in one chunk (depth 1 under Bouzidi with x
    # rings)
    one = stepper.make_chunk_fn(problem, "cpu", 7)
    want = one(torch.as_tensor(f0.copy())).numpy()
    got, chunk = _port_chunks(problem, mesh_shape, 7, 1, f0,
                              backend="pallas")
    x_cut = mesh_shape[1] > 1
    bz_x = problem.obstacle_bc == "bouzidi" and x_cut
    assert chunk.mode == ("tiled" if x_cut else "rows")
    assert chunk.plan == ([(1, 7)] if bz_x else [(3, 1), (2, 2)])
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("family,mesh_shape,depth", [
    ("sphere", (2, 2), 3), ("bouzidi", (2, 1), 2),
    ("kolmogorov", (1, 2), 1), ("duct_mrt", (2, 2), 2)])
def test_equilibrium_rings_miss_the_perturbed_state(family, mesh_shape,
                                                    depth):
    problem = port_problem(SimulationParams(precision="f32",
                                            **FAMILIES[family]))
    mesh = cpu_mesh(mesh_shape)
    f0 = torch.as_tensor(perturbed(problem))
    blocks = sharded_step.split(mesh, f0)
    x_rings = mesh_shape[1] > 1
    rings = halo.exchange(blocks, eq_ring=problem.ghost_ring_values(),
                          depth=depth, periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, x_rings=x_rings)
    geo = sharded_step.kernel_shards(problem, mesh, depth, x_rings)
    consts = step_cuda.kernel_constants(problem, 19)
    local = sharded_step.block_shape(problem, mesh)
    masks = halo.pad_mask(sharded_step._solid_grid(problem, mesh),
                          periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, depth=depth)
    eq = problem.ghost_ring_values()
    sep = 0.0
    for iy, ix in mesh.shards():
        plain = step_rings_torch.make_ring_step(
            problem, sharded_step.origin(mesh, local, iy, ix), local, depth,
            masks[iy][ix] if problem.solid is not None else None, "cpu")
        f = blocks[iy][ix]
        want = step_cuda.collide_stream_rings_3d(
            f, torch.empty_like(f), rings[iy][ix], geo[iy][ix], consts,
            depth, plain=plain)
        flat = tuple(None if r is None else halo._eq_block(eq, r, r.shape)
                     for r in rings[iy][ix])
        bad = step_cuda.collide_stream_rings_3d(
            f, torch.empty_like(f), flat, geo[iy][ix], consts, depth,
            plain=plain)
        sep = max(sep, float(((bad - want).abs()
                              / (1e-7 + 5e-6 * want.abs())).max()))
    assert sep > 100, sep


# ---- the plan -----------------------------------------------------------

PLAN_LENS = [1, 2, 3, 4, 5, 7, 139, 140]
PLAN_ENVS = {"default": {}, "no_fused2": {"TPULBM_NO_FUSED2": "1"},
             "substeps2": {"TPULBM_SUBSTEPS": "2"},
             "xhalo": {"TPULBM_FORCE_XHALO": "1"}}


@pytest.mark.parametrize("family", ["sphere", "bouzidi", "taylor_green"])
@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2), (2, 2), (4, 2)])
@pytest.mark.parametrize("env", sorted(PLAN_ENVS))
def test_3d_mesh_plan_matches_tpulbm(monkeypatch, family, mesh_shape, env):
    monkeypatch.delenv("TPULBM_FORCE_XHALO", raising=False)
    _setenv(monkeypatch, PLAN_ENVS[env])
    # 16 rows a shard: tpulbm's interpret-mode tile of 16 rows holds 4
    # halo rows at depths 2 and 3, so its TPU-only tile condition does not
    # bind
    kw = dict(FAMILIES[family], ny=16 * mesh_shape[0],
              nx=16 * mesh_shape[1] if family != "sphere" else 32)
    params = SimulationParams(precision="f32", **kw)
    problem = jax_problem(params)
    mesh = jax_mesh(mesh_shape,
                    devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    mine = port_problem(params)
    pmesh = cpu_mesh(mesh_shape)
    for n in PLAN_LENS:
        with warnings.catch_warnings():
            # tpulbm warns where it leaves its kernels for its jax tier
            warnings.simplefilter("ignore")
            ref = jax_chunk_fn(problem, mesh, n, backend="pallas")
        mode, segments = sharded_step.plan_3d(mine, pmesh, n)
        assert mode == ("tiled" if mesh_shape[1] > 1 or env == "xhalo"
                        else "rows")
        want = ref.pallas3d_depths
        if want is None:
            # by design: tpulbm leaves the box with x rings at depth 1 for
            # its jax tier (its zc scratch has no x-piece DMAs); the port
            # runs its ring build at depth 1
            assert family == "taylor_green" and mode == "tiled"
            assert segments == [(1, n)]
            continue
        assert [d for d, _ in segments] == want, (n, segments, want)


# ---- diagnostics, the Runner, checkpoints, the CLI ------------------------

@pytest.mark.parametrize("family", ["sphere", "bounce_back_trt", "bouzidi",
                                    "bouzidi_spinning", "kolmogorov"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2), (4, 1)])
def test_3d_diagnostics_on_a_mesh_equal_one_device(family, mesh_shape):
    kw = FAMILIES["bouzidi" if family == "bouzidi_spinning" else family]
    params = SimulationParams(precision="f32", probe_points=(
        (0.1, 0.1, 0.2), (0.9, 0.7, 0.6)), **kw)
    problem = port_problem(params)
    if family == "bouzidi_spinning":
        problem = spinning(problem)
    f = torch.as_tensor(perturbed(problem))
    one = sharded_step.Diagnostics(problem, cpu_mesh((1, 1)))
    mesh = cpu_mesh(mesh_shape)
    diag = sharded_step.Diagnostics(problem, mesh)
    shards = sharded_step.split(mesh, f)
    assert torch.equal(diag.force(shards), one.force([[f]]))
    if problem.solid is not None:
        assert bool((one.force([[f]]) != 0).any())
    assert torch.equal(diag.max_velocity(shards), one.max_velocity([[f]]))
    assert torch.equal(diag.probes(shards), one.probes([[f]]))
    assert float(diag.mass(shards)) == pytest.approx(float(one.mass([[f]])),
                                                     rel=1e-6)
    rho, u = diag.fields(shards)
    rho1, u1 = one.fields([[f]])
    assert torch.equal(rho, rho1) and torch.equal(u, u1)
    stats, stats1 = (sharded_step.Stats(d, torch.float32)
                     for d in (diag, one))
    for _ in range(2):
        stats.add(shards)
        stats1.add([[f]])
    for a, b in zip(stats.means(), stats1.means()):
        assert torch.equal(a, b)


def _3d_run_params(tmp, **kw):
    base = dict(FAMILIES["kolmogorov"], nx=16, ny=16, nz=8,
                num_timesteps=40, output_frequency=10, stats_from=10,
                probe_points=((0.25, 0.5, 0.5), (0.75, 0.25, 0.25)),
                enable_vtk=False, precision="f32", backend="pallas",
                output_dir=str(tmp))
    base.update(kw)
    return SimulationParams(**base)


@pytest.mark.parametrize("family", ["kolmogorov", "sphere"])
def test_runner_3d_mesh_artifacts_equal_one_device(tmp_path, family):
    extra = ({} if family == "kolmogorov" else
             dict(SPHERE, stats_from=-1, probe_points=()))
    one = Runner(port_params(_3d_run_params(tmp_path / "one", **extra)),
                 device="cpu", verbose=False).run()
    mesh = Runner(port_params(_3d_run_params(tmp_path / "mesh",
                                             mesh_shape=(2, 2), **extra)),
                  device="cpu", verbose=False).run()
    assert one.success and mesh.success
    names = (["fields3d.npz", "stats_fields.npz", "probes.csv"]
             if family == "kolmogorov" else ["fields3d.npz", "forces.csv"])
    for name in names:
        a, b = tmp_path / "one" / name, tmp_path / "mesh" / name
        if name.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    if k != "params":
                        np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        else:
            assert a.read_bytes() == b.read_bytes(), name


def test_runner_3d_mesh_matches_tpulbm(tmp_path):
    # tpulbm's probes cannot slice a sharded array: no probes here
    kw = dict(backend="jax", precision="f64", mesh_shape=(2, 2),
              probe_points=())
    params = _3d_run_params(tmp_path / "tpulbm", **kw)
    JaxRunner(params, devices=jax.devices()[:4], verbose=False).run()
    Runner(port_params(params.replace(output_dir=str(tmp_path / "port"))),
           device="cpu", verbose=False).run()
    with np.load(tmp_path / "tpulbm" / "fields3d.npz") as a, \
            np.load(tmp_path / "port" / "fields3d.npz") as b:
        for k in ("rho", "ux", "uy", "uz"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=1e-15)
    with np.load(tmp_path / "tpulbm" / "stats_fields.npz") as a, \
            np.load(tmp_path / "port" / "stats_fields.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=1e-15,
                                       err_msg=k)


@pytest.mark.parametrize("direction", ["port_to_tpulbm", "tpulbm_to_port"])
def test_3d_per_shard_checkpoint_resumes_in_the_other_package(tmp_path,
                                                              direction):
    kw = dict(backend="jax", precision="f64", mesh_shape=(2, 2),
              stats_from=-1, probe_points=())

    def run(pkg, params, **r):
        if pkg == "port":
            return Runner(port_params(params), device="cpu",
                          verbose=False).run(**r)
        return JaxRunner(params, devices=jax.devices()[:4],
                         verbose=False).run(**r)

    writer, reader = (("port", "tpulbm") if direction == "port_to_tpulbm"
                      else ("tpulbm", "port"))
    run(reader, _3d_run_params(tmp_path / "straight", **kw))
    half = _3d_run_params(tmp_path / "moved", num_timesteps=20,
                          checkpoint_every=1, **kw)
    run(writer, half)
    latest = ckpt.latest(str(tmp_path / "moved" / "checkpoints"))
    assert latest.endswith("ckpt_000000020")
    manifest = json.load(open(f"{latest}/manifest.json"))
    assert manifest["global_shape"] == [19, 8, 16, 16]
    assert sorted(manifest["files"]) == [f"shard_0_0_{y}_{x}"
                                         for y in (0, 8) for x in (0, 8)]
    assert jckpt.check_manifest(latest, half) == 20
    result = run(reader, half.replace(num_timesteps=40), resume=True)
    assert result.success and result.final_step == 40
    with np.load(tmp_path / "moved" / "fields3d.npz") as a, \
            np.load(tmp_path / "straight" / "fields3d.npz") as b:
        for k in ("rho", "ux", "uy", "uz"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-15)


def test_cli_mesh_auto_runs_a_3d_preset(tmp_path, capsys):
    from tpulbm_torch.__main__ import main
    assert main(["--cpu", "--cpu-devices", "4", "--mesh", "auto",
                 "--preset", "kolmogorov3d", "--nx", "16", "--ny", "16",
                 "--nz", "8", "--num-timesteps", "20",
                 "--output-frequency", "10", "--stats-from", "10",
                 "--no-vtk", "--output-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "Device mesh: 4×1" in out
    with np.load(tmp_path / "fields3d.npz") as data:
        assert data["ux"].shape == (8, 16, 16)
        assert np.isfinite(data["ux"]).all()
    assert (tmp_path / "stats_fields.npz").exists()


# the thermal problems and multiphase run on a mesh since their ring
# builds (item None: the Runner builds its mesh); the Bouzidi obstacle on
# D3Q27 stays refused (item 16)
@pytest.mark.parametrize("override,item", [
    (dict(problem="rayleigh-benard", thermal_tau=0.6), None),
    (dict(problem="multiphase", shan_chen_g=-5.0, tau=1.0,
          inlet_velocity=0.0), None),
    (dict(problem="cylinder3d", nz=8, lattice3d="d3q27",
          obstacle_bc="bouzidi"), "item 16")])
def test_what_stays_refused_on_a_3d_mesh_names_its_item(tmp_path, override,
                                                         item):
    params = SimulationParams(nx=32, ny=16, mesh_shape=(2, 2),
                              output_dir=str(tmp_path), **override)
    if item is None:
        assert Runner(params, device="cpu").mesh.shape == (2, 2)
        return
    with pytest.raises(NotImplementedError, match=item):
        Runner(params, device="cpu")


def test_3d_ring_wrapper_checks_its_inputs():
    problem = port_problem(SimulationParams(precision="f32", **SPHERE))
    mesh = cpu_mesh((2, 2))
    geo = sharded_step.kernel_shards(problem, mesh, 2, True)
    consts = step_cuda.kernel_constants(problem, 19)
    f = torch.zeros((19, 8, 8, 16))
    rings = halo.exchange([[f] * 2] * 2, eq_ring=problem.ghost_ring_values(),
                          depth=2, periodic_x=False, x_rings=True)[0][0]
    with pytest.raises(ValueError, match="depth 3"):
        step_cuda.collide_stream_rings_3d(f, torch.empty_like(f), rings,
                                          geo[0][0], consts, 3)
    with pytest.raises(ValueError, match="ring rl"):
        step_cuda.collide_stream_rings_3d(f, torch.empty_like(f),
                                          rings[:2] + (None, rings[3]),
                                          geo[0][0], consts, 2)
    with pytest.raises(ValueError, match="shard's block"):
        g = torch.zeros((19, 8, 8, 8))
        step_cuda.collide_stream_rings_3d(g, torch.empty_like(g), rings,
                                          geo[0][0], consts, 2)
    with pytest.raises(ValueError, match="plain step"):
        step_cuda.collide_stream_rings_3d(f, torch.empty_like(f), rings,
                                          geo[0][0], consts, 2)


def test_3d_block_shapes_and_origins():
    problem = port_problem(SimulationParams(precision="f32", **SPHERE))
    mesh = cpu_mesh((2, 4))
    assert sharded_step.block_shape(problem, mesh) == (8, 8, 8)
    assert sharded_step.origin(mesh, (8, 8, 8), 1, 3) == (8, 24)
    shards, solid = sharded_step.shard_initial_state(problem, mesh)
    whole = sharded_step.gather(shards).numpy()
    np.testing.assert_array_equal(whole, problem.initial_state())
    np.testing.assert_array_equal(sharded_step.gather(solid).numpy(),
                                  problem.solid)
    table = bouzidi.table_block(
        port_problem(SimulationParams(precision="f32", **FAMILIES[
            "bouzidi"])), (0, 6, 22), (8, 12, 12))
    assert table.shape == (19, 8, 12, 12)


# ---- the kernels' Shard on the host ---------------------------------------

# A read of every cell of a shard's padded window (the block and depth
# rows and columns around it, at every plane) through csrc/d3q19_common.cuh's
# Shard::find() and locate(), built with g++ for the host: the populations
# it finds, the cells it does not find NaN.
HOST_WINDOW = r"""
#define __device__
#define __forceinline__ inline
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <vector>
#include "d3q19_common.cuh"
namespace k_ = tpulbm3d;
int main(int argc, char** argv) {
  int v[11];
  for (int i = 0; i < 11; ++i) v[i] = atoi(argv[i + 1]);
  const int nx = v[0], ny = v[1], nz = v[2], nxl = v[3], nyl = v[4],
            x0 = v[5], y0 = v[6], hx = v[7], d = v[8], q = v[9];
  const size_t nf = (size_t)q * nz * nyl * nxl,
               nrow = (size_t)q * nz * d * (nxl + 2 * hx),
               ncol = (size_t)q * nz * nyl * hx;
  std::vector<float> f(nf), rb(nrow), rt(nrow), rl(ncol + 1), rr(ncol + 1);
  FILE* fp = fopen(argv[12], "rb");
  if (fread(f.data(), 4, nf, fp) != nf || fread(rb.data(), 4, nrow, fp) != nrow ||
      fread(rt.data(), 4, nrow, fp) != nrow ||
      fread(rl.data(), 4, ncol, fp) != ncol ||
      fread(rr.data(), 4, ncol, fp) != ncol) return 1;
  fclose(fp);
  const k_::Shard sh{f.data(), rb.data(), rt.data(), rl.data(), rr.data(),
                     nullptr, nxl, nyl, nz, x0, y0, hx, d};
  const int wy = nyl + 2 * d, wx = nxl + 2 * d;
  const size_t nw = (size_t)nz * wy * wx;
  std::vector<float> out(q * nw, NAN);
  for (int z = 0; z < nz; ++z)
    for (int wyi = 0; wyi < wy; ++wyi)
      for (int wxi = 0; wxi < wx; ++wxi) {
        int gx = x0 - d + wxi, gy = y0 - d + wyi, lx, ly;
        if (!sh.find(gx, gy, nx, ny, lx, ly)) continue;
        size_t stride;
        const float* src = sh.locate(lx, ly, z, stride);
        for (int i = 0; i < q; ++i)
          out[i * nw + ((size_t)z * wy + wyi) * wx + wxi] = src[i * stride];
      }
  fp = fopen(argv[13], "wb");
  fwrite(out.data(), 4, out.size(), fp);
  fclose(fp);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_window(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' code for the host")
    tmp = tmp_path_factory.mktemp("window")
    (tmp / "window.cpp").write_text(HOST_WINDOW)
    exes = {}

    def build(domain, q):
        key = (domain, q)
        if key not in exes:
            exe = tmp / f"window_{domain}_{q}"
            defines = [f"-DTPULBM_DOMAIN={domain}", "-DTPULBM_RINGS=1"]
            if q == 27:
                defines.append("-DTPULBM_Q=27")
            subprocess.run([gxx, "-std=c++17", "-O1", *defines, "-I",
                            str(cuda_build.SOURCE_DIR),
                            str(tmp / "window.cpp"), "-o", str(exe)],
                           check=True, capture_output=True)
            exes[key] = exe
        return exes[key]

    return tmp, build


@pytest.mark.parametrize("family,mesh_shape,depth,x_rings", [
    ("sphere", (2, 2), 3, True), ("sphere", (2, 1), 2, False),
    ("duct_mrt", (2, 1), 3, False), ("duct_mrt", (1, 2), 2, True),
    ("taylor_green", (2, 2), 3, True), ("taylor_green", (4, 1), 1, False),
    ("box_d3q27", (1, 2), 2, True)])
def test_host_shard_reads_the_padded_window(host_window, family, mesh_shape,
                                            depth, x_rings):
    tmp, build = host_window
    problem = port_problem(SimulationParams(precision="f32",
                                            **FAMILIES[family]))
    exe = build(step_cuda.kernel_domain(problem), problem.lattice.Q)
    mesh = cpu_mesh(mesh_shape)
    f0 = torch.as_tensor(perturbed(problem))
    blocks = sharded_step.split(mesh, f0)
    rings = halo.exchange(blocks, eq_ring=problem.ghost_ring_values(),
                          depth=depth, periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, x_rings=x_rings)
    nz, ny, nx = problem.spatial_shape
    nzl, nyl, nxl = sharded_step.block_shape(problem, mesh)
    for iy, ix in mesh.shards():
        y0, x0 = sharded_step.origin(mesh, (nyl, nxl), iy, ix)
        rb, rt, rl, rr = rings[iy][ix]
        hx = depth if x_rings else 0
        empty = np.zeros(0, np.float32)
        np.concatenate([blocks[iy][ix].numpy().ravel(), rb.numpy().ravel(),
                        rt.numpy().ravel(),
                        empty if rl is None else rl.numpy().ravel(),
                        empty if rr is None else rr.numpy().ravel()]
                       ).tofile(tmp / "in.bin")
        subprocess.run([str(exe), *map(str, (nx, ny, nz, nxl, nyl, x0, y0,
                                             hx, depth, problem.lattice.Q,
                                             0)),
                        str(tmp / "in.bin"), str(tmp / "out.bin")],
                       check=True)
        got = np.fromfile(tmp / "out.bin", np.float32).reshape(
            (problem.lattice.Q, nz, nyl + 2 * depth, nxl + 2 * depth))
        want = step_rings_torch.assemble(
            blocks[iy][ix], rb, rt, rl, rr, depth, problem.periodic_x,
            problem.ghost_ring_values()).numpy()
        # the cells find() holds equal the assembly; the others lie
        # outside the domain (never read: the ghost rule replaces them)
        held = ~np.isnan(got[0])
        gy = y0 - depth + np.arange(nyl + 2 * depth)
        gx = x0 - depth + np.arange(nxl + 2 * depth)
        inside = (((gy >= 0) & (gy < ny)) | problem.periodic_y)[:, None] & \
            (((gx >= 0) & (gx < nx)) | problem.periodic_x)[None, :]
        np.testing.assert_array_equal(held, np.broadcast_to(inside,
                                                            held.shape))
        np.testing.assert_array_equal(got[:, held], want[:, held])


@pytest.mark.parametrize("origin,shape", [
    ((0, -3, -3), (8, 14, 22)), ((0, 5, 13), (8, 13, 21)),
    ((0, 0, 0), (8, 16, 32)), ((0, -1, 30), (8, 18, 6))])
def test_table_block_equals_a_gather_of_the_table(origin, shape):
    # a shard's padded cut of the link table (the slice where no periodic
    # axis wraps) against a gather of the whole table, -1 / 0 outside
    problem = port_problem(SimulationParams(precision="f32",
                                            **FAMILIES["bouzidi"]))
    problem = spinning(problem)
    table = bouzidi.link_tables(problem)
    idx = np.ix_(*[o + np.arange(n) for o, n in zip(origin, shape)])
    inside = np.ones(shape, bool)
    for ax, (o, n, m) in enumerate(zip(origin, shape, table.shape[1:])):
        g = o + np.arange(n)
        bshape = [1] * 3
        bshape[ax] = n
        inside &= ((g >= 0) & (g < m)).reshape(bshape)
    clipped = tuple(np.clip(i, 0, m - 1) for i, m in zip(idx,
                                                         table.shape[1:]))
    want = np.where(inside[None], table[(slice(None),) + clipped],
                    np.where(np.arange(table.shape[0]) < 19, -1.0, 0.0)
                    .astype(np.float32).reshape(-1, 1, 1, 1))
    got = bouzidi.table_block(problem, origin, shape)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
