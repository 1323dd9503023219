"""The port's mesh of shards (tpulbm_torch/parallel/) against tpulbm's
(tpulbm/parallel/) on tpulbm's 8 virtual CPU devices, the port's shards
all on `cpu`, inputs made by numpy from a seed:

* choose_decomposition equals tpulbm's on a grid of cases;
* ring_rows, ring_cols and ring_rows_ext equal tpulbm's (run under
  shard_map) on meshes (2, 2), (1, 4) and (4, 1), periodic and not;
* the plain mesh chunk (--backend jax, tpulbm's body_jax) equals tpulbm's
  make_chunk_fn(backend="jax") in f64 at rtol 1e-12 / atol 1e-15 (the
  gate of tests/test_sharded.py) on meshes (1,1), (2,4), (8,1), (1,8) and
  (2,2), for the cylinder, the periodic channel, the bounce-back obstacle
  and the cavity, from a seeded ±10% perturbed state;
* the kernel module's CPU path on meshes (each launch mode) against the
  port's one-device chunk; the dispatch; the ring wrapper's checks and
  counts; split and gather; the Runner, the CLI and the refusals on a
  mesh.

The kernel module against tpulbm's Pallas kernels in interpret mode is in
tests/test_torch_mesh_pallas.py; checkpoints and artifacts between the
packages on meshes in tests/test_torch_mesh_resume.py.
"""
import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.parallel import halo as jhalo
from tpulbm.parallel.mesh import choose_decomposition as jax_choose
from tpulbm.parallel.mesh import make_mesh as jax_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state as jax_shard_state
from tpulbm_torch import convert, stepper
from tpulbm_torch.ops import step_cuda
from tpulbm_torch.parallel import halo, sharded_step
from tpulbm_torch.parallel.mesh import choose_decomposition, make_mesh
from test_torch_3d_blocking import _setenv
from test_torch_compat import port_params, port_problem

PLAIN_CASES = {
    "cylinder": dict(nx=48, ny=24, tau=0.6, inlet_velocity=0.05),
    "channel": dict(problem="poiseuille", nx=32, ny=16, tau=0.8,
                    inlet_velocity=0.0, body_force=(1e-4, 2e-5)),
    "bounce_back": dict(nx=48, ny=24, tau=0.6, inlet_velocity=0.05,
                        obstacle_bc="bounce_back", cylinder_x=0.5,
                        cylinder_y=0.5),
    "cavity": dict(problem="cavity", nx=24, ny=24, tau=0.6,
                   inlet_velocity=0.1, cylinder_radius=0.0),
}


def perturbed(problem, seed=0):
    """The problem's initial state with a seeded ±10% perturbation: from
    the initial state every ring holds the frozen equilibrium, so a step
    that ignored its rings would pass."""
    f = problem.initial_state()
    rng = np.random.default_rng(seed)
    return (f * (1 + 0.1 * rng.uniform(-1, 1, f.shape))).astype(f.dtype)


def cpu_mesh(shape):
    return make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 6, 8, 12, 16])
@pytest.mark.parametrize("nx,ny", [(2048, 512), (512, 2048), (4096, 2048),
                                   (48, 24), (30, 30), (7, 5)])
def test_choose_decomposition_matches_tpulbm(n_dev, nx, ny):
    try:
        want = jax_choose(n_dev, nx, ny)
    except ValueError:
        with pytest.raises(ValueError, match="no decomposition"):
            choose_decomposition(n_dev, nx, ny)
        return
    assert choose_decomposition(n_dev, nx, ny) == want


def _blocks(x, my, mx):
    """The (my, mx) per-shard blocks of a global array whose last two axes
    shard_map assembled from equal per-shard outputs."""
    a, b = x.shape[-2] // my, x.shape[-1] // mx
    return [[x[..., iy * a:(iy + 1) * a, ix * b:(ix + 1) * b]
             for ix in range(mx)] for iy in range(my)]


@pytest.mark.parametrize("fn", ["ring_rows", "ring_cols", "ring_rows_ext"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("periodic", [False, True])
def test_rings_match_tpulbm(fn, mesh_shape, periodic):
    my, mx = mesh_shape
    if fn == "ring_rows" and mx != 1:
        with pytest.raises(ValueError, match="mesh_x == 1"):
            halo.ring_rows([[torch.zeros(9, 4, 4)] * mx] * my,
                           eq_ring=np.zeros(9))
        return
    depth = 2
    rng = np.random.default_rng(1)
    f = rng.standard_normal((9, 8 * my, 8 * mx))
    eq = rng.standard_normal(9)
    mesh = jax_mesh(mesh_shape, devices=jax.devices()[:my * mx])
    spec = P(None, "y", "x")

    def body(fl):
        if fn == "ring_rows":
            return jhalo.ring_rows(fl, eq_ring=eq, mesh_shape=mesh_shape,
                                   depth=depth, periodic_y=periodic)
        rl, rr = jhalo.ring_cols(fl, eq_ring=eq, mesh_shape=mesh_shape,
                                 depth=depth, H=depth, periodic_x=periodic)
        if fn == "ring_cols":
            return rl, rr
        return jhalo.ring_rows_ext(fl, rl, rr, eq_ring=eq,
                                   mesh_shape=mesh_shape, depth=depth,
                                   periodic_y=periodic)

    want = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,),
                             out_specs=(spec, spec), check_vma=False))(f)
    want = [_blocks(np.asarray(w), my, mx) for w in want]
    shards = sharded_step.split(cpu_mesh(mesh_shape), f)
    if fn == "ring_rows":
        got = halo.ring_rows(shards, eq_ring=eq, depth=depth,
                             periodic_y=periodic)
    else:
        cols = halo.ring_cols(shards, eq_ring=eq, depth=depth,
                              periodic_x=periodic)
        got = (cols if fn == "ring_cols" else
               halo.ring_rows_ext(shards, cols, eq_ring=eq, depth=depth,
                                  periodic_y=periodic))
    for iy in range(my):
        for ix in range(mx):
            for k in range(2):
                g = got[iy][ix][k].numpy()
                assert g.flags.c_contiguous
                assert g.tobytes() == want[k][iy][ix].tobytes(), (iy, ix, k)


def _tpulbm_chunks(params, mesh_shape, chunk_len, n_chunks, f0):
    problem = jax_problem(params)
    mesh = jax_mesh(mesh_shape,
                    devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    chunk = jax_chunk_fn(problem, mesh, chunk_len, backend="jax")
    solid = (problem.solid if problem.solid is not None
             else np.zeros(problem.spatial_shape, bool))
    f, solid = jax_shard_state(mesh, f0, solid)
    out = []
    for _ in range(n_chunks):
        f = chunk(f, solid)
        out.append(np.asarray(jax.device_get(f)))
    return out


def _port_chunks(params, mesh_shape, chunk_len, n_chunks, f0,
                 backend="jax"):
    problem = port_problem(params)
    mesh = cpu_mesh(mesh_shape)
    chunk = sharded_step.make_chunk_fn(problem, mesh, chunk_len,
                                       backend=backend)
    shards = convert.split_state(f0, problem, mesh)
    out = []
    for _ in range(n_chunks):
        shards = chunk(shards)
        out.append(convert.gather_state(shards))
    return out, chunk


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 4), (8, 1), (1, 8),
                                        (2, 2)])
def test_plain_mesh_chunk_matches_tpulbm(case, mesh_shape):
    params = SimulationParams(precision="f64", **PLAIN_CASES[case])
    f0 = perturbed(jax_problem(params))
    want = _tpulbm_chunks(params, mesh_shape, 5, 2, f0)
    got, chunk = _port_chunks(params, mesh_shape, 5, 2, f0)
    assert chunk.mode == ("one-device" if mesh_shape == (1, 1) else "plain")
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-15,
                                   err_msg=f"mesh {mesh_shape} chunk {k}")


# the kernel module's CPU path (the plain ring step per shard) in each
# launch mode, against the port's one-device chunk: the same arithmetic,
# up to the order of PyTorch's sums over the planes on blocks of another
# shape (a float32 rounding a step, 12 steps: rtol 1e-5 / atol 1e-6)
MODE_CASES = [
    ((2, 2), {}, "tiled", 3),
    ((2, 2), {"TPULBM_SUBSTEPS": "2"}, "tiled", 2),
    ((1, 2), {"TPULBM_NO_FUSED2": "1"}, "tiled", 1),
    ((2, 1), {}, "rows", 3),
    ((2, 1), {"TPULBM_SUBSTEPS": "2"}, "rows", 2),
    ((2, 1), {"TPULBM_NO_FUSED2": "1"}, "rows", 1),
    ((2, 1), {"TPULBM_HALO_OVERLAP": "1"}, "overlap", 3),
    ((2, 1), {"TPULBM_HALO_OVERLAP": "1", "TPULBM_NO_FUSED2": "1"},
     "overlap", 1),
    ((1, 1), {"TPULBM_HALO_OVERLAP": "1"}, "overlap", 3),
    ((1, 1), {"TPULBM_FORCE_TILED": "1"}, "tiled", 3),
    ((1, 1), {}, "one-device", 3),
]


@pytest.mark.parametrize("case", ["cylinder", "bounce_back", "channel",
                                  "cavity"])
@pytest.mark.parametrize("mesh_shape,env,mode,depth", MODE_CASES)
def test_kernel_module_on_a_mesh_matches_one_device(monkeypatch, case,
                                                    mesh_shape, env, mode,
                                                    depth):
    _setenv(monkeypatch, env)
    kw = dict(PLAIN_CASES[case], nx=48, ny=48)
    if case == "bounce_back":
        kw["zou_he_corners"] = "clean"
        kw["collision"] = "trt"
    params = SimulationParams(precision="f32", **kw)
    f0 = perturbed(jax_problem(params))
    got, chunk = _port_chunks(params, mesh_shape, 6, 2, f0,
                              backend="pallas")
    assert (chunk.mode, chunk.substeps) == (mode, depth)
    one = stepper.make_chunk_fn(port_problem(params), "cpu", 6)
    g = torch.from_numpy(f0.copy())
    for k in range(2):
        g = one(g)
        np.testing.assert_allclose(got[k], g.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"chunk {k}")


def test_ring_step_reads_its_rings():
    """From a perturbed state, rings of the frozen equilibrium in place of
    the neighbours' data give another step."""
    params = port_params(SimulationParams(precision="f32",
                                          **PLAIN_CASES["cylinder"]))
    problem = port_problem(params)
    mesh = cpu_mesh((2, 2))
    shards = convert.split_state(perturbed(problem), problem, mesh)
    chunk = sharded_step.make_chunk_fn(problem, mesh, 1)
    good = convert.gather_state(chunk(shards))
    orig = halo.exchange

    def eq_rings(cur, **kw):
        rings = orig(cur, **kw)
        eq = problem.ghost_ring_values()
        return [[tuple(None if r is None else halo._eq_block(eq, r, r.shape)
                       for r in rs) for rs in row] for row in rings]

    halo.exchange = eq_rings
    try:
        bad = convert.gather_state(chunk(convert.split_state(
            perturbed(problem), problem, mesh)))
    finally:
        halo.exchange = orig
    assert np.abs(bad - good).max() > 1e-3


DIAG_CASES = {
    "cylinder": PLAIN_CASES["cylinder"],
    "bounce_back": PLAIN_CASES["bounce_back"],
    "cavity": PLAIN_CASES["cavity"],
    "thermal": dict(problem="rayleigh-benard", nx=32, ny=16, tau=0.55,
                    thermal_tau=0.5704, rayleigh=5000.0, inlet_velocity=0.0,
                    cylinder_radius=0.0, periodic_x=True),
    "multiphase": dict(problem="multiphase", nx=32, ny=16,
                       shan_chen_g=-5.0, tau=1.0, inlet_velocity=0.0),
    "sphere": dict(problem="cylinder3d", nx=16, ny=12, nz=12),
}


@pytest.mark.parametrize("case", list(DIAG_CASES))
def test_one_shard_diagnostics_are_the_one_device_functions(case):
    """The Runner holds a grid of blocks on every mesh: on (1,1) its
    diagnostics are the one-device functions' results, bit for bit."""
    from tpulbm_torch import physics
    from tpulbm_torch.ops import diagnostics, forces
    problem = port_problem(SimulationParams(**DIAG_CASES[case]))
    f = torch.from_numpy(perturbed(problem))
    d = sharded_step.Diagnostics(problem, cpu_mesh((1, 1)))
    grid = [[f]]
    if problem.solid is not None:
        assert torch.equal(d.force(grid), forces.forces_fn(problem, "cpu")(f))
    else:
        assert not d.force(grid).any()
    assert torch.equal(d.max_velocity(grid),
                       diagnostics.max_velocity_fn(problem, "cpu")(f))
    assert torch.equal(d.stable(grid), physics.is_stable(f))
    assert torch.equal(d.mass(grid), torch.sum(f))
    for got, want in zip(d.fields(grid),
                         diagnostics.fields_fn(problem, "cpu")(f)):
        assert torch.equal(got, want)
    if problem.thermal is not None:
        assert torch.equal(d.nusselt(grid),
                           diagnostics.nusselt_fn(problem)(f))
        assert torch.equal(d.temperature(grid),
                           diagnostics.temperature_fn(problem)(f))
    else:
        assert d.temperature(grid) is None


@pytest.mark.parametrize("case", ["cylinder", "bounce_back", "cavity"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (3, 1)])
def test_mesh_diagnostics_match_one_device(case, mesh_shape):
    """Per-shard diagnostics reduced over the mesh: the force (links that
    cross a shard edge included) in f64 at 1e-12, the rest exactly."""
    from tpulbm_torch import physics
    from tpulbm_torch.ops import diagnostics, forces
    kw = dict(DIAG_CASES[case], nx=48, ny=24 if case != "cavity" else 48)
    problem = port_problem(SimulationParams(precision="f64", **kw))
    f0 = perturbed(problem)
    f = torch.from_numpy(f0)
    d = sharded_step.Diagnostics(problem, cpu_mesh(mesh_shape))
    grid = convert.split_state(f0, problem, cpu_mesh(mesh_shape))
    if problem.solid is not None:
        torch.testing.assert_close(d.force(grid),
                                   forces.forces_fn(problem, "cpu")(f),
                                   rtol=1e-12, atol=1e-15)
    assert torch.equal(d.max_velocity(grid),
                       diagnostics.max_velocity_fn(problem, "cpu")(f))
    assert bool(d.stable(grid)) and bool(physics.is_stable(f))
    torch.testing.assert_close(d.mass(grid), torch.sum(f), rtol=1e-12,
                               atol=0.0)
    for got, want in zip(d.fields(grid),
                         diagnostics.fields_fn(problem, "cpu")(f)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("env,chunk_len,local,want", [
    ({}, 140, (512, 1024), ("tiled", 4)),
    ({}, 150, (512, 1024), ("tiled", 3)),
    ({}, 5, (512, 1024), ("tiled", 1)),
    ({"TPULBM_NO_FUSED2": "1"}, 140, (512, 1024), ("tiled", 1)),
    ({"TPULBM_SUBSTEPS": "2"}, 140, (512, 1024), ("tiled", 2)),
    ({"TPULBM_SUBSTEPS": "3"}, 140, (512, 1024), ("tiled", 1)),
    ({"TPULBM_HALO_OVERLAP": "1"}, 140, (512, 1024), ("tiled", 4)),
    ({}, 4, (3, 1024), ("tiled", 2)),
    ({}, 4, (4, 1024), ("tiled", 4)),
])
def test_plan_follows_tpulbm_dispatch(monkeypatch, env, chunk_len, local,
                                      want):
    _setenv(monkeypatch, env)
    params = port_params(SimulationParams(nx=2 * local[1], ny=2 * local[0]))
    problem = port_problem(params)
    assert sharded_step.plan(problem, cpu_mesh((2, 2)), chunk_len) == want


@pytest.mark.parametrize("env,want", [
    ({}, ("rows", 4)), ({"TPULBM_HALO_OVERLAP": "1"}, ("overlap", 4)),
    ({"TPULBM_HALO_OVERLAP": "1", "TPULBM_SUBSTEPS": "4"}, ("overlap", 4)),
    ({"TPULBM_HALO_OVERLAP": "1", "TPULBM_NO_FUSED2": "1"}, ("overlap", 1)),
    ({"TPULBM_FORCE_TILED": "1"}, ("tiled", 4))])
def test_plan_on_a_mesh_that_keeps_x_whole(monkeypatch, env, want):
    _setenv(monkeypatch, env)
    problem = port_problem(SimulationParams(nx=64, ny=64))
    assert sharded_step.plan(problem, cpu_mesh((4, 1)), 8) == want
    # three ranges of N + 1 rows: 16 rows per shard hold N = 4, 12 do not
    if env == {"TPULBM_HALO_OVERLAP": "1"}:
        problem = port_problem(SimulationParams(nx=64, ny=48))
        assert sharded_step.plan(problem, cpu_mesh((4, 1)), 8) == \
            ("overlap", 2)


def test_forced_depth_without_a_kernel_raises(monkeypatch):
    # depth 5 on a mesh that cuts x would run tpulbm's x-tiled kernel,
    # which asserts n_sub <= 4; above 8, the port's cap, no kernel holds it
    _setenv(monkeypatch, {"TPULBM_SUBSTEPS": "5"})
    problem = port_problem(SimulationParams(nx=64, ny=32))
    with pytest.raises(ValueError, match=r"step_pallas_tiled\.py:133"):
        sharded_step.plan(problem, cpu_mesh((2, 2)), 10)
    assert sharded_step.plan(problem, cpu_mesh((2, 1)), 10) == ("rows", 5)
    _setenv(monkeypatch, {"TPULBM_SUBSTEPS": "9"})
    with pytest.raises(NotImplementedError, match="its cap"):
        sharded_step.plan(problem, cpu_mesh((2, 1)), 18)


def _shard(nyl=8, nxl=8, depth=2, x_rings=True, origin=(8, 8)):
    return step_cuda.Shard(
        index=(1, 1), origin=origin, local_shape=(nyl, nxl), grid=(32, 32),
        depth=depth, x_rings=x_rings,
        mask=torch.zeros(nyl + 2 * depth, nxl + 2 * depth, dtype=torch.uint8))


def _rings(nyl=8, nxl=8, depth=2):
    return (torch.zeros(9, depth, nxl + 2 * depth),
            torch.zeros(9, depth, nxl + 2 * depth),
            torch.zeros(9, nyl, depth), torch.zeros(9, nyl, depth))


@pytest.mark.parametrize("bad", ["rb_shape", "rl_missing", "mask_shape",
                                 "depth", "rows", "rt_needed", "origin",
                                 "f64", "x_whole"])
def test_ring_wrapper_rejects_bad_inputs(bad):
    f = torch.zeros(9, 8, 8)
    out = torch.empty_like(f)
    rings, shard, n_sub, rows = list(_rings()), _shard(), 2, None
    exc = ValueError
    if bad == "rb_shape":
        rings[0] = torch.zeros(9, 2, 8)
    elif bad == "rl_missing":
        rings[2] = None
    elif bad == "mask_shape":
        shard = step_cuda.Shard((1, 1), (8, 8), (8, 8), (32, 32), 2, True,
                                torch.zeros(8, 8, dtype=torch.uint8))
    elif bad == "depth":
        n_sub = 3
    elif bad == "rows":
        rows = (4, 9)
    elif bad == "rt_needed":
        rings[1], rows = None, (3, 8)
    elif bad == "origin":
        shard = _shard(origin=(28, 8))
    elif bad == "f64":
        f, out, exc = f.double(), out.double(), TypeError
    elif bad == "x_whole":
        shard = _shard(x_rings=False)
        rings[2] = rings[3] = None
        rings[0] = rings[1] = torch.zeros(9, 2, 8)
    with pytest.raises(exc):
        step_cuda.collide_stream_rings(f, out, tuple(rings), shard, None,
                                       n_sub, rows=rows, plain=lambda *a: f)


def test_ring_wrapper_counts_only_kernel_launches():
    problem = port_problem(SimulationParams(nx=48, ny=24))
    mesh = cpu_mesh((2, 2))
    step_cuda.reset_launch_counts()
    chunk = sharded_step.make_chunk_fn(problem, mesh, 4)
    shards = chunk(convert.split_state(problem.initial_state(), problem,
                                       mesh))
    assert all(bool(s.isfinite().all()) for row in shards for s in row)
    assert step_cuda.launches(step_cuda.collide_stream_rings) == \
        dict.fromkeys(step_cuda.RINGS_DEPTHS, 0)
    assert step_cuda.launches_by_shard(step_cuda.collide_stream_rings) == {}


def test_count_per_library_depth_and_shard():
    wrapper = step_cuda.collide_stream_rings
    step_cuda.reset_launch_counts()
    try:
        for shard in [(0, 0), (0, 1), (0, 1)]:
            step_cuda._count(wrapper, "bgk", 4, shard)
        step_cuda._count(wrapper, "mrt+channel", 1, (1, 0))
        assert step_cuda.launches_by_shard(wrapper) == {
            ("bgk", 4, (0, 0)): 1, ("bgk", 4, (0, 1)): 2,
            ("mrt+channel", 1, (1, 0)): 1}
        assert step_cuda.launches(wrapper) == {1: 1, 2: 0, 3: 0, 4: 3}
        assert step_cuda.launches_by_mode(wrapper)["mrt"][1] == 1
    finally:
        step_cuda.reset_launch_counts()


def test_split_and_gather_state_round_trip():
    problem = port_problem(SimulationParams(nx=48, ny=24))
    f = perturbed(problem)
    mesh = cpu_mesh((2, 4))
    shards = convert.split_state(f, problem, mesh)
    assert [[tuple(s.shape) for s in row] for row in shards] == \
        [[(9, 12, 12)] * 4] * 2
    assert shards[1][2].numpy().tobytes() == \
        np.ascontiguousarray(f[:, 12:24, 24:36]).tobytes()
    assert convert.gather_state(shards).tobytes() == f.tobytes()
    with pytest.raises(TypeError):
        convert.split_state(f.astype(np.float64), problem, mesh)


def test_mesh_defaults_to_the_cards_and_the_cpu_only_when_asked():
    from tpulbm_torch.parallel.mesh import make_mesh as port_mesh
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mesh((2, 2))
    mesh = port_mesh((2, 2), devices=["cpu"] * 4)
    assert mesh.shape == (2, 2) and mesh.device(1, 1).type == "cpu"
    with pytest.raises(ValueError, match="needs 4 devices"):
        port_mesh((2, 2), devices=["cpu"] * 3)
    assert port_mesh(None, nx=2048, ny=512, devices=["cpu"] * 8).shape == \
        jax_choose(8, 2048, 512)


# the 3-D problems (tests/test_torch_mesh3d.py), the thermal problems
# (tests/test_torch_mesh_thermal.py) and multiphase
# (tests/test_torch_mesh_multiphase.py) run on a mesh: item None, the
# Runner builds its mesh; so does the Bouzidi obstacle on D3Q27
@pytest.mark.parametrize("override", [
    dict(problem="cylinder3d", nz=16),
    dict(problem="rayleigh-benard", thermal_tau=0.6),
    dict(problem="multiphase", shan_chen_g=-5.0, tau=1.0,
         inlet_velocity=0.0),
    dict(problem="kolmogorov", nz=8),
    dict(problem="cylinder3d", nz=8, lattice3d="d3q27",
         obstacle_bc="bouzidi"),
], ids=["3d", "thermal", "multiphase", "periodic-box", "bouzidi-d3q27"])
def test_unported_problems_on_a_mesh_name_their_item(tmp_path, override):
    from tpulbm_torch.runner import Runner
    params = SimulationParams(nx=32, ny=16, mesh_shape=(2, 1),
                              output_dir=str(tmp_path), **override)
    assert Runner(params, device="cpu").mesh.shape == (2, 1)


def test_runner_on_a_mesh_without_a_card_raises(tmp_path):
    from tpulbm_torch.runner import Runner
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    params = SimulationParams(nx=32, ny=16, mesh_shape=(2, 1),
                              output_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        Runner(params)


def test_cli_mesh_on_host_shards(tmp_path, capsys):
    from tpulbm_torch.__main__ import main
    cli = ["--cpu", "--nx", "48", "--ny", "24", "--num-timesteps", "40",
           "--output-frequency", "20", "--no-vtk", "--output-dir"]
    assert main(cli + [str(tmp_path / "auto"), "--mesh", "auto",
                       "--cpu-devices", "8"]) == 0
    shape = jax_choose(8, 48, 24)
    assert f"Device mesh: {shape[0]}×{shape[1]}" in capsys.readouterr().out
    assert main(cli + [str(tmp_path / "one")]) == 0
    # the raw forces (columns 1-2): the coefficients divide by q ~ 2.5e-6
    for name, cols in (("forces.csv", slice(1, 3)),
                       ("velocity_field.csv", slice(1, None))):
        got = np.loadtxt(tmp_path / "auto" / name, delimiter=",",
                         skiprows=1)
        want = np.loadtxt(tmp_path / "one" / name, delimiter=",",
                          skiprows=1)
        np.testing.assert_allclose(got[..., cols], want[..., cols],
                                   rtol=1e-4, atol=5e-6)
    with pytest.raises(ValueError, match="needs --cpu"):
        main(["--cpu-devices", "2", "--output-dir", str(tmp_path)])


def test_profile_counts_the_host_runtime_calls(tmp_path):
    """profile_run reads where the host waits for the card: each CUDA
    runtime call's host time and count, beside the device groups."""
    import json
    from tpulbm_torch.utils.profile_run import device_breakdown
    events = [("kernel", "void (anonymous namespace)::d2q9_march_kernel<4, "
               "false>(float const*)", 0, 50),
              ("kernel", "_ZN12_GLOBAL__N_117d2q9_march_kernelILi1ELb0EEEvPKf",
               50, 20),
              ("cuda_runtime", "cudaMemcpyAsync", 10, 30),
              ("cuda_runtime", "cudaMemcpyAsync", 60, 10),
              ("cuda_runtime", "cudaLaunchKernel", 0, 5),
              ("cuda_driver", "cuLaunchKernel", 70, 4),
              ("cpu_op", "aten::copy_", 10, 40)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": ts, "dur": d}
        for c, n, ts, d in events]}))
    out = device_breakdown(str(path))
    assert out["runtime"] == {
        "cudaMemcpyAsync": {"ms": 0.04, "count": 2},
        "cudaLaunchKernel": {"ms": 0.005, "count": 1},
        "cuLaunchKernel": {"ms": 0.004, "count": 1}}
    assert out["groups"] == {"d2q9 N-step": {"ms": 0.05, "count": 1},
                             "d2q9 1-step": {"ms": 0.02, "count": 1}}
