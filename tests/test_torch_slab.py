"""The solid-slab channel against tpulbm, on the CPU: tpulbm's
fractional-wall, staircase and Couette channels (tests/test_bouzidi.py:
68-91, 112-130, 416-470), periodic along x, without y walls, the walls
solid rows 0-1 and ny-2..ny-1 at fractional q, under the equilibrium, the
bounce-back and the Bouzidi obstacle rules, the top wall still or moving.

* the link tables byte for byte against tpulbm's, the library (the SLAB
  bit of the channel domain) and the kernel mask's link bits;
* the plain step against tpulbm's make_step_rolled in f64 at 1e-12 under
  bounce-back and the equilibrium pin (Bouzidi and Couette:
  tests/test_torch_bouzidi.py), the plain mesh chunk against tpulbm's
  backend="jax" mesh chunk on (1,1), (2,1), (2,2);
* the kernel module (its CPU path) against tpulbm's jax tier at the
  one-device depth N = 4 (its Pallas rows 1-2 in interpret mode:
  tests/test_torch_slab_d3q27_pallas.py), the depth choice (N = 4 at
  chunks of 280 and 140), the mesh plan (N = 4 on (2,1), depth 1 where x
  is cut) and the mesh chunk against one device;
* the cut-link force against tpulbm's; checkpoints both ways;
* both D2Q9 sources built with g++ for the host against a fake CUDA
  runtime (test_torch_mesh_thermal.py's FAKE_RUNTIME; the 3-D tests reuse
  it): the slab's builds one
  step against the plain step from a ±10% perturbed state, N = 2-4
  bitwise against N 1-step launches, the ring builds bitwise one device
  on (2,1) at N = 4, (1,2) and (2,2) at depth 1, a staircase table (every
  q at 1/2) and the equilibrium library off by many tolerances.
"""
import ctypes
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from tpulbm.ops import bouzidi as jbz
from tpulbm.ops import forces as jforces
from tpulbm.parallel.mesh import make_mesh as jax_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state as jax_shard_state
from tpulbm.utils import checkpoint as jckpt
from tpulbm_torch import convert
from tpulbm_torch.ops import bouzidi, forces, step_cuda, step_rings_torch
from tpulbm_torch.parallel import halo, sharded_step
from tpulbm_torch.stepper import make_chunk_fn
from tpulbm_torch.utils import checkpoint as ckpt
from tpulbm_torch.utils import cuda_build
from test_torch_bouzidi import (_fractional_channel, _noisy,
                                make_step_rolled_pair)
from test_torch_mesh import cpu_mesh
from test_torch_mesh_thermal import host_library, host_source

F64_TOL = dict(rtol=1e-12, atol=0.0)
F32_TOL = dict(rtol=5e-6, atol=1e-7)
SEPARATION = 100

# (qb, qt, obstacle rule, moving top wall)
CASES = {
    "bouzidi": (0.25, 0.75, "bouzidi", False),
    "bouzidi_far": (0.9, 0.1, "bouzidi", False),
    "couette": (0.9, 0.1, "bouzidi", True),
    "bounce_back": (0.25, 0.75, "bounce_back", False),
    "equilibrium": (0.25, 0.75, "equilibrium", False),
}
LIBRARIES = {
    "bouzidi": "bgk+channel+slab+source+bouzidi",
    "bouzidi_far": "bgk+channel+slab+source+bouzidi",
    "couette": "bgk+channel+slab+bouzidi",
    "bounce_back": "bgk+channel+slab+source+bounce_back",
    "equilibrium": "bgk+channel+slab+source",
}


def slab(case, precision="f64", nx=8, ny=24, **kw):
    """(the port's Problem, tpulbm's) of a CASES entry."""
    qb, qt, bc, moving = CASES[case]
    mine, ref = _fractional_channel(qb, qt, bc, ny=ny, nx=nx, moving=moving,
                                    **kw)
    if precision != "f64":
        mine = dataclasses.replace(
            mine, params=mine.params.replace(precision=precision))
        ref = dataclasses.replace(
            ref, params=ref.params.replace(precision=precision))
    return mine, ref


# ---- the link tables, the library, the mask ---------------------------------

@pytest.mark.parametrize("case", ["bouzidi", "bouzidi_far", "couette"])
def test_slab_link_tables_match_tpulbm_bytewise(case):
    mine, ref = slab(case)
    got, want = bouzidi.link_tables(mine), jbz.link_tables(ref)
    assert got.shape == want.shape == ((18 if case == "couette" else 9),
                                       24, 8)
    assert got.tobytes() == want.tobytes()
    assert bouzidi.active_directions(mine) == jbz.active_directions(ref)
    # the cut links: rows 2 and ny-3, three directions each, every column
    links = bouzidi.link_cells(got, 9)
    assert links.sum() == 2 * 8 and links[2].all() and links[-3].all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_library_and_link_bits(case):
    mine, _ = slab(case, "f32")
    assert step_cuda.is_slab(mine)
    assert step_cuda.kernel_domain(mine) == 1
    consts = step_cuda.kernel_constants(mine)
    assert consts.library == LIBRARIES[case]
    assert consts.variant & step_cuda.SLAB
    assert "-DTPULBM_SLAB=1" in step_cuda.variant_defines(consts.variant)
    mask = step_cuda.kernel_mask(mine)
    assert ((mask & step_cuda.SOLID_BIT) != 0).tolist() == mine.solid.tolist()
    links = (mask & step_cuda.LINK_BIT) != 0
    if CASES[case][2] == "bouzidi":
        np.testing.assert_array_equal(
            links, bouzidi.link_cells(bouzidi.link_tables(mine), 9))
        assert links.sum() > 0
    else:
        assert not links.any()


def test_channel_with_walls_keeps_its_library():
    # the walled channel (no solid mask) keeps its name and bits
    from tpulbm_torch.config import SimulationParams
    from tpulbm_torch.models import make_problem
    pr = make_problem(SimulationParams(problem="poiseuille", nx=32, ny=16,
                                       body_force=(1e-5, 0.0),
                                       inlet_velocity=0.0))
    assert not step_cuda.is_slab(pr)
    consts = step_cuda.kernel_constants(pr)
    assert consts.library == "bgk+channel+source"
    assert consts.variant == 1 | step_cuda.SOURCE


# ---- the plain tier ---------------------------------------------------------

@pytest.mark.parametrize("case", ["bounce_back", "equilibrium"])
def test_plain_step_matches_jax_rolled_f64(case):
    mine, ref = slab(case)
    f = _noisy(ref)
    got, want = torch.from_numpy(f), f
    step, jstep = make_step_rolled_pair(mine, ref)
    for _ in range(3):
        got = step(got)
        want = np.asarray(jstep(want))
    np.testing.assert_allclose(got.numpy(), want, **F64_TOL)


@pytest.mark.parametrize("case,shape", [
    ("bouzidi", (1, 1)), ("bouzidi", (2, 1)), ("bouzidi", (2, 2)),
    ("couette", (2, 2)), ("bounce_back", (2, 1))])
def test_plain_mesh_chunk_matches_tpulbm_f64(case, shape):
    mine, ref = slab(case, nx=16)
    f0 = _noisy(ref)
    mesh = jax_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
    chunk = jax_chunk_fn(ref, mesh, 6, backend="jax")
    s, solid = jax_shard_state(mesh, f0, ref.solid)
    want = np.asarray(jax.device_get(chunk(s, solid)))
    port = sharded_step.make_chunk_fn(mine, cpu_mesh(shape), 6,
                                      backend="jax")
    got = convert.gather_state(port(convert.split_state(
        f0, mine, cpu_mesh(shape))))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


# ---- the kernel module on the CPU -------------------------------------------

@pytest.mark.parametrize("case", ["bouzidi", "couette", "bounce_back"])
def test_kernel_module_matches_tpulbm_jax_tier(case):
    # the one-device depth (N = 4 at 12 steps) against tpulbm's jax tier in
    # f32; tpulbm's Pallas rows 1-2 in interpret mode:
    # tests/test_torch_slab_d3q27_pallas.py
    mine, ref = slab(case, "f32")
    f0 = _noisy(ref)
    mesh = jax_mesh((1, 1), devices=jax.devices()[:1])
    chunk = jax_chunk_fn(ref, mesh, 12, backend="jax")
    s, solid = jax_shard_state(mesh, f0, ref.solid)
    want = np.asarray(jax.device_get(chunk(s, solid)))
    port = make_chunk_fn(mine, "cpu", 12)
    assert port.plan == [(4, 3)]
    got = port(torch.from_numpy(f0))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("chunk_len,plan", [
    (280, [(4, 70)]), (140, [(4, 35)]), (139, [(1, 139)]), (1, [(1, 1)])])
def test_one_device_depth_is_the_2d_choice(chunk_len, plan):
    mine, _ = slab("bouzidi", "f32")
    assert make_chunk_fn(mine, "cpu", chunk_len).plan == plan


@pytest.mark.parametrize("shape,mode,depth", [
    ((2, 1), "rows", 4), ((1, 2), "tiled", 1), ((2, 2), "tiled", 1)])
@pytest.mark.parametrize("case", ["bouzidi", "bounce_back"])
def test_mesh_plan_and_chunk_match_one_device(monkeypatch, case, shape,
                                              mode, depth):
    # tpulbm's dispatch for the obstacle rules: Bouzidi at depth 1 where x
    # is cut (step_pallas_tiled.py:137-142), bounce-back blocked there too
    for k in ("TPULBM_HALO_OVERLAP", "TPULBM_SUBSTEPS", "TPULBM_NO_FUSED2",
              "TPULBM_FORCE_TILED"):
        monkeypatch.delenv(k, raising=False)
    mine, _ = slab(case, "f32", nx=16)
    mesh = cpu_mesh(shape)
    want_depth = depth if case == "bouzidi" else 4
    assert sharded_step.plan(mine, mesh, 12) == (mode, want_depth)
    f0 = torch.from_numpy(_noisy(mine))
    want = make_chunk_fn(mine, "cpu", 12)(f0.clone())
    chunk = sharded_step.make_chunk_fn(mine, mesh, 12)
    got = sharded_step.gather(chunk(sharded_step.split(mesh, f0)))
    torch.testing.assert_close(got, want, **F32_TOL)
    diag = sharded_step.Diagnostics(mine, mesh)
    torch.testing.assert_close(diag.force(sharded_step.split(mesh, want)),
                               forces.forces_fn(mine, "cpu")(want),
                               rtol=1e-12, atol=1e-15)


# ---- the force, checkpoints -------------------------------------------------

@pytest.mark.parametrize("case", ["bouzidi", "couette", "bounce_back"])
def test_slab_force_matches_tpulbm(case):
    mine, ref = slab(case)
    f = _noisy(ref)
    fn = jforces.forces_fn(ref)
    want = np.asarray(jax.jit(fn)(f, jbz.link_tables(ref))
                      if CASES[case][2] == "bouzidi"
                      else jax.jit(fn)(f, ref.solid))
    got = forces.forces_fn(mine, "cpu")(torch.from_numpy(f))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("direction", ["port_to_tpulbm", "tpulbm_to_port"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, direction):
    # 6 steps, a checkpoint, 6 more in the other package: the straight
    # 12 steps of the reader's own step
    mine, ref = slab("couette")
    step, jstep = make_step_rolled_pair(mine, ref)
    f0 = _noisy(ref)

    def port(f, n):
        f = torch.from_numpy(f)
        for _ in range(n):
            f = step(f)
        return convert.state_to_numpy(f)

    def tpulbm(f, n):
        for _ in range(n):
            f = jstep(f)
        return np.asarray(f)

    if direction == "port_to_tpulbm":
        path = ckpt.save(str(tmp_path), 6, port(f0, 6), mine.params)
        t, f = jckpt.load(path, ref.params)
        got, want = tpulbm(f, 6), tpulbm(f0, 12)
    else:
        path = jckpt.save(str(tmp_path), 6, tpulbm(f0, 6), ref.params)
        t, f = ckpt.load(path, mine.params)
        got = port(convert.state_to_numpy(convert.state_from_numpy(
            f, mine, "cpu")), 6)
        want = port(f0, 12)
    assert t == 6
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


# ---- the kernels on the host ------------------------------------------------

@pytest.fixture(scope="module")
def host_build():
    """build(source, defines) -> the ctypes library of a csrc/ kernel
    source built for the host with g++ against the fake CUDA runtime
    (tests/test_torch_mesh_thermal.py: FAKE_RUNTIME, once a session)."""
    def build(source: str, defines: tuple = ()) -> ctypes.CDLL:
        return host_library(host_source(
            (cuda_build.SOURCE_DIR / source).read_text()), tuple(defines))

    return build


def prebuild(build, libraries):
    """Start building `libraries` ((source, defines) pairs, as step_cuda
    asks cuda_build.load for them) three at a time in the background; a
    test that needs one waits on its build's lock. Returns the pool, to be
    shut down when the module's tests are done."""
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(3)
    for source, defines in dict.fromkeys(libraries):
        pool.submit(build, source, defines)
    return pool


_LIBRARIES = ("_library", "_blocked_library", "_rings_library",
              "_rings_blocked_library", "_library_3d", "_blocked_library_3d",
              "_rings_library_3d", "_rings_blocked_library_3d")


@pytest.fixture
def host_kernels(host_build, monkeypatch):
    """step_cuda's libraries bound (with their mode, variant and lattice
    checks) to the host builds for the test's length."""
    def clear():
        for name in _LIBRARIES:
            getattr(step_cuda, name).cache_clear()

    clear()
    monkeypatch.setattr(step_cuda.cuda_build, "load",
                        lambda source, defines=(): types.SimpleNamespace(
                            lib=host_build(source, defines)))
    yield host_build
    clear()


# (dimensions, N > 1, rings) -> step_cuda's library and its launcher
_LAUNCHERS = {
    (2, False, False): ("_library", "tpulbm_d2q9_step"),
    (2, True, False): ("_blocked_library", "tpulbm_d2q9_step_blocked"),
    (2, False, True): ("_rings_library", "tpulbm_d2q9_step_rings"),
    (2, True, True): ("_rings_blocked_library",
                      "tpulbm_d2q9_step_blocked_rings"),
    (3, False, False): ("_library_3d", "tpulbm_d3q19_step"),
    (3, True, False): ("_blocked_library_3d", "tpulbm_d3q19_step_blocked"),
    (3, False, True): ("_rings_library_3d", "tpulbm_d3q19_step_rings"),
    (3, True, True): ("_rings_blocked_library_3d",
                      "tpulbm_d3q19_step_blocked_rings"),
}


def launcher(consts, dims: int, n_sub: int, rings: bool):
    name, fn = _LAUNCHERS[dims, n_sub > 1, rings]
    return getattr(getattr(step_cuda, name)(consts.mode, consts.variant), fn)


def host_step(problem, f, n_sub=1, consts=None, links=None):
    """One launch of `problem`'s host-built kernel at depth n_sub from f
    (the link table `links`, default the problem's)."""
    dims = problem.lattice.D
    consts = consts or step_cuda.kernel_constants(problem, 9 if dims == 2
                                                  else 19)
    mask = torch.as_tensor(step_cuda.kernel_mask(problem))
    if links is None and consts.variant & step_cuda.BOUZIDI:
        links = bouzidi.device_table(problem, "cpu")
    out = torch.empty_like(f)
    assert launcher(consts, dims, n_sub, False)(*step_cuda.launch_args(
        f, out, mask, consts, n_sub, links)) == 0
    return out


def host_ring_launch(problem, f, shape, depth, x_rings):
    """One launch of every shard of the host-built ring kernel at `depth`:
    (the gathered state, the largest difference from a shard's plain ring
    step, the smallest from the launch fed rings of the frozen
    equilibrium)."""
    dims = problem.lattice.D
    consts = step_cuda.kernel_constants(problem, 9 if dims == 2 else 19)
    mesh = cpu_mesh(shape)
    local = sharded_step.block_shape(problem, mesh)
    geo = sharded_step.kernel_shards(problem, mesh, depth, x_rings)
    masks = halo.pad_mask(sharded_step._solid_grid(problem, mesh),
                          periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, depth=depth)
    blocks = sharded_step.split(mesh, f)
    rings = halo.exchange(blocks, eq_ring=problem.ghost_ring_values(),
                          depth=depth, periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, x_rings=x_rings)
    eq = torch.as_tensor(problem.ghost_ring_values(), dtype=f.dtype)
    eq = eq.reshape((-1,) + (1,) * (f.dim() - 1))
    fn = launcher(consts, dims, depth, True)
    outs = [[torch.empty_like(b) for b in row] for row in blocks]
    plain_err, eq_off = 0.0, np.inf
    rows = (0, local[-2]) if dims == 2 else (0, 0)
    for iy, ix in mesh.shards():
        shard, b, r = geo[iy][ix], blocks[iy][ix], rings[iy][ix]
        step_cuda.check_shard(b, outs[iy][ix], r, shard, depth,
                              (0, local[-2]))
        assert fn(*step_cuda.ring_launch_args(b, outs[iy][ix], r, shard,
                                              consts, depth, rows)) == 0
        plain = step_rings_torch.make_ring_step(
            problem, shard.origin, local, depth, masks[iy][ix], "cpu")(b, *r)
        plain_err = max(plain_err,
                        float((outs[iy][ix] - plain).abs().max()))
        flat = tuple(None if x is None else eq.expand(x.shape).contiguous()
                     for x in r)
        off = torch.empty_like(b)
        assert fn(*step_cuda.ring_launch_args(b, off, flat, shard, consts,
                                              depth, rows)) == 0
        eq_off = min(eq_off, float((off - plain).abs().max()))
    return sharded_step.gather(outs), plain_err, eq_off


def separation(got, want, tol=F32_TOL) -> float:
    """By how many one-step tolerances `got` misses `want` at worst."""
    return float(((got - want).abs() / (tol["atol"] + tol["rtol"]
                                        * want.abs())).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_kernels_match_plain_and_each_other(host_kernels, case):
    # a grid wider than no tile (40 columns: the N-step window's x-halo
    # wraps past a 32-column tile)
    mine, _ = slab(case, "f32", nx=40)
    f = torch.from_numpy(_noisy(mine))
    want = step_cuda.step_torch.make_step_rolled(mine, "cpu")(f)
    one = host_step(mine, f)
    torch.testing.assert_close(one, want, **F32_TOL)
    # the obstacle domain's library of the same collision (the cylinder's
    # edge rules, no slab) misses the plain step by many tolerances
    consts = step_cuda.kernel_constants(mine)
    base = dataclasses.replace(consts, variant=0, src=())
    assert separation(host_step(mine, f, consts=base), want) > SEPARATION
    # one launch at depth N against N 1-step launches, from f
    for n in step_cuda.BLOCKED_DEPTHS:
        g = f
        for _ in range(n):
            g = host_step(mine, g)
        assert torch.equal(host_step(mine, f, n), g), n


def test_host_kernel_misses_with_a_staircase_table(host_kernels):
    # every cut link at q = 1/2 (tpulbm's staircase): the Bouzidi build fed
    # that table misses the plain step of the true table
    mine, _ = slab("bouzidi", "f32", nx=40)
    f = torch.from_numpy(_noisy(mine))
    want = step_cuda.step_torch.make_step_rolled(mine, "cpu")(f)
    table = bouzidi.device_table(mine, "cpu")
    stair = torch.where(table >= 0, torch.full_like(table, 0.5), table)
    assert int((table[:9] >= 0).sum()) == 3 * 2 * 40
    sep = separation(host_step(mine, f, links=stair), want)
    assert sep > SEPARATION, sep


@pytest.mark.parametrize("shape,depth,x_rings", [
    ((2, 1), 4, False), ((2, 1), 3, False), ((1, 2), 1, True),
    ((2, 2), 1, True), ((1, 1), 1, True)],
    ids=["rows-n4", "rows-n3", "x-cut", "2x2", "x-rings"])
@pytest.mark.parametrize("case", ["bouzidi", "couette", "bounce_back"])
def test_host_ring_builds_equal_one_device(host_kernels, case, shape, depth,
                                           x_rings):
    mine, _ = slab(case, "f32", nx=40)
    f = torch.from_numpy(_noisy(mine))
    want = host_step(mine, f, depth)
    got, plain_err, eq_off = host_ring_launch(mine, f, shape, depth,
                                              x_rings)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert plain_err <= 4e-7
    assert eq_off > 1e-4
