"""The 1-step D3Q19 kernel's z-march (csrc/step_d3q19.cu) built for the
host with g++ against the fake CUDA runtime (tests/test_torch_mesh_thermal.py:
FAKE_RUNTIME, each CUDA thread a fiber, NaN-filled shared memory; cp.async
a copy at its issue; a card of 2 SMs, one resident block each), from a
seeded ±10% perturbed state.

* the anchor: one N=2 and one N=3 launch of the N-step kernel
  (csrc/step_d3q19_blocked.cu) equal 2 and 3 launches of the 1-step kernel
  bit for bit, both built with the same defines: the D3Q19 sphere, MRT,
  the power law, the duct (periodic x), the box with the z force (y and z
  wrap across tiles and marches), D3Q27, the Bouzidi sphere on both sets
  and spinning (its link cells counted);
* the march's knobs as -D defines equal the default build bit for bit:
  marches of 1, 2 and 3 planes and one longer than nz (-DTPULBM_ZCHUNK), a
  tile of 4 rows (-DTPULBM_TILE_Y, 128 threads), the pull two planes
  behind the collisions on D3Q19 (-DTPULBM_LAG=2, one barrier a plane)
  and one behind on D3Q27 (-DTPULBM_LAG=1);
* grids with a ragged left tile (nx = 20, 37 or 40 against 32-column
  tiles; at 37 no tile row is 16-byte aligned: every copy 4 bytes), ny
  not a multiple of the tile height (14 against 8) and nz not a multiple of
  the march (marches of 8 + 3 planes, 10 + 9 in the box);
* the ring builds at depth 1 against one device on (2,1), (1,2) and (2,2)
  with x rings, the Bouzidi sphere and the forced box on (2,2) among them,
  and a box on (2,1) whose x wraps inside the block across a tile-row
  chunk;
* the launch shape: the march's length from the grid and the resident
  blocks (two waves, 8 to 16 planes).
"""
import types
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from tpulbm_torch.config import SimulationParams
from tpulbm_torch.models import make_problem
from tpulbm_torch.ops import bouzidi, step_cuda
from tpulbm_torch.parallel import halo, sharded_step
from test_torch_bouzidi_d3q27 import spinning
from test_torch_mesh import cpu_mesh, perturbed
from test_torch_slab import host_build  # noqa: F401

SPHERE = dict(problem="cylinder3d", nx=40, ny=14, nz=11, tau=0.6,
              inlet_velocity=0.05, cylinder_radius=0.2)
BOX = dict(problem="kolmogorov", nx=20, ny=14, nz=19, tau=0.8,
           inlet_velocity=0.05, kolmogorov_n=2, periodic_x=True,
           cylinder_radius=0.0)
CASES = {
    "sphere": SPHERE,
    "mrt": dict(SPHERE, nx=20, collision="mrt"),
    "power_law": dict(SPHERE, nx=20, power_law_n=0.7, power_law_k=0.02),
    "duct": dict(problem="poiseuille", nx=37, ny=14, nz=9, tau=0.8,
                 inlet_velocity=0.0, body_force=(1e-4, 0.0, 1e-5)),
    "box_force": BOX,
    # on (2, 1) the block spans every column and x wraps inside it: the
    # ragged tile's chunk x = -2 .. 1 holds x = 20, 21, 0, 1 (not one copy)
    "box_wrap": dict(BOX, nx=22, ny=28, nz=9),
    "d3q27": dict(SPHERE, nx=20, lattice3d="d3q27"),
    "bouzidi": dict(SPHERE, cylinder_radius=0.23, obstacle_bc="bouzidi"),
    "bouzidi_d3q27": dict(SPHERE, nx=20, cylinder_radius=0.23,
                          obstacle_bc="bouzidi", lattice3d="d3q27"),
    "spinning": dict(SPHERE, nx=20, cylinder_radius=0.23,
                     obstacle_bc="bouzidi"),
}
KNOBS = {
    "default": (),
    "march1": ("-DTPULBM_ZCHUNK=1",),
    "march2": ("-DTPULBM_ZCHUNK=2",),
    "march3": ("-DTPULBM_ZCHUNK=3",),
    "march_long": ("-DTPULBM_ZCHUNK=40",),
    "rows4": ("-DTPULBM_TILE_Y=4",),
    "lag2": ("-DTPULBM_LAG=2",),
    "lag1": ("-DTPULBM_LAG=1",),
}
KNOB_CASES = ([("box_force", k) for k in KNOBS
               if k not in ("default", "lag1")]
              + [("bouzidi", k) for k in ("march2", "rows4", "lag2")]
              + [("sphere", k) for k in ("march3", "lag2")]
              + [("d3q27", k) for k in ("march3", "lag1")]
              + [("bouzidi_d3q27", "lag1")])
RING_CASES = [("sphere", (2, 1)), ("sphere", (1, 2)), ("sphere", (2, 2)),
              ("bouzidi", (2, 2)), ("box_force", (2, 2)),
              ("box_wrap", (2, 1))]


def _problem(case):
    p = make_problem(SimulationParams(precision="f32", **CASES[case]))
    return spinning(p) if case == "spinning" else p


def _defines(problem, variant=0):
    c = step_cuda.kernel_constants(problem, 19)
    return step_cuda.build_defines(c.mode, c.variant | variant)


@pytest.fixture(scope="module", autouse=True)
def _prebuilt(host_build):
    """The module's host libraries, built six at a time in the background
    while its first tests run."""
    libs = []
    for case in CASES:
        d = _defines(_problem(case))
        libs += [("step_d3q19.cu", d), ("step_d3q19_blocked.cu", d)]
    for case, knobs in KNOB_CASES:
        libs.append(("step_d3q19.cu",
                     _defines(_problem(case)) + KNOBS[knobs]))
    for case, _ in RING_CASES:
        libs.append(("step_d3q19.cu",
                     _defines(_problem(case), step_cuda.RINGS)))
    pool = ThreadPoolExecutor(6)
    for source, defines in dict.fromkeys(libs):
        pool.submit(host_build, source, defines)
    yield
    pool.shutdown(cancel_futures=True)


@pytest.fixture
def zmarch(host_build, monkeypatch):
    """set(knobs): step_cuda's libraries bound to host builds whose 1-step
    3-D source takes the knobs' defines."""
    names = ("_library_3d", "_blocked_library_3d", "_rings_library_3d")

    def clear():
        for name in names:
            getattr(step_cuda, name).cache_clear()

    def set_knobs(knobs):
        clear()

        def load(source, defines=()):
            if source == "step_d3q19.cu":
                defines = (*defines, *KNOBS[knobs])
            return types.SimpleNamespace(lib=host_build(source, defines))

        monkeypatch.setattr(step_cuda.cuda_build, "load", load)

    yield set_knobs
    clear()


def _operands(problem):
    consts = step_cuda.kernel_constants(problem, 19)
    mask = torch.as_tensor(step_cuda.kernel_mask(problem))
    links = (bouzidi.device_table(problem, "cpu")
             if consts.variant & step_cuda.BOUZIDI else None)
    return consts, mask, links


def _launch(problem, f, n_sub):
    """One launch of the host-built kernel at depth n_sub (1: the 1-step
    kernel, 2 and 3: the N-step one)."""
    consts, mask, links = _operands(problem)
    out = torch.empty_like(f)
    if n_sub == 1:
        fn = step_cuda._library_3d(consts.mode,
                                   consts.variant).tpulbm_d3q19_step
    else:
        fn = step_cuda._blocked_library_3d(
            consts.mode, consts.variant).tpulbm_d3q19_step_blocked
    assert fn(*step_cuda.launch_args(f, out, mask, consts, n_sub,
                                     links)) == 0
    return out


def _one_step_launches(problem, f, n):
    for _ in range(n):
        f = _launch(problem, f, 1)
    return f


@pytest.mark.parametrize("case", list(CASES))
def test_n_step_launch_is_n_zmarch_launches(zmarch, case):
    zmarch("default")
    problem = _problem(case)
    consts, _, links = _operands(problem)
    if links is not None:   # link cells on the set's planes, moving or not
        q = problem.lattice.Q
        assert int((links[:q] >= 0).sum()) > 0
        assert links.shape[0] == (2 * q if case == "spinning" else q)
    f = torch.from_numpy(perturbed(problem))
    for n in step_cuda.BLOCKED_DEPTHS_3D:
        got = _one_step_launches(problem, f, n)
        want = _launch(problem, f, n)
        assert torch.equal(got, want), (n, float((got - want).abs().max()))


@pytest.mark.parametrize("case,knobs", KNOB_CASES,
                         ids=[f"{c}-{k}" for c, k in KNOB_CASES])
def test_zmarch_knobs_equal_the_default_build(zmarch, case, knobs):
    problem = _problem(case)
    f = torch.from_numpy(perturbed(problem))
    zmarch("default")
    want = _one_step_launches(problem, f, 2)
    zmarch(knobs)
    consts = step_cuda.kernel_constants(problem, 19)
    lib = step_cuda._library_3d(consts.mode, consts.variant)
    nx, ny, nz = problem.params.nx, problem.params.ny, problem.params.nz
    rows = 4 if knobs == "rows4" else 8
    march = {"march1": 1, "march2": 2, "march3": 3, "march_long": 40}
    assert lib.tpulbm_d3q19_grid(nx, ny, nz, 0) == march.get(
        knobs, _march(nx, ny, nz, rows))
    assert lib.tpulbm_d3q19_tile() == 32 * 256 + rows
    lag = 2 if problem.lattice.Q == 27 else 1
    assert lib.tpulbm_d3q19_lag() == {"lag1": 1, "lag2": 2}.get(knobs, lag)
    got = _one_step_launches(problem, f, 2)
    assert torch.equal(got, want), float((got - want).abs().max())


def _march(nx, ny, nz, rows, resident=2):
    """The launcher's march (march_for): the longest of at most 16 planes
    that gives two waves of the resident blocks over 32 x rows tiles, at
    least 8 planes."""
    tiles = -(-nx // 32) * -(-ny // rows)
    segments = -(-2 * resident // tiles)
    return max(min(-(-nz // segments), 16), min(8, nz))


def test_the_march_fills_the_card(zmarch):
    # the fake runtime: 2 SMs of one resident block each, so two waves are
    # 4 blocks; 32 x 8 tiles
    zmarch("default")
    consts = step_cuda.kernel_constants(_problem("sphere"), 19)
    lib = step_cuda._library_3d(consts.mode, consts.variant)
    assert lib.tpulbm_d3q19_resident(0) == 2
    assert (lib.tpulbm_d3q19_threads(), lib.tpulbm_d3q19_lag()) == (256, 1)
    grid = lib.tpulbm_d3q19_grid
    assert grid(20, 14, 11, 0) == 8     # 2 tiles: 2 marches of 8 + 3
    assert grid(20, 14, 19, 0) == 10    # 10 + 9
    assert grid(40, 14, 11, 0) == 11    # 4 tiles: one march
    assert grid(20, 14, 5, 0) == 5      # nz below 8: every plane
    assert grid(20, 8, 64, 0) == 16     # 1 tile: 4 marches
    assert grid(20, 8, 200, 0) == 16    # 13 marches: at most 16 planes
    # 38 floats of ring and 19 of stage a window cell (the window 34 x 10),
    # 2 mask planes
    assert lib.tpulbm_d3q19_smem_bytes() == (38 + 19) * 4 * 340 + 2 * 340
    for case, floats, lag in (("bouzidi", 43 + 19, 1), ("d3q27", 81 + 27, 2),
                              ("bouzidi_d3q27", 90 + 27, 2)):
        # Bouzidi: class 0 keeps one slot more
        c = step_cuda.kernel_constants(_problem(case), 19)
        lib = step_cuda._library_3d(c.mode, c.variant)
        assert (lib.tpulbm_d3q19_smem_bytes(), lib.tpulbm_d3q19_lag()) == \
            (floats * 4 * 340 + (lag + 1) * 340, lag)


def _ring_launch(problem, f, shape):
    """One depth-1 launch of every shard of the host-built ring kernel,
    gathered."""
    consts, _, _ = _operands(problem)
    mesh = cpu_mesh(shape)
    x_rings = shape[1] != 1
    geo = sharded_step.kernel_shards(problem, mesh, 1, x_rings)
    blocks = sharded_step.split(mesh, f)
    rings = halo.exchange(blocks, eq_ring=problem.ghost_ring_values(),
                          depth=1, periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, x_rings=x_rings)
    lib = step_cuda._rings_library_3d(consts.mode, consts.variant)
    outs = [[torch.empty_like(b) for b in row] for row in blocks]
    for iy, ix in mesh.shards():
        assert lib.tpulbm_d3q19_step_rings(*step_cuda.ring_launch_args(
            blocks[iy][ix], outs[iy][ix], rings[iy][ix], geo[iy][ix],
            consts, 1)) == 0
    return sharded_step.gather(outs)


@pytest.mark.parametrize("case,shape", RING_CASES,
                         ids=[f"{c}-{s[0]}x{s[1]}" for c, s in RING_CASES])
def test_zmarch_ring_builds_equal_one_device(zmarch, case, shape):
    zmarch("default")
    problem = _problem(case)
    f = torch.from_numpy(perturbed(problem))
    got = _ring_launch(problem, f, shape)
    want = _launch(problem, f, 1)
    assert torch.equal(got, want), float((got - want).abs().max())
