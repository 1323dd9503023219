"""The N-step D2Q9 kernel's row march (csrc/step_d2q9_blocked.cu) built
for the host with g++ against the fake CUDA runtime
(tests/test_torch_mesh_thermal.py: FAKE_RUNTIME, each CUDA thread a fiber,
NaN-filled shared memory; cp.async a copy at its issue) and held bit for
bit to N launches of the host-built 1-step kernel, from a seeded ±10%
perturbed state, at N = 2, 3, 4 (8 in the deep build).

* one device: the BGK cylinder, TRT with the clean Zou-He corners at an
  odd ny (the corner rows at a segment's end), the cavity at 33 x 33, the
  Taylor-Green box (y wraps across segments), the channel, the slab, the
  Bouzidi cylinder (its link cells counted), the force profile along x and
  along y, and the deep build at N = 8; grids of partial strips (nx = 70
  and 37: not multiples of 4; strips of 56-92 columns by default);
* the march's knobs as -D defines: the default build, a widened row of
  11 columns (strips of 7, 5 and 3 at N = 2, 3, 4: narrower than 2N at
  N = 3, 4) with segments of 3 rows (shorter than N + 1), and batches of 2
  rows over a widened row of 15 with segments of 4 rows (unequal: 33 rows
  in 9); the fake runtime copies at the issue, so a copy into a ring slot
  still read fails;
* the ring builds against one device on (2,1), (1,2) and (2,2) with x
  rings, and the overlap mode's three ranged launches a shard on (4,1).
"""
import dataclasses
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tpulbm_torch.config import SimulationParams
from tpulbm_torch.models import make_problem
from tpulbm_torch.models.base import ForceProfile
from tpulbm_torch.ops import bouzidi, step_cuda
from tpulbm_torch.parallel import halo, sharded_step
from test_torch_mesh import cpu_mesh, perturbed
from test_torch_slab import host_build, slab  # noqa: F401

CYLINDER = dict(problem="cylinder", nx=70, ny=33, tau=0.6,
                inlet_velocity=0.05)
CASES = {
    "bgk": CYLINDER,
    "trt_corners": dict(CYLINDER, collision="trt", zou_he_corners="clean"),
    "cavity": dict(problem="cavity", nx=33, ny=33, tau=0.6,
                   inlet_velocity=0.1),
    "box": dict(problem="taylor-green", nx=37, ny=30, tau=0.6),
    "channel": dict(problem="poiseuille", nx=70, ny=33, tau=0.8),
    "slab": "bounce_back",
    "bouzidi": dict(CYLINDER, obstacle_bc="bouzidi"),
    "force_x": dict(problem="kolmogorov", nx=70, ny=24, tau=0.8),
    "force_y": dict(problem="kolmogorov", nx=70, ny=24, tau=0.8),
}
KNOBS = {
    "default": (),
    "narrow": ("-DTPULBM_WIDTH=11", "-DTPULBM_SEGMENT=3"),
    "rows2": ("-DTPULBM_WIDTH=15", "-DTPULBM_ROWS=2", "-DTPULBM_SEGMENT=4"),
}
# (stage 0's widened row, rows a batch, threads at N=4: a warp's whole
# multiple of 5 stages' columns and rows) of each
SHAPES = {"default": (96, 1, 480), "narrow": (11, 1, 64),
          "rows2": (15, 2, 160)}
ONE_DEVICE = ([(case, "default") for case in CASES]
              + [(case, knobs) for case in ("trt_corners", "cavity", "box",
                                            "bouzidi", "force_y")
                 for knobs in ("narrow", "rows2")])
RING_CASES = {
    "trt_corners": dict(CASES["trt_corners"], ny=44),
    "box": dict(CASES["box"], nx=40, ny=44),
}
MESHES = [((2, 1), False), ((1, 2), False), ((2, 2), False), ((4, 1), True)]
RINGS = [(case, mesh, ranged, knobs) for case in RING_CASES
         for mesh, ranged in MESHES for knobs in ("default", "narrow")]


def _problem(case, **over):
    kw = CASES[case]
    if isinstance(kw, str):   # the slab, built as tpulbm's gates build it
        return slab(kw, "f32", nx=70)[0]
    p = make_problem(SimulationParams(precision="f32", **{**kw, **over}))
    if case == "force_x":   # F_y = F0 cos(kx x), tpulbm's x-varying force
        kx = 2.0 * np.pi * 2 / p.params.nx
        p = dataclasses.replace(p, force_profile=ForceProfile(
            "x", lambda x: (0.0, 1e-3 * torch.cos(kx * x))))
    return p


def _libraries(problem, knobs, deep=False, rings=False):
    """The (source, defines) pairs one case builds: the 1-step library and
    the N-step one under `knobs` (deep and ring builds as asked)."""
    c = step_cuda.kernel_constants(problem, 9)
    blocked = c.variant | (step_cuda.DEEP if deep else 0)
    out = [("step_d2q9.cu", step_cuda.build_defines(c.mode, c.variant)),
           ("step_d2q9_blocked.cu",
            step_cuda.build_defines(c.mode, blocked) + KNOBS[knobs])]
    if rings:
        out.append(("step_d2q9_blocked.cu", step_cuda.build_defines(
            c.mode, blocked | step_cuda.RINGS) + KNOBS[knobs]))
    return out


@pytest.fixture(scope="module", autouse=True)
def _prebuilt(host_build):
    """The module's host libraries, built six at a time in the background
    while its first tests run."""
    libs = [lib for case, knobs in ONE_DEVICE
            for lib in _libraries(_problem(case), knobs)]
    libs += _libraries(_problem("trt_corners"), "default", deep=True)
    for case, _, _, knobs in RINGS:
        libs += _libraries(make_problem(SimulationParams(
            precision="f32", **RING_CASES[case])), knobs, rings=True)
    pool = ThreadPoolExecutor(6)
    for source, defines in dict.fromkeys(libs):
        pool.submit(host_build, source, defines)
    yield
    pool.shutdown(cancel_futures=True)


@pytest.fixture
def march(host_build, monkeypatch):
    """set(knobs): step_cuda's libraries bound to host builds whose N-step
    source takes the knobs' defines."""
    names = ("_library", "_blocked_library", "_rings_blocked_library")

    def clear():
        for name in names:
            getattr(step_cuda, name).cache_clear()

    def set_knobs(knobs):
        clear()

        def load(source, defines=()):
            if source == "step_d2q9_blocked.cu":
                defines = (*defines, *KNOBS[knobs])
            return types.SimpleNamespace(lib=host_build(source, defines))

        monkeypatch.setattr(step_cuda.cuda_build, "load", load)

    yield set_knobs
    clear()


def _launch(problem, f, n_sub):
    """One launch of the host-built kernel at depth n_sub (1: the 1-step
    kernel)."""
    consts = step_cuda.kernel_constants(problem, 9)
    mask = torch.as_tensor(step_cuda.kernel_mask(problem))
    links = (bouzidi.device_table(problem, "cpu")
             if consts.variant & step_cuda.BOUZIDI else None)
    out = torch.empty_like(f)
    variant = consts.variant | step_cuda.deep_bit(n_sub)
    if n_sub == 1:
        fn = step_cuda._library(consts.mode, variant).tpulbm_d2q9_step
    else:
        fn = step_cuda._blocked_library(
            consts.mode, variant).tpulbm_d2q9_step_blocked
    assert fn(*step_cuda.launch_args(f, out, mask, consts, n_sub,
                                     links)) == 0
    return out


def _one_step_launches(problem, f, n):
    for _ in range(n):
        f = _launch(problem, f, 1)
    return f


@pytest.mark.parametrize("case,knobs", ONE_DEVICE,
                         ids=[f"{c}-{k}" for c, k in ONE_DEVICE])
def test_march_launch_is_n_1step_launches(march, case, knobs):
    march(knobs)
    problem = _problem(case)
    consts = step_cuda.kernel_constants(problem, 9)
    if case == "bouzidi":
        assert int((bouzidi.device_table(problem, "cpu")[:9] >= 0).sum()) > 0
    if case.startswith("force"):
        assert consts.force_axis == (0 if case == "force_x" else 1)
    lib = step_cuda._blocked_library(consts.mode, consts.variant)
    assert (lib.tpulbm_d2q9_blocked_width(), lib.tpulbm_d2q9_blocked_rows(),
            lib.tpulbm_d2q9_blocked_threads(4)) == SHAPES[knobs]
    f = torch.from_numpy(perturbed(problem))
    for n in step_cuda.BLOCKED_DEPTHS:
        assert torch.equal(_launch(problem, f, n),
                           _one_step_launches(problem, f, n)), n


def test_deep_march_at_8(march):
    march("default")
    problem = _problem("trt_corners")
    f = torch.from_numpy(perturbed(problem))
    assert torch.equal(_launch(problem, f, 8),
                       _one_step_launches(problem, f, 8))


def test_segments_fill_the_card_and_keep_two_rows(march):
    # the fake runtime: 2 SMs of one resident block each; the grid as
    # strips * 65536 + segments
    march("default")
    problem = _problem("trt_corners")
    consts = step_cuda.kernel_constants(problem, 9)
    lib = step_cuda._blocked_library(consts.mode, consts.variant)
    grid = lib.tpulbm_d2q9_blocked_grid
    assert grid(4, 200, 33, 1, 0) == 3 * 65536 + 1  # strips of 88: 3
    assert grid(4, 70, 33, 1, 0) == 65536 + 2
    assert grid(4, 70, 9, 0, 0) == 65536 + 1        # at least 2N rows
    assert grid(5, 37, 33, 0, 0) == -1
    march("narrow")   # strips of 3 (N=4), segments of 3 rows; 2 at least
    lib = step_cuda._blocked_library(consts.mode, consts.variant)
    assert lib.tpulbm_d2q9_blocked_grid(4, 70, 33, 0, 0) == 24 * 65536 + 11
    assert lib.tpulbm_d2q9_blocked_grid(4, 70, 5, 1, 0) == 24 * 65536 + 2
    # the clean corners' rings reach two batches of one row: more memory
    assert lib.tpulbm_d2q9_blocked_smem_bytes(4, 1) > \
        lib.tpulbm_d2q9_blocked_smem_bytes(4, 0)


def _ring_launch(problem, f, shape, depth, ranged):
    """One launch of every shard of the host-built ring kernel at `depth`
    (the overlap mode's three ranged launches a shard with `ranged`),
    gathered."""
    consts = step_cuda.kernel_constants(problem, 9)
    mesh = cpu_mesh(shape)
    x_rings = shape[1] != 1
    nyl = sharded_step.block_shape(problem, mesh)[-2]
    geo = sharded_step.kernel_shards(problem, mesh, depth, x_rings)
    blocks = sharded_step.split(mesh, f)
    rings = halo.exchange(blocks, eq_ring=problem.ghost_ring_values(),
                          depth=depth, periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, x_rings=x_rings)
    lib = step_cuda._rings_blocked_library(consts.mode, consts.variant)
    outs = [[torch.empty_like(b) for b in row] for row in blocks]
    e = depth + 1
    for iy, ix in mesh.shards():
        shard, b, r, out = (geo[iy][ix], blocks[iy][ix], rings[iy][ix],
                            outs[iy][ix])
        ranges = ([((e, nyl - e), (None,) * 4), ((0, e), r),
                   ((nyl - e, nyl), r)] if ranged else [((0, nyl), r)])
        for rows, rr in ranges:
            step_cuda.check_shard(b, out, rr, shard, depth, rows)
            assert lib.tpulbm_d2q9_step_blocked_rings(
                *step_cuda.ring_launch_args(b, out, rr, shard, consts, depth,
                                            rows)) == 0
    return sharded_step.gather(outs)


@pytest.mark.parametrize(
    "case,shape,ranged,knobs", RINGS,
    ids=[f"{c}-{s[0]}x{s[1]}{'-overlap' if r else ''}-{k}"
         for c, s, r, k in RINGS])
def test_march_ring_builds_equal_one_device(march, case, shape, ranged,
                                            knobs):
    march(knobs)
    problem = make_problem(SimulationParams(precision="f32",
                                            **RING_CASES[case]))
    f = torch.from_numpy(perturbed(problem))
    for n in step_cuda.BLOCKED_DEPTHS:
        got = _ring_launch(problem, f, shape, n, ranged)
        assert torch.equal(got, _launch(problem, f, n)), n
