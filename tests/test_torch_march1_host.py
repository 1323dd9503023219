"""The 1-step D2Q9 kernel, the row march of csrc/d2q9_march.cuh at N = 1
(csrc/step_d2q9.cu), built for the host with g++ against the fake CUDA
runtime (tests/test_torch_mesh_thermal.py: FAKE_RUNTIME, each CUDA thread
a fiber, NaN-filled shared memory; cp.async a copy at its issue):

* one launch against the plain step (ops/step_torch.py) at the one-step
  tolerance, from a seeded ±10% perturbed state: the BGK cylinder, TRT
  with the clean Zou-He corners at an odd ny, the cavity at 33 x 33, the
  Taylor-Green box, the channel, the slab, the Bouzidi cylinder (its link
  cells counted), the force profile along x and along y, the power law;
* the march's knobs as -D defines: a widened row of 7 columns (strips of
  5) with segments of 2 rows and the copies 4 batches ahead, and batches
  of 2 rows over a widened row of 13 with segments of 3 rows, each bitwise
  the default build and within the tolerance of the plain step (the fake
  runtime copies at the issue, so a copy into a ring slot still read
  fails);
* the ring build against one device, bitwise, on (2,1), (1,2) and (2,2)
  with x rings, and the overlap mode's three ranged launches a shard on
  (4,1), the interior one given no rings.

One N-step launch equals N of these launches bitwise in
tests/test_torch_march_host.py.
"""
import types
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from tpulbm_torch.config import SimulationParams
from tpulbm_torch.models import make_problem
from tpulbm_torch.ops import bouzidi, step_cuda, step_torch
from tpulbm_torch.parallel import halo, sharded_step
from test_torch_march_host import CASES as MARCH_CASES
from test_torch_march_host import _problem as march_problem
from test_torch_mesh import cpu_mesh, perturbed
from test_torch_slab import host_build  # noqa: F401

CASES = {**MARCH_CASES,
         "power_law": dict(MARCH_CASES["bgk"], power_law_n=0.7)}
TOL = dict(rtol=5e-6, atol=1e-7)
# the power law's Newton solve (PERF.md §2) and the cavity's corner
# residual, which cancels terms of ~0.5 down to ~1e-5
CASE_TOL = {"power_law": dict(rtol=1e-4, atol=1e-7),
            "cavity": dict(rtol=2e-5, atol=5e-7)}
KNOBS = {
    "default": (),
    "narrow": ("-DTPULBM_WIDTH=7", "-DTPULBM_SEGMENT=2",
               "-DTPULBM_AHEAD=4"),
    "rows2": ("-DTPULBM_WIDTH=13", "-DTPULBM_ROWS=2", "-DTPULBM_SEGMENT=3"),
}
# (widened row, rows a batch, threads: a warp's whole multiple of two
# stages' columns and rows)
SHAPES = {"default": (128, 1, 256), "narrow": (7, 1, 32),
          "rows2": (13, 2, 64)}
ONE_DEVICE = ([(case, "default") for case in CASES]
              + [(case, knobs) for case in ("trt_corners", "cavity", "box",
                                            "bouzidi", "force_y")
                 for knobs in ("narrow", "rows2")])
RING_CASES = {
    "trt_corners": dict(MARCH_CASES["trt_corners"], ny=44),
    "box": dict(MARCH_CASES["box"], nx=40, ny=44),
}
MESHES = [((2, 1), False), ((1, 2), False), ((2, 2), False), ((4, 1), True)]
RINGS = [(case, mesh, ranged, knobs) for case in RING_CASES
         for mesh, ranged in MESHES for knobs in ("default", "narrow")]


def _problem(case):
    if case == "power_law":
        return make_problem(SimulationParams(precision="f32",
                                             **CASES[case]))
    return march_problem(case)


def _libraries(problem, knobs, rings=False):
    c = step_cuda.kernel_constants(problem, 9)
    defines = step_cuda.build_defines(c.mode, c.variant) + KNOBS[knobs]
    out = [("step_d2q9.cu", defines)]
    if rings:
        out.append(("step_d2q9.cu", step_cuda.build_defines(
            c.mode, c.variant | step_cuda.RINGS) + KNOBS[knobs]))
    return out


@pytest.fixture(scope="module", autouse=True)
def _prebuilt(host_build):
    """The module's host libraries, built six at a time in the background
    while its first tests run."""
    libs = [lib for case, knobs in ONE_DEVICE
            for lib in _libraries(_problem(case), knobs)]
    libs += [lib for case, knobs in ONE_DEVICE if knobs != "default"
             for lib in _libraries(_problem(case), "default")]
    for case, _, _, knobs in RINGS:
        p = make_problem(SimulationParams(precision="f32",
                                          **RING_CASES[case]))
        libs += _libraries(p, knobs, rings=True)
        libs += _libraries(p, "default")
    pool = ThreadPoolExecutor(6)
    for source, defines in dict.fromkeys(libs):
        pool.submit(host_build, source, defines)
    yield
    pool.shutdown(cancel_futures=True)


@pytest.fixture
def march(host_build, monkeypatch):
    """set(knobs): step_cuda's 1-step libraries bound to host builds of
    step_d2q9.cu under the knobs' defines."""
    names = ("_library", "_rings_library")

    def clear():
        for name in names:
            getattr(step_cuda, name).cache_clear()

    def set_knobs(knobs):
        clear()

        def load(source, defines=()):
            return types.SimpleNamespace(
                lib=host_build(source, (*defines, *KNOBS[knobs])))

        monkeypatch.setattr(step_cuda.cuda_build, "load", load)

    yield set_knobs
    clear()


def _launch(problem, f):
    """One launch of the host-built 1-step kernel."""
    consts = step_cuda.kernel_constants(problem, 9)
    mask = torch.as_tensor(step_cuda.kernel_mask(problem))
    links = (bouzidi.device_table(problem, "cpu")
             if consts.variant & step_cuda.BOUZIDI else None)
    out = torch.empty_like(f)
    fn = step_cuda._library(consts.mode, consts.variant).tpulbm_d2q9_step
    assert fn(*step_cuda.launch_args(f, out, mask, consts, 1, links)) == 0
    return out


@pytest.mark.parametrize("case,knobs", ONE_DEVICE,
                         ids=[f"{c}-{k}" for c, k in ONE_DEVICE])
def test_march_1step_is_the_plain_step(march, case, knobs):
    problem = _problem(case)
    consts = step_cuda.kernel_constants(problem, 9)
    if case == "bouzidi":
        assert int((bouzidi.device_table(problem, "cpu")[:9] >= 0).sum()) > 0
    if case.startswith("force"):
        assert consts.force_axis == (0 if case == "force_x" else 1)
    f = torch.from_numpy(perturbed(problem))
    if knobs != "default":
        march("default")
        base = _launch(problem, f)
    march(knobs)
    lib = step_cuda._library(consts.mode, consts.variant)
    assert (lib.tpulbm_d2q9_width(), lib.tpulbm_d2q9_rows(),
            lib.tpulbm_d2q9_threads()) == SHAPES[knobs]
    got = _launch(problem, f)
    want = step_torch.make_step_rolled(problem, "cpu")(f)
    torch.testing.assert_close(got, want, **CASE_TOL.get(case, TOL))
    if knobs != "default":
        assert torch.equal(got, base)


def test_segments_fill_the_card_and_keep_two_rows(march):
    # the fake runtime: 2 SMs of one resident block each; the grid as
    # strips * 65536 + segments
    march("default")
    problem = _problem("trt_corners")
    consts = step_cuda.kernel_constants(problem, 9)
    lib = step_cuda._library(consts.mode, consts.variant)
    # the clean corners' ring reaches two batches of one row: the same
    # power-of-two rows with the copies 2 batches ahead, twice 4 ahead
    assert lib.tpulbm_d2q9_smem_bytes(1) == lib.tpulbm_d2q9_smem_bytes(0)
    assert lib.tpulbm_d2q9_grid(200, 33, 1, 0) == 2 * 65536 + 1
    assert lib.tpulbm_d2q9_grid(70, 33, 0, 0) == 65536 + 2
    assert lib.tpulbm_d2q9_grid(70, 1, 0, 0) == 65536 + 1
    march("narrow")   # strips of 5, segments of 2 rows
    lib = step_cuda._library(consts.mode, consts.variant)
    assert lib.tpulbm_d2q9_grid(70, 33, 0, 0) == 14 * 65536 + 17
    assert lib.tpulbm_d2q9_grid(70, 33, 1, 0) == 14 * 65536 + 16
    assert lib.tpulbm_d2q9_smem_bytes(1) > lib.tpulbm_d2q9_smem_bytes(0)


def _ring_launch(problem, f, shape, ranged):
    """One launch of every shard of the host-built 1-step ring kernel (the
    overlap mode's three ranged launches a shard with `ranged`, the
    interior one without rings), gathered."""
    consts = step_cuda.kernel_constants(problem, 9)
    mesh = cpu_mesh(shape)
    x_rings = shape[1] != 1
    nyl = sharded_step.block_shape(problem, mesh)[-2]
    geo = sharded_step.kernel_shards(problem, mesh, 1, x_rings)
    blocks = sharded_step.split(mesh, f)
    rings = halo.exchange(blocks, eq_ring=problem.ghost_ring_values(),
                          depth=1, periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, x_rings=x_rings)
    lib = step_cuda._rings_library(consts.mode, consts.variant)
    outs = [[torch.empty_like(b) for b in row] for row in blocks]
    for iy, ix in mesh.shards():
        shard, b, r, out = (geo[iy][ix], blocks[iy][ix], rings[iy][ix],
                            outs[iy][ix])
        ranges = ([((2, nyl - 2), (None,) * 4), ((0, 2), r),
                   ((nyl - 2, nyl), r)] if ranged else [((0, nyl), r)])
        for rows, rr in ranges:
            step_cuda.check_shard(b, out, rr, shard, 1, rows)
            assert lib.tpulbm_d2q9_step_rings(
                *step_cuda.ring_launch_args(b, out, rr, shard, consts, 1,
                                            rows)) == 0
    return sharded_step.gather(outs)


@pytest.mark.parametrize(
    "case,shape,ranged,knobs", RINGS,
    ids=[f"{c}-{s[0]}x{s[1]}{'-overlap' if r else ''}-{k}"
         for c, s, r, k in RINGS])
def test_march_1step_ring_builds_equal_one_device(march, case, shape,
                                                  ranged, knobs):
    problem = make_problem(SimulationParams(precision="f32",
                                            **RING_CASES[case]))
    f = torch.from_numpy(perturbed(problem))
    march("default")
    want = _launch(problem, f)
    march(knobs)
    got = _ring_launch(problem, f, shape, ranged)
    assert torch.equal(got, want), float((got - want).abs().max())
