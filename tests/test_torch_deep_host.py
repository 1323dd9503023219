"""The deep builds of the N-step kernels (-DTPULBM_DEEP=1: 2-D N = 5-8,
3-D N = 4-8) built for the host with g++ against tests/test_torch_slab.py's
fake CUDA runtime (one std::thread per CUDA thread, a barrier for
__syncthreads, NaN-filled shared memory) and held bit for bit to N
launches of the host-built 1-step kernels, from a seeded ±10% perturbed
state.

* 2-D: the cylinder under TRT with the clean Zou-He corners at 33 rows
  (the tiling shifted a row, tile_row_shift), the cavity at 33 x 33 (its
  corners, the column shift too), the periodic box and the Bouzidi
  cylinder;
* 3-D: the sphere on D3Q19 (tiles 32 x 4 at N=4, 4 x 2 at N=8), on D3Q27
  at N=8 (no tile fits shared memory: the rings in the scratch buffer, two
  resident blocks walking the tiles) and under the Bouzidi obstacle, the
  periodic box at N=7 below N + 1 planes (the extended sweep's ring slots
  of planes down to -N - 1);
* the ring builds on meshes against one device: 2-D (2, 1) and (4, 1) at
  N=8 (the overlap mode's three ranges), 3-D (2, 1) on D3Q27 at N=8 and
  (2, 2) with x rings at N=5.
"""
import types

import numpy as np
import pytest
import torch

from tpulbm_torch.config import SimulationParams
from tpulbm_torch.models import make_problem
from tpulbm_torch.ops import bouzidi, step_cuda
from tpulbm_torch.parallel import halo, sharded_step
from test_torch_mesh import cpu_mesh, perturbed
from test_torch_slab import host_build, host_kernels, prebuild  # noqa: F401

CASES_2D = {
    "trt_corners": dict(problem="cylinder", nx=70, ny=33, tau=0.6,
                        inlet_velocity=0.05, collision="trt",
                        zou_he_corners="clean"),
    "cavity": dict(problem="cavity", nx=33, ny=33, tau=0.6,
                   inlet_velocity=0.1),
    "box": dict(problem="taylor-green", nx=40, ny=24, tau=0.6),
    "bouzidi": dict(problem="cylinder", nx=70, ny=33, tau=0.6,
                    inlet_velocity=0.05, obstacle_bc="bouzidi"),
}
SPHERE = dict(problem="cylinder3d", nx=20, ny=14, nz=11, tau=0.6,
              inlet_velocity=0.05, cylinder_radius=0.2)
CASES_3D = {
    "d3q19": SPHERE,
    "d3q27": dict(SPHERE, lattice3d="d3q27"),
    "bouzidi_d3q27": dict(SPHERE, cylinder_radius=0.23,
                          obstacle_bc="bouzidi", lattice3d="d3q27"),
    "box": dict(problem="taylor-green", nx=12, ny=10, nz=6, tau=0.6),
}


def _problem(kw):
    return make_problem(SimulationParams(precision="f32", **kw))


@pytest.fixture(scope="module", autouse=True)
def _libraries(host_build):
    """The module's host libraries, built in the background while its first
    tests run."""
    d2, d3 = ("step_d2q9.cu", "step_d2q9_blocked.cu"), ("step_d3q19.cu",
                                                         "step_d3q19_blocked.cu")
    libs = []

    def add(sources, kw, q, variants, extra=()):
        c = step_cuda.kernel_constants(_problem(kw), q)
        libs.append((sources[0], step_cuda.build_defines(c.mode, c.variant)))
        for v in variants:
            libs.append((sources[1], step_cuda.build_defines(
                c.mode, c.variant | v) + extra))

    for kw in CASES_2D.values():
        add(d2, kw, 9, [step_cuda.DEEP])
    for kw in CASES_3D.values():
        add(d3, kw, 19, [step_cuda.DEEP])
    for case, cluster in CLUSTERED:
        add(d3, CLUSTER_CASES[case], 19,
            [0, step_cuda.RINGS] if case == "rings" else [0],
            (f"-DTPULBM_CLUSTER_X={cluster[0]}",
             f"-DTPULBM_CLUSTER_Y={cluster[1]}"))
    pool = prebuild(host_build, libs)
    yield
    pool.shutdown(cancel_futures=True)


def _launch(problem, f, n_sub):
    """One launch of the problem's host-built kernel at depth n_sub (1:
    the 1-step kernel; the deep depths: the deep build)."""
    three_d = problem.lattice.D == 3
    consts = step_cuda.kernel_constants(problem, 19 if three_d else 9)
    mask = torch.as_tensor(step_cuda.kernel_mask(problem))
    links = (bouzidi.device_table(problem, "cpu")
             if consts.variant & step_cuda.BOUZIDI else None)
    out = torch.empty_like(f)
    variant = consts.variant | step_cuda.deep_bit(n_sub, three_d)
    if not three_d:
        lib = (step_cuda._library(consts.mode, variant) if n_sub == 1
               else step_cuda._blocked_library(consts.mode, variant))
        fn = (lib.tpulbm_d2q9_step if n_sub == 1
              else lib.tpulbm_d2q9_step_blocked)
        args = step_cuda.launch_args(f, out, mask, consts, n_sub, links)
    elif n_sub == 1:
        lib = step_cuda._library_3d(consts.mode, variant)
        fn = lib.tpulbm_d3q19_step
        args = step_cuda.launch_args(f, out, mask, consts, 1, links)
    else:
        lib = step_cuda._blocked_library_3d(consts.mode, variant)
        fn = lib.tpulbm_d3q19_step_blocked
        scratch = step_cuda.scratch_for(lib, n_sub, f.device)
        args = step_cuda.launch_args(f, out, mask, consts, n_sub, links,
                                     None, scratch)
    assert fn(*args) == 0
    return out


def _one_step_launches(problem, f, n):
    for _ in range(n):
        f = _launch(problem, f, 1)
    return f


@pytest.mark.parametrize("case,n_sub", [
    ("trt_corners", 5), ("trt_corners", 8), ("cavity", 8), ("box", 8),
    ("bouzidi", 6)])
def test_deep_2d_launch_is_n_1step_launches(host_kernels, case, n_sub):
    problem = _problem(CASES_2D[case])
    f = torch.from_numpy(perturbed(problem))
    assert torch.equal(_launch(problem, f, n_sub),
                       _one_step_launches(problem, f, n_sub))


@pytest.mark.parametrize("case,n_sub,tile,scratch", [
    ("d3q19", 4, (32, 4), False), ("d3q19", 8, (4, 2), False),
    ("d3q27", 8, (8, 8), True), ("bouzidi_d3q27", 8, (8, 8), True),
    ("box", 7, (8, 4), False)])
def test_deep_3d_launch_is_n_1step_launches(host_kernels, case, n_sub, tile,
                                            scratch):
    problem = _problem(CASES_3D[case])
    consts = step_cuda.kernel_constants(problem, 19)
    lib = step_cuda._blocked_library_3d(consts.mode,
                                        consts.variant | step_cuda.DEEP)
    assert divmod(lib.tpulbm_d3q19_blocked_tile(n_sub), 256) == tile
    assert lib.tpulbm_d3q19_blocked_smem_bytes(n_sub) <= 232448
    assert (lib.tpulbm_d3q19_blocked_scratch_bytes(n_sub, 0) > 0) == scratch
    assert lib.tpulbm_d3q19_blocked_smem_bytes(3) == -1   # not a deep depth
    f = torch.from_numpy(perturbed(problem))
    assert torch.equal(_launch(problem, f, n_sub),
                       _one_step_launches(problem, f, n_sub))


def _ring_launch(problem, f, shape, depth, ranged=False):
    """One launch of every shard of the host-built deep ring kernel (three
    ranged launches a shard with `ranged`), gathered."""
    three_d = problem.lattice.D == 3
    consts = step_cuda.kernel_constants(problem, 19 if three_d else 9)
    mesh = cpu_mesh(shape)
    x_rings = shape[1] != 1
    local = sharded_step.block_shape(problem, mesh)
    geo = sharded_step.kernel_shards(problem, mesh, depth, x_rings)
    blocks = sharded_step.split(mesh, f)
    rings = halo.exchange(blocks, eq_ring=problem.ghost_ring_values(),
                          depth=depth, periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, x_rings=x_rings)
    variant = consts.variant | step_cuda.deep_bit(depth, three_d)
    outs = [[torch.empty_like(b) for b in row] for row in blocks]
    nyl, e = local[-2], depth + 1
    for iy, ix in mesh.shards():
        shard, b, r, out = (geo[iy][ix], blocks[iy][ix], rings[iy][ix],
                            outs[iy][ix])
        if three_d:
            lib = step_cuda._rings_blocked_library_3d(consts.mode, variant)
            scratch = step_cuda.scratch_for(lib, depth, b.device)
            assert lib.tpulbm_d3q19_step_blocked_rings(
                *step_cuda.ring_launch_args(b, out, r, shard, consts, depth,
                                            scratch=scratch)) == 0
            continue
        lib = step_cuda._rings_blocked_library(consts.mode, variant)
        ranges = ([((e, nyl - e), (None,) * 4), ((0, e), r),
                   ((nyl - e, nyl), r)] if ranged else [((0, nyl), r)])
        for rows, rr in ranges:
            step_cuda.check_shard(b, out, rr, shard, depth, rows)
            assert lib.tpulbm_d2q9_step_blocked_rings(
                *step_cuda.ring_launch_args(b, out, rr, shard, consts, depth,
                                            rows)) == 0
    return sharded_step.gather(outs)


@pytest.mark.parametrize("kw,shape,depth,ranged", [
    (dict(problem="cylinder", nx=40, ny=64, tau=0.6, inlet_velocity=0.05),
     (2, 1), 8, False),
    (dict(problem="cylinder", nx=40, ny=112, tau=0.6, inlet_velocity=0.05),
     (4, 1), 8, True),
    (dict(SPHERE, ny=16, nz=9, lattice3d="d3q27"), (2, 1), 8, False),
    (dict(SPHERE, ny=16, nz=9), (2, 2), 5, False)],
    ids=["2d_rows", "2d_overlap", "d3q27_scratch", "3d_x_rings"])
def test_deep_ring_builds_equal_one_device(host_kernels, kw, shape, depth,
                                           ranged):
    problem = _problem(kw)
    f = torch.from_numpy(perturbed(problem))
    got = _ring_launch(problem, f, shape, depth, ranged)
    assert torch.equal(got, _launch(problem, f, depth))


# The default N-step 3-D build (N = 2, 3) under its thread-block cluster
# (1 x 2) and others (-DTPULBM_CLUSTER_X, _Y; 1 x 1 a lone block): ragged
# grids of two x tiles (the left one ragged) and one or two y tiles, padded
# to whole clusters; every shape on the sphere, one on each other build.
CLUSTER_CASES = {
    "sphere": dict(SPHERE, nx=40),
    "sphere_d3q27": dict(SPHERE, nx=40, lattice3d="d3q27"),
    "bouzidi": dict(SPHERE, nx=40, obstacle_bc="bouzidi"),
    "box": dict(problem="taylor-green", nx=40, ny=14, nz=5, tau=0.6),
    "duct": dict(problem="poiseuille", nx=40, ny=14, nz=9, tau=0.8,
                 inlet_velocity=0.0, body_force=(1e-4, 0.0, 1e-5)),
    "rings": dict(SPHERE, nx=40, ny=16),
}


def _with_cluster(monkeypatch, host_build, cluster):
    """Bind step_cuda's libraries to host builds whose N-step 3-D source
    takes the cluster `cluster` (blocks along x, y)."""
    extra = (f"-DTPULBM_CLUSTER_X={cluster[0]}",
             f"-DTPULBM_CLUSTER_Y={cluster[1]}")

    def load(source, defines=()):
        if source == "step_d3q19_blocked.cu":
            defines = (*defines, *extra)
        return types.SimpleNamespace(lib=host_build(source, defines))

    monkeypatch.setattr(step_cuda.cuda_build, "load", load)


CLUSTERED = [("sphere", (1, 1)), ("sphere", (1, 2)), ("sphere", (2, 2)),
             ("sphere", (2, 4)), ("sphere_d3q27", (2, 4)), ("bouzidi", (2, 2)),
             ("box", (2, 4)), ("duct", (2, 2)), ("rings", (2, 2))]


@pytest.mark.parametrize(
    "case,cluster", CLUSTERED,
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_clustered_3d_launch_is_n_1step_launches(host_kernels, monkeypatch,
                                                 case, cluster):
    _with_cluster(monkeypatch, host_kernels, cluster)
    problem = _problem(CLUSTER_CASES[case])
    consts = step_cuda.kernel_constants(problem, 19)
    lib = step_cuda._blocked_library_3d(consts.mode, consts.variant)
    assert [divmod(lib.tpulbm_d3q19_blocked_cluster(n), 256)
            for n in (2, 3)] == [cluster] * 2
    assert lib.tpulbm_d3q19_blocked_threads(3) == 512
    if case == "bouzidi":
        table = bouzidi.device_table(problem, "cpu")
        assert int((table[:19] >= 0).sum()) > 0
    f = torch.from_numpy(perturbed(problem))
    for n in step_cuda.BLOCKED_DEPTHS_3D:
        want = _launch(problem, f, n)
        if case == "rings":   # the ring build on (2, 1) against one device
            got = _ring_launch(problem, f, (2, 1), n)
        else:                 # one launch against n 1-step launches
            got = _one_step_launches(problem, f, n)
        assert torch.equal(got, want), (n, float((got - want).abs().max()))


def test_the_default_builds_refuse_the_deep_depths(host_kernels):
    problem = _problem(CASES_2D["box"])
    consts = step_cuda.kernel_constants(problem, 9)
    lib = step_cuda._blocked_library(consts.mode, consts.variant)
    deep = step_cuda._blocked_library(consts.mode,
                                      consts.variant | step_cuda.DEEP)
    # the march's rings, 96 columns wide: (8 + 4 (N - 1)) rows x 36 B
    assert [lib.tpulbm_d2q9_blocked_smem_bytes(n, 0) for n in range(2, 9)] \
        == [41472, 55296, 69120, -1, -1, -1, -1]
    assert [deep.tpulbm_d2q9_blocked_smem_bytes(n, 0)
            for n in range(2, 9)] == [-1, -1, -1, 82944, 96768, 110592,
                                      124416]
    f = torch.from_numpy(perturbed(problem))
    out = torch.empty_like(f)
    mask = torch.as_tensor(step_cuda.kernel_mask(problem))
    assert lib.tpulbm_d2q9_step_blocked(*step_cuda.launch_args(
        f, out, mask, consts, 5, None)) != 0
    assert deep.tpulbm_build_variant() == consts.variant | step_cuda.DEEP
