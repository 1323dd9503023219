"""The CUDA kernels against their plain version, and the N-step kernels
against N launches of the 1-step kernels, on the card: D2Q9 (under every
collision, with either Zou-He corner rule), D3Q19 (one step and N steps,
under every collision tpulbm runs in 3-D), the thermal D2Q9 + D2Q5 kernel
(BGK and the Smagorinsky closure), the Shan-Chen multiphase kernel, the
ring builds on meshes of shards (2-D and 3-D), the deep builds of the
N-step kernels (2-D N = 5-8, 3-D N = 4-8) and the D3Q19 phase lab. These
tests need an NVIDIA GPU with nvcc and skip elsewhere; run them on the
card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import functools

import numpy as np
import pytest
import torch

from tpulbm_torch.config import SimulationParams
from tpulbm_torch.convert import state_from_numpy
from tpulbm_torch.models import make_problem
from tpulbm_torch.ops import (step_cuda, step_multiphase,
                              step_multiphase_cuda, step_thermal,
                              step_thermal_cuda, step_torch)
from tpulbm_torch.stepper import make_chunk_fn

pytestmark = pytest.mark.requires_cuda
ONE_STEP_TOL = dict(rtol=5e-6, atol=1e-7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA) and nvcc")
    return torch.device("cuda", 0)


def _perturbed_state(problem, seed):
    # a state with structure at every edge and corner: the initial state
    # times seeded noise, solid cells back at rest equilibrium
    rng = np.random.default_rng(seed)
    f = problem.initial_state() * rng.uniform(
        0.9, 1.1, (problem.lattice.Q,) + problem.spatial_shape)
    f[:, problem.solid] = problem.lattice.w[:, None]
    return f.astype(np.float32)


# ragged shapes (not multiples of the 32x8 block), a grid narrower than one
# block, and a cylinder with solid cells on the inlet column and the bottom
# wall row (the BCs must leave them to the obstacle pin)
@pytest.mark.parametrize("kw", [
    dict(nx=256, ny=64), dict(nx=100, ny=37), dict(nx=17, ny=5),
    dict(nx=64, ny=32, cylinder_x=0.03, cylinder_y=0.06,
         cylinder_radius=0.12)])
def test_kernel_one_step_matches_plain(cuda, kw):
    problem = make_problem(SimulationParams(tau=0.55, inlet_velocity=0.05,
                                            **kw))
    f = state_from_numpy(_perturbed_state(problem, kw["nx"]), problem, cuda)
    kstep = step_cuda.make_local_step_cuda(problem, cuda)
    before = step_cuda.launches(step_cuda.collide_stream)
    got = kstep(f, torch.empty_like(f))
    assert step_cuda.launches(step_cuda.collide_stream) == before + 1
    want = step_torch.make_step_rolled(problem, cuda)(f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ONE_STEP_TOL)


def test_kernel_chunk_counts_every_launch(cuda):
    problem = make_problem(SimulationParams(nx=128, ny=64))
    f = state_from_numpy(problem.initial_state(), problem, cuda)
    before = step_cuda.launches(step_cuda.collide_stream)
    got = make_chunk_fn(problem, cuda, 25, backend="pallas")(f.clone())
    assert step_cuda.launches(step_cuda.collide_stream) == before + 25
    want = make_chunk_fn(problem, cuda, 25, backend="jax")(f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_kernel_wrapper_refuses_mixed_devices(cuda):
    problem = make_problem(SimulationParams(nx=64, ny=32))
    kstep = step_cuda.make_local_step_cuda(problem, cuda)
    f = torch.from_numpy(problem.initial_state())      # on the host
    with pytest.raises(ValueError):
        kstep(f, torch.empty_like(f))


# ragged shapes, one smaller than the N-step kernel's 32x16 tile, and the
# cylinder with solid cells on the inlet column and the bottom wall row
@pytest.mark.parametrize("n_sub", step_cuda.BLOCKED_DEPTHS)
@pytest.mark.parametrize("kw", [
    dict(nx=256, ny=64), dict(nx=100, ny=37), dict(nx=17, ny=5),
    dict(nx=20, ny=11),
    dict(nx=64, ny=32, cylinder_x=0.03, cylinder_y=0.06,
         cylinder_radius=0.12)])
def test_blocked_kernel_equals_n_one_step_launches(cuda, kw, n_sub):
    # bitwise: the two kernels share their per-cell code and rounding
    problem = make_problem(SimulationParams(tau=0.55, inlet_velocity=0.05,
                                            **kw))
    f = state_from_numpy(_perturbed_state(problem, kw["nx"]), problem, cuda)
    bstep = step_cuda.make_local_step_cuda_blocked(problem, cuda, n_sub)
    kstep = step_cuda.make_local_step_cuda(problem, cuda)
    before = dict(step_cuda.launches(step_cuda.collide_stream_blocked))
    got = bstep(f, torch.empty_like(f))
    assert step_cuda.launches(step_cuda.collide_stream_blocked)[n_sub] == \
        before[n_sub] + 1
    want = f.clone()
    for _ in range(n_sub):
        want = kstep(want, torch.empty_like(want))
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


def test_blocked_chunk_counts_every_launch(cuda):
    problem = make_problem(SimulationParams(nx=128, ny=64))
    f = state_from_numpy(problem.initial_state(), problem, cuda)
    step_cuda.reset_launch_counts()
    chunk = make_chunk_fn(problem, cuda, 28, backend="pallas")
    got = chunk(f.clone())
    assert chunk.substeps == 4
    assert step_cuda.launches(step_cuda.collide_stream_blocked) == {
        2: 0, 3: 0, 4: 7}
    assert step_cuda.launches(step_cuda.collide_stream) == 0
    want = make_chunk_fn(problem, cuda, 28, backend="jax")(f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


# the D2Q9 kernels under each other collision, with the clean corners, on
# grids whose top inlet corner sits on a tile's first row (ny - 1 a
# multiple of the 8- and 16-row tiles, where the corner's inward neighbour
# needs the shifted tiling), a ragged one, and one narrower than a tile
OPERATORS = {
    "trt": dict(collision="trt"),
    "mrt": dict(collision="mrt", mrt_rates=(("e", 1.857),)),
    "regularized": dict(collision="regularized"),
    "kbc": dict(collision="kbc"),
    "les": dict(smagorinsky=0.17),
    "power_law": dict(power_law_n=0.7),
    "bgk": dict(),
}


@pytest.mark.parametrize("shape", [(64, 17), (100, 33), (45, 20), (17, 9)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("op", list(OPERATORS))
def test_operator_kernels_match_plain_and_each_other(cuda, op, shape):
    nx, ny = shape
    problem = make_problem(SimulationParams(
        nx=nx, ny=ny, tau=0.55, inlet_velocity=0.05, zou_he_corners="clean",
        **OPERATORS[op]))
    mode = step_torch.collision_mode(problem)
    f = state_from_numpy(_perturbed_state(problem, nx), problem, cuda)
    kstep = step_cuda.make_local_step_cuda(problem, cuda)
    before = step_cuda.launches_by_mode(step_cuda.collide_stream)[mode]
    got = kstep(f, torch.empty_like(f))
    assert step_cuda.launches_by_mode(
        step_cuda.collide_stream)[mode] == before + 1
    want = step_torch.make_step_rolled(problem, cuda)(f)
    torch.cuda.synchronize()
    if op == "kbc":   # tpulbm's KBC gate: its entropic ratio amplifies
        assert float((got - want).abs().max() / want.abs().max()) < 3e-5
    else:
        torch.testing.assert_close(
            got, want, **(dict(rtol=1e-4, atol=1e-7) if op == "power_law"
                          else ONE_STEP_TOL))
    for n_sub in step_cuda.BLOCKED_DEPTHS:
        bstep = step_cuda.make_local_step_cuda_blocked(problem, cuda, n_sub)
        got = bstep(f, torch.empty_like(f))
        want = f.clone()
        for _ in range(n_sub):
            want = kstep(want, torch.empty_like(want))
        torch.cuda.synchronize()
        assert torch.equal(got, want), (n_sub,
                                        float((got - want).abs().max()))


# D3Q19: ragged grids, a grid smaller than one 32x4 tile, the sphere that
# pierces the inlet plane, the one whose outlet neighbours are solid, and
# bench.py's 256^3 cell
@pytest.mark.parametrize("kw", [
    dict(nx=33, ny=17, nz=9, cylinder_x=0.5, cylinder_radius=0.15),
    dict(nx=20, ny=11, nz=5), dict(nx=7, ny=3, nz=2),
    dict(nx=32, ny=32, nz=8, cylinder_y=0.5, cylinder_radius=0.2),
    dict(nx=32, ny=32, nz=8, cylinder_x=0.9, cylinder_y=0.5,
         cylinder_radius=0.2),
    dict(nx=256, ny=256, nz=256)],
    ids=["33x17x9", "20x11x5", "7x3x2", "inlet_piercing", "outlet_reaching",
         "256cubed"])
def test_kernel_3d_one_step_matches_plain(cuda, kw):
    problem = make_problem(SimulationParams(problem="cylinder3d", tau=0.55,
                                            inlet_velocity=0.05, **kw))
    f = state_from_numpy(_perturbed_state(problem, kw["nx"]), problem, cuda)
    kstep = step_cuda.make_local_step_cuda_3d(problem, cuda)
    before = step_cuda.launches(step_cuda.collide_stream_3d)
    got = kstep(f, torch.empty_like(f))
    assert step_cuda.launches(step_cuda.collide_stream_3d) == before + 1
    want = step_torch.make_step_rolled(problem, cuda)(f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ONE_STEP_TOL)


def test_kernel_3d_chunk_counts_every_launch(cuda):
    problem = make_problem(SimulationParams(problem="cylinder3d", nx=64,
                                            ny=32, nz=24,
                                            cylinder_radius=0.2))
    f = state_from_numpy(problem.initial_state(), problem, cuda)
    step_cuda.reset_launch_counts()
    chunk = make_chunk_fn(problem, cuda, 28, backend="pallas")
    got = chunk(f.clone())
    # tpulbm's plan for 28 steps: 8 N=3 launches, then 2 N=2
    assert chunk.plan == [(3, 8), (2, 2)]
    assert step_cuda.launches(step_cuda.collide_stream_3d_blocked) == {
        2: 2, 3: 8}
    assert step_cuda.launches(step_cuda.collide_stream_3d) == 0
    assert step_cuda.launches(step_cuda.collide_stream) == 0
    assert step_cuda.launches(step_cuda.collide_stream_blocked) == {
        2: 0, 3: 0, 4: 0}
    want = make_chunk_fn(problem, cuda, 28, backend="jax")(f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


# the N-step D3Q19 kernel: tpulbm's 3-D test grid, the ragged grid, the
# spheres that pierce the inlet and reach the outlet, a grid at nz = N + 1
# (the shallowest the plan takes) and one of two z-chunks
@pytest.mark.parametrize("n_sub", step_cuda.BLOCKED_DEPTHS_3D)
@pytest.mark.parametrize("kw", [
    dict(nx=32, ny=16, nz=8),
    dict(nx=33, ny=17, nz=9, cylinder_x=0.5, cylinder_radius=0.15),
    dict(nx=32, ny=32, nz=8, cylinder_y=0.5, cylinder_radius=0.2),
    dict(nx=32, ny=32, nz=8, cylinder_x=0.9, cylinder_y=0.5,
         cylinder_radius=0.2),
    dict(nx=20, ny=11, nz=None),
    dict(nx=40, ny=9, nz=70, cylinder_y=0.5, cylinder_radius=0.3)],
    ids=["sphere", "33x17x9", "inlet_piercing", "outlet_reaching",
         "nz_n_plus_1", "two_z_chunks"])
def test_blocked_kernel_3d_equals_n_one_step_launches(cuda, kw, n_sub):
    # bitwise: the two kernels share their per-cell code and rounding
    kw = dict(kw, nz=kw["nz"] or n_sub + 1)
    problem = make_problem(SimulationParams(problem="cylinder3d", tau=0.55,
                                            inlet_velocity=0.05, **kw))
    f = state_from_numpy(_perturbed_state(problem, kw["nx"]), problem, cuda)
    bstep = step_cuda.make_local_step_cuda_3d_blocked(problem, cuda, n_sub)
    kstep = step_cuda.make_local_step_cuda_3d(problem, cuda)
    before = dict(step_cuda.launches(step_cuda.collide_stream_3d_blocked))
    got = bstep(f, torch.empty_like(f))
    assert step_cuda.launches(step_cuda.collide_stream_3d_blocked) == {
        **before, n_sub: before[n_sub] + 1}
    want = f.clone()
    for _ in range(n_sub):
        want = kstep(want, torch.empty_like(want))
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


def test_blocked_kernel_3d_refuses(cuda):
    problem = make_problem(SimulationParams(problem="cylinder3d", nx=32,
                                            ny=16, nz=8))
    bstep = step_cuda.make_local_step_cuda_3d_blocked(problem, cuda, 3)
    host = torch.from_numpy(problem.initial_state())
    with pytest.raises(ValueError):            # a host tensor
        bstep(host, torch.empty_like(host))
    # a depth the library does not hold: the launch is refused, not run
    f = state_from_numpy(problem.initial_state(), problem, cuda)
    out = torch.empty_like(f)
    solid = torch.as_tensor(problem.solid, device=cuda).to(torch.uint8)
    consts = step_cuda.StepConstants.of(problem)
    lib = step_cuda._blocked_library_3d()
    rc = lib.tpulbm_d3q19_step_blocked(
        f.data_ptr(), out.data_ptr(), solid.data_ptr(), 32, 16, 8, 4,
        *consts.d3q19_args, None, None, 0, None, 0, 0,
        torch.cuda.current_stream(cuda).cuda_stream)
    assert rc != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        step_cuda._check_launch(lib, rc, "D3Q19 4-step kernel")
    assert lib.tpulbm_d3q19_blocked_smem_bytes(4) == -1


# D3Q19 under tpulbm's 3-D collisions: each operator's 1-step kernel
# against the plain step (the power law at tpulbm's rtol 1e-4) and its
# N-step kernel bitwise against N 1-step launches, on ragged grids, one
# smaller than a tile, the sphere whose outlet neighbours are solid, and
# tpulbm's own 3-D gate grid of the operator (tests/test_3d.py,
# test_mrt.py, test_regularized.py, test_les.py, test_power_law.py)
OPERATORS_3D = {
    "trt": (dict(collision="trt"), dict(nx=32, ny=16, nz=8, tau=0.6)),
    "mrt": (dict(collision="mrt"), dict(nx=32, ny=16, nz=8, tau=0.6)),
    "regularized": (dict(collision="regularized"),
                    dict(nx=64, ny=16, nz=16, tau=0.6)),
    "les": (dict(smagorinsky=0.17), dict(nx=128, ny=16, nz=16, tau=0.55)),
    "power_law": (dict(power_law_n=0.7, power_law_k=0.02),
                  dict(nx=128, ny=16, nz=16, tau=0.55)),
    "bgk": (dict(), dict(nx=32, ny=16, nz=8, tau=0.6)),
}
GRIDS_3D = {
    "33x17x9": dict(nx=33, ny=17, nz=9, cylinder_x=0.5, cylinder_radius=0.15,
                    tau=0.55),
    "7x3x4": dict(nx=7, ny=3, nz=4, tau=0.55),
    "outlet_reaching": dict(nx=32, ny=32, nz=8, cylinder_x=0.9,
                            cylinder_y=0.5, cylinder_radius=0.2, tau=0.55),
    "gate": None,
}


@pytest.mark.parametrize("grid", GRIDS_3D)
@pytest.mark.parametrize("op", OPERATORS_3D)
def test_operator_3d_kernels_match_plain_and_each_other(cuda, op, grid):
    kw, gate = OPERATORS_3D[op]
    problem = make_problem(SimulationParams(
        problem="cylinder3d", inlet_velocity=0.05, **kw,
        **(GRIDS_3D[grid] or gate)))
    mode = step_torch.collision_mode(problem)
    f = state_from_numpy(_perturbed_state(problem, problem.params.nx),
                         problem, cuda)
    kstep = step_cuda.make_local_step_cuda_3d(problem, cuda)
    before = step_cuda.launches_by_mode(step_cuda.collide_stream_3d)[mode]
    got = kstep(f, torch.empty_like(f))
    assert step_cuda.launches_by_mode(
        step_cuda.collide_stream_3d)[mode] == before + 1
    want = step_torch.make_step_rolled(problem, cuda)(f)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, want, **(dict(rtol=1e-4, atol=1e-7) if op == "power_law"
                      else ONE_STEP_TOL))
    for n_sub in step_cuda.BLOCKED_DEPTHS_3D:
        bstep = step_cuda.make_local_step_cuda_3d_blocked(problem, cuda,
                                                          n_sub)
        by_mode = functools.partial(step_cuda.launches_by_mode,
                                    step_cuda.collide_stream_3d_blocked)
        before = by_mode()[mode][n_sub]
        got = bstep(f, torch.empty_like(f))
        assert by_mode()[mode][n_sub] == before + 1
        want = f.clone()
        for _ in range(n_sub):
            want = kstep(want, torch.empty_like(want))
        torch.cuda.synchronize()
        assert torch.equal(got, want), (n_sub,
                                        float((got - want).abs().max()))


def test_bgk_libraries_launch_path_is_unchanged(cuda):
    # BGK's libraries are built with no define, report mode 0, take the
    # zero coefficients, and count their launches as BGK's
    from tpulbm_torch.utils import cuda_build
    problem = make_problem(SimulationParams(problem="cylinder3d", nx=32,
                                            ny=16, nz=8))
    consts = step_cuda.StepConstants.of(problem)
    assert consts.mode == "bgk" and not any(consts.modes)
    assert len(consts.modes) == step_cuda.MODE_FLOATS_3D
    for source, lib in (("step_d3q19.cu", step_cuda._library_3d()),
                        ("step_d3q19_blocked.cu",
                         step_cuda._blocked_library_3d()),
                        ("step_thermal.cu", step_thermal_cuda._library())):
        assert lib._name == str(cuda_build.load(source).path)
    for lib in (step_cuda._library_3d(), step_cuda._blocked_library_3d(),
                step_thermal_cuda._library()):
        assert lib.tpulbm_collision_mode() == 0
    step_cuda.reset_launch_counts()
    f = state_from_numpy(problem.initial_state(), problem, cuda)
    make_chunk_fn(problem, cuda, 7, backend="pallas")(f)
    by_mode = step_cuda.launches_by_mode(step_cuda.collide_stream_3d_blocked)
    assert by_mode["bgk"] == {2: 2, 3: 1}
    assert sum(sum(d.values()) for m, d in by_mode.items()
               if m != "bgk") == 0


# thermal: a grid smaller than one 32x8 tile, a ragged one, the heated
# cavity's 96x96, a ragged 100x70 for both problems, and bench.py's
# 2048x512 Rayleigh-Bénard cell
def _thermal_params(problem, nx, ny):
    return SimulationParams(problem=problem, nx=nx, ny=ny, tau=0.55,
                            thermal_tau=0.5704, rayleigh=1e4,
                            inlet_velocity=0.0, cylinder_radius=0.0,
                            periodic_x=problem == "rayleigh-benard")


@pytest.mark.parametrize("problem,nx,ny", [
    ("rayleigh-benard", 7, 3), ("heated-cavity", 7, 3),
    ("rayleigh-benard", 33, 9), ("heated-cavity", 96, 96),
    ("rayleigh-benard", 100, 70), ("heated-cavity", 100, 70),
    ("rayleigh-benard", 2048, 512)])
def test_thermal_kernel_one_step_matches_plain(cuda, problem, nx, ny):
    problem = make_problem(_thermal_params(problem, nx, ny))
    rng = np.random.default_rng(nx)
    s = (problem.initial_state()
         * rng.uniform(0.9, 1.1, (problem.state_q, ny, nx))).astype(np.float32)
    s = state_from_numpy(s, problem, cuda)
    kstep = step_thermal_cuda.make_local_step_thermal_cuda(problem, cuda)
    before = step_cuda.launches(step_thermal_cuda.collide_stream_thermal)
    got = kstep(s, torch.empty_like(s))
    assert step_cuda.launches(
        step_thermal_cuda.collide_stream_thermal) == before + 1
    want = step_thermal.make_step_thermal(problem, cuda)(s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ONE_STEP_TOL)


# the thermal kernel's LES build (Cs 0.17) against the plain LES step, on
# the grids above and tpulbm's own LES gate grid (32x32, Ra 5000)
@pytest.mark.parametrize("problem,nx,ny", [
    ("rayleigh-benard", 7, 3), ("heated-cavity", 33, 9),
    ("rayleigh-benard", 32, 32), ("heated-cavity", 96, 96),
    ("rayleigh-benard", 2048, 512)])
def test_thermal_les_kernel_one_step_matches_plain(cuda, problem, nx, ny):
    problem = make_problem(_thermal_params(problem, nx, ny).replace(
        smagorinsky=0.17))
    rng = np.random.default_rng(nx)
    s = (problem.initial_state()
         * rng.uniform(0.9, 1.1, (problem.state_q, ny, nx))).astype(np.float32)
    s = state_from_numpy(s, problem, cuda)
    kstep = step_thermal_cuda.make_local_step_thermal_cuda(problem, cuda)
    before = step_cuda.launches_by_mode(
        step_thermal_cuda.collide_stream_thermal)
    got = kstep(s, torch.empty_like(s))
    assert step_cuda.launches_by_mode(
        step_thermal_cuda.collide_stream_thermal) == {
        **before, "smagorinsky": before["smagorinsky"] + 1}
    want = step_thermal.make_step_thermal(problem, cuda)(s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ONE_STEP_TOL)
    # the closure moves the result off BGK's
    bgk = step_thermal_cuda.make_local_step_thermal_cuda(
        make_problem(_thermal_params(problem.params.problem, nx, ny)), cuda)
    assert not torch.equal(bgk(s, torch.empty_like(s)), got)


def test_thermal_chunk_counts_every_launch(cuda):
    problem = make_problem(_thermal_params("heated-cavity", 48, 40))
    s = state_from_numpy(problem.initial_state(), problem, cuda)
    step_cuda.reset_launch_counts()
    chunk = make_chunk_fn(problem, cuda, 28, backend="pallas")
    got = chunk(s.clone())
    assert chunk.substeps == 1
    assert step_cuda.launches(step_thermal_cuda.collide_stream_thermal) == 28
    assert step_cuda.launches(step_cuda.collide_stream) == 0
    assert step_cuda.launches(step_cuda.collide_stream_3d) == 0
    want = make_chunk_fn(problem, cuda, 28, backend="jax")(s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


# Shan-Chen multiphase: grids smaller than one 32x8 tile (where x wraps
# across the tile more than once), ragged ones, the band with a wetting
# wall, a repelling wall, and bench.py's 2048x512 droplet
def _multiphase_params(nx, ny, **kw):
    d = dict(problem="multiphase", nx=nx, ny=ny, tau=1.0, shan_chen_g=-5.0,
             inlet_velocity=0.0, cylinder_radius=0.15, cylinder_x=0.5,
             cylinder_y=0.5)
    d.update(kw)
    return SimulationParams(**d)


@pytest.mark.parametrize("nx,ny,kw", [
    (7, 3, {}), (5, 1, dict(cylinder_radius=0.0)), (33, 9, {}),
    (64, 32, dict(cylinder_radius=0.0, mp_wall_rho=1.6)),
    (100, 70, dict(mp_wall_rho=0.16)), (96, 48, dict(cylinder_y=0.0)),
    (2048, 512, {})])
def test_multiphase_kernel_one_step_matches_plain(cuda, nx, ny, kw):
    problem = make_problem(_multiphase_params(nx, ny, **kw))
    rng = np.random.default_rng(nx)
    f = (problem.initial_state()
         * rng.uniform(0.9, 1.1, (9, ny, nx))).astype(np.float32)
    kstep = step_multiphase_cuda.make_local_step_multiphase_cuda(problem,
                                                                 cuda)
    pstep = step_multiphase.make_step_multiphase(problem, cuda)
    for f in (state_from_numpy(problem.initial_state(), problem, cuda),
              state_from_numpy(f, problem, cuda)):
        before = step_multiphase_cuda.collide_stream_multiphase.launches
        got = kstep(f, torch.empty_like(f))
        assert step_multiphase_cuda.collide_stream_multiphase.launches == \
            before + 1
        want = pstep(f)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **ONE_STEP_TOL)


def test_multiphase_chunk_counts_every_launch(cuda):
    problem = make_problem(_multiphase_params(80, 40))
    f = state_from_numpy(problem.initial_state(), problem, cuda)
    step_cuda.reset_launch_counts()
    chunk = make_chunk_fn(problem, cuda, 28, backend="pallas")
    got = chunk(f.clone())
    assert chunk.substeps == 1
    assert step_multiphase_cuda.collide_stream_multiphase.launches == 28
    assert step_cuda.launches(step_cuda.collide_stream) == 0
    assert step_cuda.launches(step_thermal_cuda.collide_stream_thermal) == 0
    want = make_chunk_fn(problem, cuda, 28, backend="jax")(f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


# the ring builds (a shard of a mesh, parallel/sharded_step.py) on ragged
# shards of every domain: each mode and depth bitwise equal to the
# one-device kernel, the ranged launches included, counted per shard
@pytest.mark.parametrize("kw", [
    dict(nx=100, ny=36, tau=0.55, inlet_velocity=0.05, cylinder_x=0.5,
         cylinder_y=0.5, zou_he_corners="clean", obstacle_bc="bounce_back"),
    dict(problem="poiseuille", nx=72, ny=36, tau=0.8, inlet_velocity=0.0,
         body_force=(1e-4, 1e-5)),
    dict(problem="cavity", nx=66, ny=66, tau=0.6, inlet_velocity=0.1,
         cylinder_radius=0.0)])
@pytest.mark.parametrize("shape,env", [
    ((2, 2), {}), ((3, 1), {}), ((1, 2), {"TPULBM_NO_FUSED2": "1"}),
    ((3, 1), {"TPULBM_HALO_OVERLAP": "1"}),
    ((1, 1), {"TPULBM_FORCE_TILED": "1", "TPULBM_SUBSTEPS": "2"})])
def test_ring_kernels_equal_one_device(cuda, monkeypatch, kw, shape, env):
    from tpulbm_torch.parallel import sharded_step
    from tpulbm_torch.parallel.mesh import make_mesh
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    problem = make_problem(SimulationParams(precision="f32", **kw))
    rng = np.random.default_rng(3)
    f0 = problem.initial_state() * rng.uniform(
        0.9, 1.1, (problem.lattice.Q,) + problem.spatial_shape)
    f = state_from_numpy(f0.astype(np.float32), problem, cuda)
    mesh = make_mesh(shape, devices=[cuda] * (shape[0] * shape[1]))
    chunk = sharded_step.make_chunk_fn(problem, mesh, 12)
    want = make_chunk_fn(problem, cuda, 12)(f.clone())
    step_cuda.reset_launch_counts()
    got = sharded_step.gather(chunk(sharded_step.split(mesh, f)))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    per = 12 // chunk.substeps * (3 if chunk.mode == "overlap" else 1)
    assert step_cuda.launches_by_shard(step_cuda.collide_stream_rings) == {
        (step_cuda.kernel_constants(problem).library, chunk.substeps, idx):
        per for idx in mesh.shards()}


# the periodic box (both axes wrap) and the force profile: Taylor-Green,
# the shear layer, Kolmogorov's force along y and a force along x
# (tpulbm's tests/test_kolmogorov.py:239), on a grid smaller than one tile
# (x and y wrap across it more than once), a ragged one and the main
# path's 2048x512, from a ±10% perturbed state; each library against the
# plain step, and its N-step build bitwise against N 1-step launches
def _box_problem(problem, nx, ny, x_force=False, **kw):
    import dataclasses
    from tpulbm_torch.models.base import ForceProfile
    from tpulbm_torch.models.periodic2d import kolmogorov_f0
    params = SimulationParams(problem=problem, nx=nx, ny=ny, tau=0.8,
                              inlet_velocity=0.05, kolmogorov_n=4,
                              periodic_x=True, cylinder_radius=0.0, **kw)
    out = make_problem(params)
    if x_force:
        kx, f0 = 2.0 * np.pi * 2 / nx, kolmogorov_f0(params)
        out = dataclasses.replace(out, force_profile=ForceProfile(
            "x", lambda x: (0.0, f0 * torch.cos(kx * x))))
    return out


def _noisy(problem, seed):
    # the initial state times seeded noise in 0.9-1.1 (no solid cells)
    f = problem.initial_state()
    rng = np.random.default_rng(seed)
    return (f * rng.uniform(0.9, 1.1, f.shape)).astype(np.float32)


BOX_CASES = {
    "taylor-green": ("taylor-green", {}), "kolmogorov": ("kolmogorov", {}),
    "x-force": ("kolmogorov", dict(x_force=True)),
    "shear-regularized": ("shear-layer", dict(collision="regularized")),
    "kolmogorov-mrt": ("kolmogorov", dict(collision="mrt")),
    "kolmogorov-kbc": ("kolmogorov", dict(collision="kbc")),
    "kolmogorov-power-law": ("kolmogorov", dict(power_law_n=0.7)),
}


@pytest.mark.parametrize("case", sorted(BOX_CASES))
@pytest.mark.parametrize("nx,ny", [(7, 3), (37, 21), (2048, 512)])
def test_box_kernels_match_plain_and_each_other(cuda, case, nx, ny):
    name, kw = BOX_CASES[case]
    problem = _box_problem(name, nx, ny, **kw)
    f = state_from_numpy(_noisy(problem, nx), problem, cuda)
    k1 = step_cuda.make_local_step_cuda(problem, cuda)
    consts = step_cuda.kernel_constants(problem)
    step_cuda.reset_launch_counts()
    got = k1(f, torch.empty_like(f))
    assert step_cuda.collide_stream.launches_by_library == {
        consts.library: 1}
    want = step_torch.make_step_rolled(problem, cuda)(f)
    torch.cuda.synchronize()
    tol = (dict(rtol=1e-4, atol=1e-7) if "power" in case else ONE_STEP_TOL)
    if "kbc" in case:   # tpulbm's KBC gate where the one-step one misses
        assert float((got - want).abs().max()) < 3e-5 * float(want.abs().max())
    else:
        torch.testing.assert_close(got, want, **tol)
    for n_sub in (2, 3, 4):
        kn = step_cuda.make_local_step_cuda_blocked(problem, cuda, n_sub)
        gotn = kn(f, torch.empty_like(f))
        wantn = f.clone()
        for _ in range(n_sub):
            wantn = k1(wantn, torch.empty_like(wantn))
        torch.cuda.synchronize()
        assert torch.equal(gotn, wantn), (n_sub, float(
            (gotn - wantn).abs().max()))


@pytest.mark.parametrize("axis", ["x", "y"])
def test_force_profile_acts_in_the_kernel(cuda, axis):
    # at F = 1e-2 the source is far above the tolerance: the box's library
    # without the profile must miss the plain step by > 100 tolerances
    import dataclasses
    from tpulbm_torch.models.base import ForceProfile
    problem = _box_problem("kolmogorov", 256, 64)
    k = 2.0 * np.pi / 64
    comps = ((lambda c: (1e-2 * torch.cos(k * c), 0.0)) if axis == "y"
             else (lambda c: (0.0, 1e-2 * torch.cos(k * c))))
    problem = dataclasses.replace(problem,
                                  force_profile=ForceProfile(axis, comps))
    f = state_from_numpy(_noisy(problem, 5), problem, cuda)
    consts = step_cuda.kernel_constants(problem)
    solid = torch.zeros(problem.spatial_shape, dtype=torch.uint8,
                        device=cuda)
    got = step_cuda.collide_stream(f, torch.empty_like(f), solid, consts)
    bare = dataclasses.replace(consts, variant=consts.variant
                               & ~step_cuda.FORCE, force_axis=-1,
                               force_table=())
    without = step_cuda.collide_stream(f, torch.empty_like(f), solid, bare)
    want = step_torch.make_step_rolled(problem, cuda)(f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ONE_STEP_TOL)
    sep = ((without - want).abs()
           / (ONE_STEP_TOL["atol"] + ONE_STEP_TOL["rtol"] * want.abs())).max()
    assert float(sep) > 100


# the box's ring builds: every mode, depth and shard bitwise equal to one
# device, rings wrapping in y (the corners of the 2x2 mesh from the
# diagonal shard across both seams); under TPULBM_HALO_OVERLAP the ranged
# N-step kernel takes a force profile, and where the 1-step ranged kernel
# would run a force takes the full-width kernels, as in tpulbm
@pytest.mark.parametrize("case", ["taylor-green", "kolmogorov", "x-force"])
@pytest.mark.parametrize("shape,env", [
    ((2, 2), {}), ((3, 1), {}), ((1, 2), {"TPULBM_NO_FUSED2": "1"}),
    ((3, 1), {"TPULBM_HALO_OVERLAP": "1"}),
    ((3, 1), {"TPULBM_HALO_OVERLAP": "1", "TPULBM_NO_FUSED2": "1"}),
    ((1, 1), {"TPULBM_FORCE_TILED": "1", "TPULBM_SUBSTEPS": "2"})])
def test_box_ring_kernels_equal_one_device(cuda, monkeypatch, case, shape,
                                           env):
    from tpulbm_torch.parallel import sharded_step
    from tpulbm_torch.parallel.mesh import make_mesh
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    name, kw = BOX_CASES[case]
    problem = _box_problem(name, 96, 48, **kw)
    f = state_from_numpy(_noisy(problem, 3), problem, cuda)
    mesh = make_mesh(shape, devices=[cuda] * (shape[0] * shape[1]))
    chunk = sharded_step.make_chunk_fn(problem, mesh, 12)
    want = make_chunk_fn(problem, cuda, 12)(f.clone())
    step_cuda.reset_launch_counts()
    got = sharded_step.gather(chunk(sharded_step.split(mesh, f)))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if env.get("TPULBM_HALO_OVERLAP"):
        assert chunk.mode == ("rows" if case != "taylor-green"
                              and chunk.substeps == 1 else "overlap")
    per = 12 // chunk.substeps * (3 if chunk.mode == "overlap" else 1)
    assert step_cuda.launches_by_shard(step_cuda.collide_stream_rings) == {
        (step_cuda.kernel_constants(problem).library, chunk.substeps, idx):
        per for idx in mesh.shards()}


# the periodic passive scalar through the thermal kernel with its wall
# flags off (no source change): stirred and at rest, a grid smaller than
# one tile, a ragged one and 2048x512
@pytest.mark.parametrize("u0", [0.0, 0.04])
@pytest.mark.parametrize("nx,ny", [(7, 3), (33, 9), (2048, 512)])
def test_passive_scalar_kernel_matches_plain(cuda, u0, nx, ny):
    problem = make_problem(SimulationParams(
        problem="passive-scalar", nx=nx, ny=ny, tau=0.8, thermal_tau=0.5704,
        inlet_velocity=u0, periodic_x=True, cylinder_radius=0.0))
    s = state_from_numpy(_noisy(problem, nx), problem, cuda)
    kstep = step_thermal_cuda.make_local_step_thermal_cuda(problem, cuda)
    before = step_cuda.launches(step_thermal_cuda.collide_stream_thermal)
    got = kstep(s, torch.empty_like(s))
    assert step_cuda.launches(
        step_thermal_cuda.collide_stream_thermal) == before + 1
    want = step_thermal.make_step_thermal(problem, cuda)(s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ONE_STEP_TOL)


# ---- the Bouzidi curved wall (still and spinning) ------------------------

def _bz_problem(nx, ny, nz=0, **kw):
    if nz:
        return make_problem(SimulationParams(
            problem="cylinder3d", nx=nx, ny=ny, nz=nz, tau=0.6,
            inlet_velocity=0.05, cylinder_radius=0.23, cylinder_x=0.5,
            cylinder_y=0.5, obstacle_bc="bouzidi", **kw))
    return make_problem(SimulationParams(nx=nx, ny=ny, tau=0.55,
                                         inlet_velocity=0.05,
                                         obstacle_bc="bouzidi", **kw))


# the cylinder across ny/2 at a ragged shape, near the inlet corners (its
# cut links next to the clean corners' rows), spinning; under every D2Q9
# collision the perturbed state, the N-step launches bitwise
@pytest.mark.parametrize("op", list(OPERATORS))
@pytest.mark.parametrize("kw", [
    dict(nx=100, ny=64, cylinder_radius=0.2),
    dict(nx=64, ny=40, cylinder_x=0.05, cylinder_y=0.12,
         cylinder_radius=0.1, zou_he_corners="clean"),
    dict(nx=96, ny=48, cylinder_radius=0.15, cylinder_omega=0.01)],
    ids=["ragged", "corner", "spinning"])
def test_bouzidi_kernels_match_plain_and_each_other(cuda, op, kw):
    problem = _bz_problem(**{**kw, **OPERATORS[op]})
    consts = step_cuda.kernel_constants(problem)
    assert consts.library == f"{consts.mode}+bouzidi"
    f = state_from_numpy(_perturbed_state(problem, 3), problem, cuda)
    got = step_cuda.make_local_step_cuda(problem, cuda)(f, torch.empty_like(f))
    want = step_torch.make_step_rolled(problem, cuda)(f)
    tol = dict(rtol=1e-4, atol=1e-7) if op == "power_law" else ONE_STEP_TOL
    if op == "kbc":
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel < 3e-5
    else:
        torch.testing.assert_close(got, want, **tol)
    # the library without the rewrite misses by many tolerances
    bare = functools.partial(step_cuda.collide_stream, solid=torch.as_tensor(
        problem.solid, device=cuda).to(torch.uint8))
    import dataclasses
    eq = bare(f, torch.empty_like(f), consts=dataclasses.replace(
        consts, variant=0))
    assert float(((eq - want).abs() / (1e-7 + 5e-6 * want.abs())).max()) > 100
    one = step_cuda.make_local_step_cuda(problem, cuda)
    for n in step_cuda.BLOCKED_DEPTHS:
        g = f.clone()
        for _ in range(n):
            g = one(g, torch.empty_like(g))
        got_n = step_cuda.make_local_step_cuda_blocked(problem, cuda, n)(
            f, torch.empty_like(f))
        assert torch.equal(got_n, g), n


@pytest.mark.parametrize("spin", [0.0, 0.01], ids=["still", "spinning"])
@pytest.mark.parametrize("op", ["bgk", "mrt", "power_law"])
def test_bouzidi_3d_kernels_match_plain_and_each_other(cuda, op, spin):
    problem = _bz_problem(48, 24, 24, **OPERATORS_3D[op][0])
    if spin:   # a spinning sphere: the moving-wall block of the table
        import dataclasses
        problem = dataclasses.replace(
            problem, obstacle_velocity=lambda p: np.stack(
                [-spin * (p[..., 1] - 12.0), spin * (p[..., 0] - 24.0),
                 np.zeros_like(p[..., 0])], axis=-1))
    f = state_from_numpy(_perturbed_state(problem, 4), problem, cuda)
    one = step_cuda.make_local_step_cuda_3d(problem, cuda)
    got = one(f, torch.empty_like(f))
    want = step_torch.make_step_rolled(problem, cuda)(f)
    tol = dict(rtol=1e-4, atol=1e-7) if op == "power_law" else ONE_STEP_TOL
    torch.testing.assert_close(got, want, **tol)
    for n in step_cuda.BLOCKED_DEPTHS_3D:
        g = f.clone()
        for _ in range(n):
            g = one(g, torch.empty_like(g))
        got_n = step_cuda.make_local_step_cuda_3d_blocked(problem, cuda, n)(
            f, torch.empty_like(f))
        assert torch.equal(got_n, g), n


@pytest.mark.parametrize("shape,env", [
    ((2, 1), {}), ((1, 2), {}), ((2, 2), {}),
    ((4, 1), {"TPULBM_HALO_OVERLAP": "1"})],
    ids=["rows", "x-cut", "2x2", "overlap"])
def test_bouzidi_ring_kernels_equal_one_device(cuda, monkeypatch, shape,
                                               env):
    from tpulbm_torch.parallel import sharded_step
    from tpulbm_torch.parallel.mesh import make_mesh
    for k in ("TPULBM_HALO_OVERLAP", "TPULBM_SUBSTEPS", "TPULBM_NO_FUSED2"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    problem = _bz_problem(128, 64, cylinder_radius=0.2, cylinder_x=0.5,
                          cylinder_omega=0.01)
    f = state_from_numpy(_perturbed_state(problem, 6), problem, cuda)
    mesh = make_mesh(shape, devices=[cuda] * (shape[0] * shape[1]))
    chunk = sharded_step.make_chunk_fn(problem, mesh, 24)
    got = sharded_step.gather(chunk(sharded_step.split(mesh, f)))
    want = make_chunk_fn(problem, cuda, 24)(f.clone())
    assert torch.equal(got, want)
    assert chunk.substeps == (1 if shape[1] > 1 else 4)
    diag = sharded_step.Diagnostics(problem, mesh)
    from tpulbm_torch.ops import forces
    assert torch.equal(diag.force(sharded_step.split(mesh, want)),
                       forces.forces_fn(problem, cuda)(want))


# the 3-D boxes, the z force and D3Q27 (ROADMAP Queue 1 item 16): every
# build one step against the plain step from a perturbed state and its
# N-step launch bitwise against N 1-step launches, on grids smaller than a
# tile, ragged ones and nz below the N-step kernel's 64-plane march (down
# to nz = N + 1, where the box's extended sweep wraps most)
BOX3D_CASES = {
    "tg": ("taylor-green", {}),
    "kolmogorov": ("kolmogorov", {}),
    "kolmogorov-trt": ("kolmogorov", dict(collision="trt")),
    "kolmogorov-mrt": ("kolmogorov", dict(collision="mrt")),
    "kolmogorov-regularized": ("kolmogorov",
                               dict(collision="regularized")),
    "kolmogorov-les": ("kolmogorov", dict(smagorinsky=0.17)),
    "kolmogorov-power-law": ("kolmogorov", dict(power_law_n=0.7,
                                                power_law_k=0.02)),
    "tg-d3q27": ("taylor-green", dict(lattice3d="d3q27")),
    "kolmogorov-d3q27": ("kolmogorov", dict(lattice3d="d3q27")),
    "kolmogorov-d3q27-trt": ("kolmogorov", dict(lattice3d="d3q27",
                                                collision="trt")),
    "kolmogorov-d3q27-power-law": ("kolmogorov", dict(
        lattice3d="d3q27", power_law_n=0.7, power_law_k=0.02)),
    "sphere-d3q27": ("cylinder3d", dict(lattice3d="d3q27")),
    "sphere-d3q27-trt-bounce-back": ("cylinder3d", dict(
        lattice3d="d3q27", collision="trt", obstacle_bc="bounce_back")),
    "sphere-d3q27-regularized": ("cylinder3d", dict(
        lattice3d="d3q27", collision="regularized")),
    "sphere-d3q27-les": ("cylinder3d", dict(lattice3d="d3q27",
                                            smagorinsky=0.17)),
    "duct-d3q27": ("poiseuille", dict(lattice3d="d3q27",
                                      body_force=(1e-4, 0.0, 1e-5))),
}


@pytest.mark.parametrize("case", sorted(BOX3D_CASES))
@pytest.mark.parametrize("nx,ny,nz", [(7, 5, 4), (40, 9, 8), (70, 17, 67)])
def test_box3d_and_d3q27_kernels_match_plain_and_each_other(cuda, case, nx,
                                                            ny, nz):
    name, kw = BOX3D_CASES[case]
    box = name in ("taylor-green", "kolmogorov")
    params = SimulationParams(
        problem=name, nx=nx, ny=ny, nz=nz, tau=0.8 if box else 0.6,
        inlet_velocity=0.05, kolmogorov_n=1, periodic_x=box or
        name == "poiseuille", cylinder_radius=0.0 if box else 0.2,
        **kw)
    problem = make_problem(params)
    noisy = (_noisy if problem.solid is None else _perturbed_state)
    f = state_from_numpy(noisy(problem, nx + nz), problem, cuda)
    k1 = step_cuda.make_local_step_cuda_3d(problem, cuda)
    consts = step_cuda.kernel_constants(problem, 19)
    step_cuda.reset_launch_counts()
    got = k1(f, torch.empty_like(f))
    assert step_cuda.collide_stream_3d.launches_by_library == {
        consts.library: 1}
    want = step_torch.make_step_rolled(problem, cuda)(f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **(
        dict(rtol=1e-4, atol=1e-7) if "power" in case else ONE_STEP_TOL))
    for n_sub in step_cuda.BLOCKED_DEPTHS_3D:
        kn = step_cuda.make_local_step_cuda_3d_blocked(problem, cuda, n_sub)
        gotn = kn(f, torch.empty_like(f))
        wantn = f.clone()
        for _ in range(n_sub):
            wantn = k1(wantn, torch.empty_like(wantn))
        torch.cuda.synchronize()
        assert torch.equal(gotn, wantn), (n_sub, float(
            (gotn - wantn).abs().max()))


def test_z_force_acts_in_the_kernel(cuda):
    # at F0 = 1e-2 the source is far above the tolerance: the box's library
    # without the z profile must miss the plain step by > 100 tolerances
    import dataclasses
    problem = make_problem(SimulationParams(
        problem="kolmogorov", nx=40, ny=9, nz=16, tau=0.8, kolmogorov_n=2,
        inlet_velocity=0.05, periodic_x=True, cylinder_radius=0.0))
    from tpulbm_torch.models.base import ForceProfile
    k = 2.0 * np.pi * 2 / 16
    big = dataclasses.replace(problem, force_profile=ForceProfile(
        "z", lambda z: (1e-2 * torch.cos(k * z), 0.0, 0.0)))
    f = state_from_numpy(_noisy(big, 3), big, cuda)
    consts = step_cuda.kernel_constants(big, 19)
    solid = torch.zeros(big.spatial_shape, dtype=torch.uint8, device=cuda)
    got = step_cuda.collide_stream_3d(f, torch.empty_like(f), solid, consts)
    want = step_torch.make_step_rolled(big, cuda)(f)
    bare = dataclasses.replace(consts, force_table=(), force_axis=-1,
                               variant=consts.variant & ~step_cuda.FORCE)
    without = step_cuda.collide_stream_3d(f, torch.empty_like(f), solid,
                                          bare)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ONE_STEP_TOL)
    miss = float(((without - want).abs()
                  / (1e-7 + 5e-6 * want.abs())).max())
    assert miss > 100, miss


# the ring builds of both D3Q19 kernels (-DTPULBM_RINGS=1) on 3-D meshes,
# every shard on the card: a 12-step chunk (tpulbm's depth-3 split, or
# depth 1 for the Bouzidi sphere on an x-cut mesh and under
# TPULBM_NO_FUSED2) bitwise equal to the one-device chunk from a ±10%
# perturbed state, every launch counted per library, depth and shard
RING3D_CASES = {
    "sphere": dict(problem="cylinder3d", nx=48, ny=24, nz=12, tau=0.6,
                   inlet_velocity=0.05, cylinder_x=0.5, cylinder_y=0.5,
                   cylinder_radius=0.3),
    "duct": dict(problem="poiseuille", nx=48, ny=24, nz=12, tau=0.8,
                 inlet_velocity=0.0, body_force=(1e-4, 0.0, 0.0)),
    "box": dict(problem="kolmogorov", nx=48, ny=24, nz=12, tau=0.8,
                inlet_velocity=0.05, cylinder_radius=0.0),
}
RING3D_CASES.update({
    "bounce_back_trt": dict(RING3D_CASES["sphere"],
                            obstacle_bc="bounce_back", collision="trt"),
    "bouzidi": dict(RING3D_CASES["sphere"], obstacle_bc="bouzidi"),
    "sphere_d3q27": dict(RING3D_CASES["sphere"], lattice3d="d3q27"),
    "box_d3q27": dict(RING3D_CASES["box"], lattice3d="d3q27")})


@pytest.mark.parametrize("case", sorted(RING3D_CASES))
@pytest.mark.parametrize("shape,env", [((2, 2), {}), ((4, 1), {}),
                                       ((1, 4), {}),
                                       ((2, 1), {"TPULBM_NO_FUSED2": "1"})])
def test_ring_kernels_3d_equal_one_device(cuda, monkeypatch, case, shape,
                                          env):
    from tpulbm_torch.parallel import sharded_step
    from tpulbm_torch.parallel.mesh import make_mesh
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    problem = make_problem(SimulationParams(precision="f32",
                                            **RING3D_CASES[case]))
    f = state_from_numpy(_noisy(problem, 5), problem, cuda)
    mesh = make_mesh(shape, devices=[cuda] * (shape[0] * shape[1]))
    chunk = sharded_step.make_chunk_fn(problem, mesh, 12)
    want = make_chunk_fn(problem, cuda, 12)(f.clone())
    step_cuda.reset_launch_counts()
    got = sharded_step.gather(chunk(sharded_step.split(mesh, f)))
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())
    lib = step_cuda.kernel_constants(problem, 19).library
    assert step_cuda.launches_by_shard(step_cuda.collide_stream_rings_3d) \
        == {(lib, d, idx): n for d, n in chunk.plan for idx in mesh.shards()}
    assert step_cuda.launches(step_cuda.collide_stream_3d) == 0


# the ring builds of the thermal kernel (BGK and the Smagorinsky closure)
# and of the multiphase kernel on meshes, every shard on the card: a
# 12-step chunk bitwise equal to the one-device chunk from a ±10%
# perturbed state, 12 launches counted per shard; one launch per shard
# within the one-step tolerance of its plain ring step, and rings of the
# frozen equilibrium in place of the neighbours' data far off it
COUPLED_CASES = {
    "rb": _thermal_params("rayleigh-benard", 100, 72),
    "rb_les": _thermal_params("rayleigh-benard", 100, 72).replace(
        smagorinsky=0.17),
    "cavity": _thermal_params("heated-cavity", 96, 96),
    "scalar": SimulationParams(problem="passive-scalar", nx=100, ny=72,
                               tau=0.8, thermal_tau=0.6, inlet_velocity=0.04,
                               cylinder_radius=0.0),
    "droplet": _multiphase_params(100, 72),
    "band": _multiphase_params(96, 64, cylinder_radius=0.0,
                               mp_wall_rho=1.6),
}


@pytest.mark.parametrize("case", sorted(COUPLED_CASES))
@pytest.mark.parametrize("shape,env", [((2, 2), {}), ((4, 1), {}),
                                       ((1, 2), {}),
                                       ((1, 1), {"TPULBM_FORCE_XHALO": "1"})])
def test_coupled_ring_kernels_equal_one_device(cuda, monkeypatch, case,
                                               shape, env):
    from tpulbm_torch.parallel import halo, sharded_step
    from tpulbm_torch.parallel.mesh import make_mesh
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    problem = make_problem(COUPLED_CASES[case].replace(precision="f32"))
    thermal = problem.thermal is not None
    f = state_from_numpy(_noisy(problem, 9), problem, cuda)
    mesh = make_mesh(shape, devices=[cuda] * (shape[0] * shape[1]))
    chunk = sharded_step.make_chunk_fn(problem, mesh, 12)
    if thermal and env:
        # tpulbm's thermal kernel takes x rings where the mesh cuts x only
        assert chunk.mode == "one-device"
        return
    assert chunk.mode == ("tiled" if shape[1] > 1 or env else "rows")
    want = make_chunk_fn(problem, cuda, 12)(f.clone())
    step_cuda.reset_launch_counts()
    got = sharded_step.gather(chunk(sharded_step.split(mesh, f)))
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())
    wrapper, depth = ((step_thermal_cuda.collide_stream_thermal_rings, 1)
                      if thermal else
                      (step_multiphase_cuda.collide_stream_multiphase_rings,
                       step_multiphase_cuda.DEPTH))
    mode = step_torch.collision_mode(problem)
    assert step_cuda.launches_by_shard(wrapper) == {
        (mode, depth, idx): 12 for idx in mesh.shards()}
    # one launch per shard against its plain ring step
    blocks = sharded_step.split(mesh, f)
    rings = halo.exchange(blocks, eq_ring=problem.ghost_ring_values(),
                          depth=depth, periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y,
                          x_rings=chunk.mode == "tiled")
    local = sharded_step.block_shape(problem, mesh)
    consts = (step_thermal_cuda.ThermalConstants if thermal
              else step_multiphase_cuda.MultiphaseConstants).of(problem)
    make_plain = (step_thermal.make_ring_step_thermal if thermal
                  else step_multiphase.make_ring_step_multiphase)
    eq = torch.as_tensor(problem.ghost_ring_values(), dtype=torch.float32,
                         device=cuda).reshape(-1, 1, 1)
    for iy, ix in mesh.shards():
        shard = step_cuda.Shard(
            index=(iy, ix), origin=sharded_step.origin(mesh, local, iy, ix),
            local_shape=local, grid=problem.spatial_shape, depth=depth,
            x_rings=chunk.mode == "tiled")
        out = wrapper(blocks[iy][ix], torch.empty_like(blocks[iy][ix]),
                      rings[iy][ix], shard, consts)
        plain = make_plain(problem, shard.origin, local, cuda)(
            blocks[iy][ix], *rings[iy][ix])
        torch.testing.assert_close(out, plain, **ONE_STEP_TOL)
        eq_rings = tuple(None if r is None else eq.expand(r.shape)
                         .contiguous() for r in rings[iy][ix])
        off = wrapper(blocks[iy][ix], torch.empty_like(blocks[iy][ix]),
                      eq_rings, shard, consts)
        assert float((off - plain).abs().max()) > 1e-4


# ---- the Bouzidi remainder: the D3Q27 Bouzidi sphere and the slab ----------

def _bz27_problem(nx=40, ny=24, nz=24, spin=False, **kw):
    problem = _bz_problem(nx, ny, nz, lattice3d="d3q27", **kw)
    if spin:   # the sphere spinning about z at the inlet speed
        import dataclasses
        p = problem.params
        c = np.array([p.get_cylinder_x(), p.get_cylinder_y(), nz // 2])
        om = 0.05 / float(p.get_cylinder_radius_cells())
        problem = dataclasses.replace(
            problem, obstacle_velocity=lambda q: np.stack(
                [-om * (q[..., 1] - c[1]), om * (q[..., 0] - c[0]),
                 np.zeros_like(q[..., 0])], axis=-1))
    return problem


@pytest.mark.parametrize("spin", [False, True], ids=["still", "spinning"])
@pytest.mark.parametrize("op", ["bgk", "trt", "regularized", "les",
                                "power_law"])
def test_bouzidi_d3q27_kernels_match_plain_and_each_other(cuda, op, spin):
    if spin and op != "bgk":
        pytest.skip("the spinning sphere runs under BGK")
    problem = _bz27_problem(spin=spin, **OPERATORS_3D[op][0])
    consts = step_cuda.kernel_constants(problem, 19)
    assert consts.library.endswith("+bouzidi+d3q27")
    f = state_from_numpy(_perturbed_state(problem, 4), problem, cuda)
    one = step_cuda.make_local_step_cuda_3d(problem, cuda)
    got = one(f, torch.empty_like(f))
    want = step_torch.make_step_rolled(problem, cuda)(f)
    tol = dict(rtol=1e-4, atol=1e-7) if op == "power_law" else ONE_STEP_TOL
    torch.testing.assert_close(got, want, **tol)
    for n in step_cuda.BLOCKED_DEPTHS_3D:
        g = f.clone()
        for _ in range(n):
            g = one(g, torch.empty_like(g))
        got_n = step_cuda.make_local_step_cuda_3d_blocked(problem, cuda, n)(
            f, torch.empty_like(f))
        assert torch.equal(got_n, g), n


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_bouzidi_d3q27_ring_kernels_equal_one_device(cuda, monkeypatch,
                                                     shape):
    from tpulbm_torch.parallel import sharded_step
    from tpulbm_torch.parallel.mesh import make_mesh
    for k in ("TPULBM_SUBSTEPS", "TPULBM_NO_FUSED2", "TPULBM_FORCE_XHALO"):
        monkeypatch.delenv(k, raising=False)
    problem = _bz27_problem(48, 32, 16)
    f = state_from_numpy(_perturbed_state(problem, 6), problem, cuda)
    mesh = make_mesh(shape, devices=[cuda] * (shape[0] * shape[1]))
    chunk = sharded_step.make_chunk_fn(problem, mesh, 5)
    assert chunk.pallas3d_depths == ([1] if shape[1] > 1 else [3, 2])
    got = sharded_step.gather(chunk(sharded_step.split(mesh, f)))
    want = make_chunk_fn(problem, cuda, 5)(f.clone())
    assert torch.equal(got, want)


def _slab_problem(nx, ny, bc="bouzidi", qb=0.25, qt=0.75, force=2e-6,
                  moving=0.0, **kw):
    """tpulbm's solid-slab channel (tests/test_bouzidi.py:68-91) built as
    its gates build it, the collision's fields from the channel's
    builder."""
    import dataclasses
    base = make_problem(SimulationParams(
        problem="poiseuille", nx=nx, ny=ny, tau=0.8, periodic_x=True,
        inlet_velocity=0.0, obstacle_bc=bc, body_force=(force, 0.0), **kw))
    solid = np.zeros((ny, nx), bool)
    solid[:2] = solid[-2:] = True
    y0, y1 = 2.0 - qb, ny - 3.0 + qt
    return dataclasses.replace(
        base, solid=solid, init_u=(0.0, 0.0), walls_y=False, obstacle_bc=bc,
        obstacle_sdf=lambda p: np.minimum(p[..., 1] - y0, y1 - p[..., 1]),
        obstacle_velocity=(lambda p: np.stack(
            [np.where(p[..., 1] > ny / 2, moving, 0.0),
             np.zeros_like(p[..., 0])], axis=-1)) if moving else None,
        body_force=(force, 0.0) if force else ())


SLAB_CASES = {
    "bouzidi": {}, "bouzidi-far": dict(qb=0.9, qt=0.1),
    "couette": dict(qb=0.9, qt=0.1, force=0.0, moving=0.05),
    "bounce-back": dict(bc="bounce_back"),
    "equilibrium": dict(bc="equilibrium"),
    "trt": dict(collision="trt"), "kbc": dict(collision="kbc"),
    "power-law": dict(power_law_n=0.7),
}


@pytest.mark.parametrize("case", sorted(SLAB_CASES))
@pytest.mark.parametrize("nx,ny", [(100, 37), (17, 24), (2048, 512)])
def test_slab_kernels_match_plain_and_each_other(cuda, case, nx, ny):
    problem = _slab_problem(nx, ny, **SLAB_CASES[case])
    consts = step_cuda.kernel_constants(problem)
    assert "+channel+slab" in consts.library
    f = state_from_numpy(_perturbed_state(problem, 5), problem, cuda)
    one = step_cuda.make_local_step_cuda(problem, cuda)
    got = one(f, torch.empty_like(f))
    want = step_torch.make_step_rolled(problem, cuda)(f)
    if case == "kbc":
        assert float((got - want).abs().max() / want.abs().max()) < 3e-5
    else:
        tol = (dict(rtol=1e-4, atol=1e-7) if case == "power-law"
               else ONE_STEP_TOL)
        torch.testing.assert_close(got, want, **tol)
    for n in step_cuda.BLOCKED_DEPTHS:
        g = f.clone()
        for _ in range(n):
            g = one(g, torch.empty_like(g))
        got_n = step_cuda.make_local_step_cuda_blocked(problem, cuda, n)(
            f, torch.empty_like(f))
        assert torch.equal(got_n, g), n


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("case", ["bouzidi", "couette", "bounce-back"])
def test_slab_ring_kernels_equal_one_device(cuda, monkeypatch, case, shape):
    from tpulbm_torch.parallel import sharded_step
    from tpulbm_torch.parallel.mesh import make_mesh
    for k in ("TPULBM_HALO_OVERLAP", "TPULBM_SUBSTEPS", "TPULBM_NO_FUSED2",
              "TPULBM_FORCE_TILED"):
        monkeypatch.delenv(k, raising=False)
    problem = _slab_problem(100, 64, **SLAB_CASES[case])
    f = state_from_numpy(_perturbed_state(problem, 7), problem, cuda)
    mesh = make_mesh(shape, devices=[cuda] * (shape[0] * shape[1]))
    chunk = sharded_step.make_chunk_fn(problem, mesh, 24)
    got = sharded_step.gather(chunk(sharded_step.split(mesh, f)))
    want = make_chunk_fn(problem, cuda, 24)(f.clone())
    assert torch.equal(got, want)
    bz = problem.obstacle_bc == "bouzidi"
    assert chunk.substeps == (1 if shape[1] > 1 and bz else 4)


# The deep builds (-DTPULBM_DEEP=1, the depths only TPULBM_SUBSTEPS asks
# for): 2-D N = 5-8 on ragged grids, one smaller than the 32x16 tile and
# the clean corners on 33 rows (the shifted tiling); 3-D N = 4-8 on a
# ragged sphere, D3Q27 at 8 with its rings in the scratch buffer; each
# bitwise N launches of the 1-step kernel, counted at its depth
@pytest.mark.parametrize("n_sub", step_cuda.DEEP_DEPTHS)
@pytest.mark.parametrize("kw", [
    dict(nx=100, ny=37), dict(nx=20, ny=11),
    dict(nx=64, ny=33, collision="trt", zou_he_corners="clean")])
def test_deep_kernel_equals_n_one_step_launches(cuda, kw, n_sub):
    problem = make_problem(SimulationParams(tau=0.55, inlet_velocity=0.05,
                                            **kw))
    f = state_from_numpy(_perturbed_state(problem, kw["nx"]), problem, cuda)
    bstep = step_cuda.make_local_step_cuda_blocked(problem, cuda, n_sub)
    kstep = step_cuda.make_local_step_cuda(problem, cuda)
    before = step_cuda.launches(step_cuda.collide_stream_blocked)
    got = bstep(f, torch.empty_like(f))
    after = step_cuda.launches(step_cuda.collide_stream_blocked)
    assert after[n_sub] == before.get(n_sub, 0) + 1
    want = f.clone()
    for _ in range(n_sub):
        want = kstep(want, torch.empty_like(want))
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("n_sub", step_cuda.DEEP_DEPTHS_3D)
@pytest.mark.parametrize("lattice", ["d3q19", "d3q27"])
def test_deep_kernel_3d_equals_n_one_step_launches(cuda, lattice, n_sub):
    problem = make_problem(SimulationParams(
        problem="cylinder3d", nx=40, ny=21, nz=12, tau=0.6,
        inlet_velocity=0.05, lattice3d=lattice))
    f = state_from_numpy(_perturbed_state(problem, n_sub), problem, cuda)
    bstep = step_cuda.make_local_step_cuda_3d_blocked(problem, cuda, n_sub)
    kstep = step_cuda.make_local_step_cuda_3d(problem, cuda)
    got = bstep(f, torch.empty_like(f))
    want = f.clone()
    for _ in range(n_sub):
        want = kstep(want, torch.empty_like(want))
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


def test_lab_kernel_matches_plain_lab(cuda):
    from tpulbm_torch.utils import kernel_lab as lab
    gen = torch.Generator(device=cuda).manual_seed(3)
    f = torch.rand((19, 70, 13 + 2 * lab.H, 40), generator=gen,
                   device=cuda) * 0.06 + 0.02
    for variant in lab.VARIANTS:
        before = lab.lab_step.launches[variant]
        got = lab.chained(f, variant, 3)
        assert lab.lab_step.launches[variant] == before + 3
        want = f.clone()
        for _ in range(3):
            want = lab.plain_lab(want, variant)
        torch.testing.assert_close(got, want, **lab.TOL)
