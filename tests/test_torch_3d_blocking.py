"""The 3-D temporal blocking of the port against tpulbm's, on the CPU.

* The port's chunk against tpulbm's make_chunk_fn(backend="pallas") on a
  (1,1) mesh, its 3-D Pallas cascade (make_local_step_pallas3d_tiled) in
  interpret mode, 2 chunks, f32 at rtol 5e-6 / atol 1e-7
  (test_torch_3d.py's F32_TOL: the Pallas kernels multiply by 1/rho where
  the plain step divides): the default plan at chunk_len 7, [(3, 1),
  (2, 2)], both depths in one run; a forced N=3 on the sphere that
  reaches the outlet; a forced N=2 on the sphere that pierces the inlet.
  On the CPU the N-step wrapper runs its plain version, N plain steps.
* The plan (fn.pallas3d_depths and the segment lengths) against tpulbm's
  for chunk lengths 1-7, 139, 140 and 280, by default, with blocking off
  and with a forced depth, on grids where tpulbm's dropped TPU conditions
  (tile height >= 4 halo rows) do not bind.
* The Runner's schedule at the 3-D cell's cadence (2240 steps, output every
  140): 735 N=3, 17 N=2 and 1 one-step launches, as chip_smoke.py gates on
  the card.
* The N-step wrapper's guards and counts, and the ring layout its source
  states.
"""
import re

import jax
import numpy as np
import pytest
import torch

import tpulbm.ops.step_pallas3d as jax_pallas3d
from tpulbm.config import SimulationParams
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import _blocking_split
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state
from tpulbm.models import make_problem as jax_problem
from tpulbm_torch import stepper
from tpulbm_torch.convert import state_from_numpy, state_to_numpy
from tpulbm_torch.lattice import D3Q19
from tpulbm_torch.ops import step_cuda
from tpulbm_torch.ops.step_torch import make_step_rolled
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import cuda_build
from test_torch_3d import F32_TOL, _params
from test_torch_compat import port_params, port_problem

PLAN_LENS = [1, 2, 3, 4, 5, 6, 7, 139, 140, 280]
PLAN_ENVS = {"default": {}, "no_fused2": {"TPULBM_NO_FUSED2": "1"},
             "substeps3": {"TPULBM_SUBSTEPS": "3"},
             "substeps2": {"TPULBM_SUBSTEPS": "2"}}


def _setenv(monkeypatch, env):
    for k in ("TPULBM_NO_FUSED2", "TPULBM_SUBSTEPS", "TPULBM_FORCE_TILED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _spy_tiled(monkeypatch):
    """Record (depth, built) of every make_local_step_pallas3d_tiled."""
    built = []
    real = jax_pallas3d.make_local_step_pallas3d_tiled

    def spy(problem, shape, *args, **kw):
        st = real(problem, shape, *args, **kw)
        built.append((args[0] if args else kw.get("n_sub", 1),
                      st is not None))
        return st

    monkeypatch.setattr(jax_pallas3d, "make_local_step_pallas3d_tiled", spy)
    return built


# ---- the chunk against tpulbm's Pallas cascade ------------------------

@pytest.mark.parametrize("geometry,env,chunk_len,depths", [
    ("sphere", {}, 7, [3, 2]),
    ("outlet_reaching", {"TPULBM_SUBSTEPS": "3"}, 6, [3]),
    ("inlet_piercing", {"TPULBM_SUBSTEPS": "2"}, 4, [2])],
    ids=["default_plan", "forced3_outlet_reaching", "forced2_inlet_piercing"])
def test_chunk_matches_pallas3d_cascade(monkeypatch, geometry, env, chunk_len,
                                        depths):
    _setenv(monkeypatch, env)
    built = _spy_tiled(monkeypatch)
    params = _params(geometry, precision="f32")
    jproblem = jax_problem(params)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    ref = jax_chunk_fn(jproblem, mesh, chunk_len, backend="pallas")
    assert ref.pallas3d_depths == depths
    assert [d for d, ok in built if ok] == depths
    port = stepper.make_chunk_fn(port_problem(params), "cpu", chunk_len)
    assert port.pallas3d_depths == depths
    assert port.plan == _blocking_split(chunk_len, depths[0])
    f, solid = shard_state(mesh, jproblem.initial_state(), jproblem.solid)
    g = state_from_numpy(jproblem.initial_state(), port_problem(params),
                         "cpu")
    for k in range(2):
        f = ref(f, solid)
        g = port(g)
        np.testing.assert_allclose(state_to_numpy(g),
                                   np.asarray(jax.device_get(f)),
                                   err_msg=f"chunk {k}", **F32_TOL)


# ---- the plan against tpulbm's ----------------------------------------

@pytest.mark.parametrize("nz", [8, 3])
@pytest.mark.parametrize("env", PLAN_ENVS)
@pytest.mark.parametrize("chunk_len", PLAN_LENS)
def test_plan_matches_tpulbm(monkeypatch, chunk_len, env, nz):
    # 32x16: tpulbm's interpret-mode tile is 16 rows, at least 4 halo rows
    # at depths 2 and 3, so only the conditions the port keeps decide
    _setenv(monkeypatch, PLAN_ENVS[env])
    built = _spy_tiled(monkeypatch)
    params = _params(nz=nz, precision="f32")
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    ref = jax_chunk_fn(jax_problem(params), mesh, chunk_len,
                       backend="pallas")
    port = stepper.make_chunk_fn(port_problem(params), "cpu", chunk_len)
    assert port.pallas3d_depths == ref.pallas3d_depths
    if ref.pallas3d_depths is None:
        assert port.plan == [(1, chunk_len)]
    else:
        assert [d for d, ok in built if ok][-len(port.plan):] == \
            ref.pallas3d_depths
        assert port.plan == _blocking_split(chunk_len,
                                            ref.pallas3d_depths[0])
    assert sum(d * n for d, n in port.plan) == chunk_len


# ---- the Runner's schedule --------------------------------------------

def test_runner_schedule_launch_counts(monkeypatch, tmp_path):
    # one super-chunk of 8 x 140, seven 140-step chunks, a 139-step chunk
    # and the last step: 15 x [(3, 46), (2, 1)] + [(3, 45), (2, 2)] + 1
    _setenv(monkeypatch, {})
    launches = {1: 0, 2: 0, 3: 0}
    for name in ("collide_stream_3d", "collide_stream_3d_blocked"):
        def spy(f, out, solid, consts, *rest, _name=name):
            depth = rest[0] if _name.endswith("blocked") else 1
            launches[depth] += 1
            return out.copy_(f)   # the schedule alone: the state holds

        monkeypatch.setattr(step_cuda, name, spy)
    params = _params(nx=8, ny=6, nz=4, precision="f32", num_timesteps=2240,
                     output_frequency=140, enable_vtk=False,
                     backend="pallas", output_dir=str(tmp_path))
    result = Runner(port_params(params), device="cpu", verbose=False).run()
    assert result.success and result.final_step == 2240
    assert launches == {3: 735, 2: 17, 1: 1}
    assert sum(d * n for d, n in launches.items()) == 2240


# ---- the N-step wrapper -----------------------------------------------

def test_3d_blocked_wrapper_guards_and_counts():
    problem = port_problem(_params("ragged", precision="f32"))
    f = state_from_numpy(problem.initial_state(), problem, "cpu")
    plain = make_step_rolled(problem, "cpu")
    step_cuda.reset_launch_counts()
    for n_sub in step_cuda.BLOCKED_DEPTHS_3D:
        step = step_cuda.make_local_step_cuda_3d_blocked(problem, "cpu",
                                                         n_sub)
        want = f
        for _ in range(n_sub):
            want = plain(want)
        assert torch.equal(step(f, torch.empty_like(f)), want)
    # CPU calls run the plain version and are not counted
    wrapper = step_cuda.collide_stream_3d_blocked
    assert step_cuda.launches(wrapper) == {2: 0, 3: 0}
    step_cuda._count(wrapper, "bgk", 3)
    assert step_cuda.launches(wrapper) == {2: 0, 3: 1}
    step_cuda.reset_launch_counts()
    assert step_cuda.launches(wrapper) == {2: 0, 3: 0}
    # the deep build's depths run (N plain steps on the CPU, uncounted);
    # 1 is the 1-step kernel's and 9 above tpulbm's halo height
    for n_sub in (4, 8):
        step = step_cuda.make_local_step_cuda_3d_blocked(problem, "cpu",
                                                         n_sub)
        want = f
        for _ in range(n_sub):
            want = plain(want)
        assert torch.equal(step(f, torch.empty_like(f)), want)
    assert step_cuda.launches(wrapper) == {2: 0, 3: 0}
    for n_sub in (1, 9):
        with pytest.raises(NotImplementedError, match="2 to 8"):
            step_cuda.make_local_step_cuda_3d_blocked(problem, "cpu", n_sub)
    with pytest.raises(NotImplementedError, match="cylinder3d"):
        step_cuda.make_local_step_cuda_3d_blocked(
            port_problem(SimulationParams(nx=40, ny=20)), "cpu", 2)
    solid = torch.zeros(problem.spatial_shape, dtype=torch.uint8)
    with pytest.raises(ValueError):   # a 2-D state
        step_cuda.collide_stream_3d_blocked(
            f[:9, 0], torch.empty_like(f[:9, 0]), solid[0],
            step_cuda.StepConstants.of(problem), 2, plain)
    with pytest.raises(ValueError):   # in place
        step_cuda.collide_stream_3d_blocked(
            f, f, solid, step_cuda.StepConstants.of(problem), 3, plain)


def test_blocked_kernel_source_ring_layout():
    # the kernel shares the velocity table of d3q19_common.cuh (parsed in
    # test_torch_3d.py); its rings keep the populations pulled from plane
    # z+1 (cz = -1) one plane, those from z two, those from z-1 three
    src = (cuda_build.SOURCE_DIR / "step_d3q19_blocked.cu").read_text()
    assert '#include "d3q19_common.cuh"' in src
    assert "#define TPULBM_D3Q19" not in src
    n = {cz: int((D3Q19.c[:, 2] == cz).sum()) for cz in (-1, 0, 1)}
    assert n == {-1: 5, 0: 9, 1: 5}
    floats = n[-1] + 2 * n[0] + 3 * n[1]
    assert f"kRingFloats == {floats}" in src
    # the shared memory the source states for its tiles: of heights kBY,
    # kBY / 2, ... the first whose rings (over the region a block of its
    # cluster computes at stage k, plus the one-cell frame on the sides that
    # face the cluster), mask planes and, in a cluster, transaction barriers
    # fit a block
    knob = {k: int(re.search(rf"#define TPULBM_{k} (\d+)", src).group(1))
            for k in ("TILE_Y", "CLUSTER_X", "CLUSTER_Y")}
    cx, cy = knob["CLUSTER_X"], knob["CLUSTER_Y"]

    def smem(depth, by):
        def reach(blocks, d):
            return 2 * d if blocks == 1 else d
        cells = [(32 + reach(cx, depth - k) + (cx > 1))
                 * (by + reach(cy, depth - k) + (cy > 1))
                 for k in range(depth)]
        size = 4 * floats * sum(cells) + (depth + 2) * (
            (32 + reach(cx, depth)) * (by + reach(cy, depth)))
        return -(-size // 8) * 8 + 8 * depth if cx * cy > 1 else size

    for depth in (2, 3):
        by = knob["TILE_Y"]
        while smem(depth, by) > 232448:
            by //= 2
        assert f"32 x {by} at N={depth} ({smem(depth, by):,} B" in src, \
            (depth, by, smem(depth, by))


@pytest.mark.parametrize("name,group", [
    ("_ZN54_GLOBAL__N__8cbe8515_21_step_d3q19_blocked_cu_67758a3620d3q19_"
     "blocked_kernelILi3EEEvPKfPfPKhiiiN8tpulbm3d6ConstsE", "d3q19 N=3"),
    ("(anonymous namespace)::d3q19_blocked_kernel<2>(float const*, float*, "
     "unsigned char const*, int, int, int, tpulbm3d::Consts)", "d3q19 N=2"),
    ("_ZN46_GLOBAL__N__1aaa047d_13_step_d3q19_cu_fb47b28017d3q19_step_"
     "kernelEPKfPfPKhiiiN8tpulbm3d6ConstsE", "d3q19")])
def test_profile_groups_the_d3q19_kernels(name, group):
    from tpulbm_torch.utils.profile_run import _group
    assert _group({"cat": "kernel", "name": name}) == group
