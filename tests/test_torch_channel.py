"""The body-forced Poiseuille channel, the lid-driven cavity, the
bounce-back obstacle and the 3-D duct against tpulbm, on the CPU.

* the plain step (ops/step_torch.py) against tpulbm's make_step_rolled in
  f64 at rtol 1e-12: the 2-D channel under all seven collisions with a
  body force, the cavity (BGK, MRT), the cylinder with the bounce-back
  obstacle and a body force, the 3-D duct (BGK, TRT, MRT) and the sphere
  with the bounce-back obstacle;
* the force samples under the bounce-back obstacle against tpulbm's
  forces_fn, and the momentum exchange across a periodic x edge;
* the cavity's rest state as a fixed point and the step's degree-1
  homogeneity (tests/test_cavity.py:132-177);
* the Runner's artifacts against tpulbm's Runner on a 32x32 channel, a
  24x24 cavity (its total mass pinned at 24·24 in f64) and an 8x17x17
  duct, the Runner's launch plan per domain, the CLI and checkpoints;
* the kernels' edge code (csrc/d2q9_common.cuh, d3q19_common.cuh) built
  for the host with g++ and stepped cell by cell (collide, pull, boundary
  sequence, as the 1-step kernels do) against the plain step in float32:
  the periodic pull, the side walls, the lid, the cavity's corners, the
  source and the bounce-back obstacle.

The kernel module against tpulbm's Pallas kernels in interpret mode is
tests/test_torch_channel_pallas.py.
"""
import dataclasses
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.models import poiseuille as jpois
from tpulbm.ops import forces as jforces
from tpulbm.ops.step_jax import make_step_rolled as jax_step_rolled
from tpulbm.runner import Runner as JaxRunner
from tpulbm.utils import checkpoint as jckpt
from tpulbm_torch import physics
from tpulbm_torch.convert import (load_tpulbm_checkpoint, state_from_numpy,
                                  state_to_numpy)
from tpulbm_torch.models import cavity, poiseuille
from tpulbm_torch.ops import forces, step_cuda, step_torch
from tpulbm_torch.ops.step_torch import make_step_rolled
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import cuda_build
from test_torch_compat import port_params, port_problem

F64_TOL = dict(rtol=1e-12, atol=0.0)
F32_TOL = dict(rtol=5e-6, atol=1e-7)
# the cavity's corner residual cancels ~0.5-sized terms (tests/test_cavity.py)
CAVITY_TOL = dict(rtol=2e-5, atol=5e-7)
PLAW_TOL = dict(rtol=1e-4, atol=1e-7)

CHANNEL = dict(problem="poiseuille", nx=16, ny=12, tau=0.8,
               inlet_velocity=0.0, body_force=(1e-4, 2e-5))
CAVITY = dict(problem="cavity", nx=12, ny=12, tau=0.7, inlet_velocity=0.1,
              cylinder_radius=0.0)
CYLINDER_BB = dict(nx=48, ny=24, tau=0.6, inlet_velocity=0.05,
                   obstacle_bc="bounce_back", body_force=(1e-5, 1e-5))
DUCT = dict(problem="poiseuille", nx=8, ny=9, nz=7, tau=0.8,
            inlet_velocity=0.0, body_force=(1e-4, 0.0, 1e-5))
SPHERE_BB = dict(problem="cylinder3d", nx=16, ny=10, nz=8, tau=0.6,
                 inlet_velocity=0.05, obstacle_bc="bounce_back")
COLLISIONS_2D = {"bgk": {}, "trt": dict(collision="trt"),
                 "mrt": dict(collision="mrt"),
                 "regularized": dict(collision="regularized"),
                 "kbc": dict(collision="kbc"), "les": dict(smagorinsky=0.17),
                 "power_law": dict(power_law_n=0.7)}
CASES = {
    **{f"channel_{op}": dict(CHANNEL, **kw)
       for op, kw in COLLISIONS_2D.items()},
    "cavity_bgk": CAVITY, "cavity_mrt": dict(CAVITY, collision="mrt"),
    "cylinder_bounce_back_force": CYLINDER_BB,
    "duct_bgk": DUCT, "duct_trt": dict(DUCT, collision="trt"),
    "duct_mrt": dict(DUCT, collision="mrt"),
    "sphere_bounce_back": SPHERE_BB,
}


def _params(precision="f64", **kw):
    return SimulationParams(precision=precision, **kw)


def _noisy(problem, seed, spread=0.1):
    """The initial state times seeded noise in 1 ± spread, solid cells
    included (a bounce-back solid holds populations of its own)."""
    rng = np.random.default_rng(seed)
    f = problem.initial_state()
    return (f * rng.uniform(1 - spread, 1 + spread, f.shape)).astype(f.dtype)


# ---- models ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["channel", "cavity", "duct"])
def test_problem_fields_match_tpulbm(name):
    kw = {"channel": CHANNEL, "cavity": CAVITY, "duct": DUCT}[name]
    params = _params(**kw)
    mine, ref = port_problem(params), jax_problem(params)
    for field in ("walls_x", "walls_y", "walls_z", "lid_u", "closed_box",
                  "periodic_x", "body_force", "init_u", "obstacle_bc"):
        assert getattr(mine, field) == getattr(ref, field), field
    assert mine.solid is None and ref.solid is None
    assert mine.initial_state().tobytes() == ref.initial_state().tobytes()


def test_default_forces_and_analytic_profiles_match_tpulbm():
    for kw in (dict(problem="poiseuille", nx=8, ny=33, tau=0.7),
               dict(problem="poiseuille", nx=8, ny=21, tau=0.9,
                    power_law_n=0.7, body_force=(3e-6, 0.0)),
               dict(problem="poiseuille", nx=8, ny=12, nz=9, tau=0.8)):
        params = _params(**kw)
        assert port_problem(params).body_force == \
            jax_problem(params).body_force
        pp = port_params(params)
        for mine, ref in ((poiseuille.analytic_profile,
                           jpois.analytic_profile),
                          (poiseuille.analytic_profile_power_law,
                           jpois.analytic_profile_power_law)):
            np.testing.assert_array_equal(mine(pp), ref(params))
        if params.is_3d:
            np.testing.assert_array_equal(
                poiseuille.analytic_profile_duct(pp),
                jpois.analytic_profile_duct(params))
    from tpulbm.models.cavity import tau_for_cavity_reynolds
    assert cavity.tau_for_cavity_reynolds(1000.0, 0.1, 1024) == \
        tau_for_cavity_reynolds(1000.0, 0.1, 1024)


def test_cavity_refuses_what_tpulbm_refuses():
    for kw, msg in ((dict(CAVITY, nx=16), "square"),
                    (dict(CAVITY, nz=4), "2-D")):
        with pytest.raises(ValueError, match=msg):
            jax_problem(_params(**kw))
        with pytest.raises(ValueError, match=msg):
            port_problem(_params(**kw))


def test_equilibrium_with_force_matches_tpulbm():
    from tpulbm import physics as jphys
    from tpulbm.lattice import D2Q9 as JD2Q9
    from tpulbm_torch.lattice import D2Q9
    rng = np.random.default_rng(5)
    rho = 1.0 + 0.1 * rng.standard_normal((6, 7))
    u = 0.05 * rng.standard_normal((2, 6, 7))
    got = physics.equilibrium_with_force(D2Q9, torch.from_numpy(rho),
                                         torch.from_numpy(u), (1e-3, -2e-4))
    want = jphys.equilibrium_with_force(JD2Q9, jnp.asarray(rho),
                                        jnp.asarray(u), (1e-3, -2e-4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)


# ---- the plain step against tpulbm's jax tier, f64 ------------------------

@pytest.mark.parametrize("case", CASES)
def test_plain_step_matches_jax_rolled_f64(case):
    params = _params(**CASES[case])
    jstep = jax.jit(jax_step_rolled(jax_problem(params)))
    problem = port_problem(params)
    tstep = make_step_rolled(problem, "cpu")
    fj = _noisy(problem, 21)
    ft = state_from_numpy(fj, problem, "cpu")
    for _ in range(30):
        fj = jstep(fj)
        ft = tstep(ft)
    np.testing.assert_allclose(state_to_numpy(ft), np.asarray(fj), **F64_TOL)


@pytest.mark.parametrize("case", ["cylinder_bounce_back_force",
                                  "sphere_bounce_back"])
def test_forces_under_bounce_back_match_tpulbm(case):
    params = _params(**CASES[case])
    problem, jproblem = port_problem(params), jax_problem(params)
    f = _noisy(problem, 13)
    got = forces.forces_fn(problem, "cpu")(torch.from_numpy(f))
    want = jforces.forces_fn(jproblem)(jnp.asarray(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-15)
    # the collision skips the solid cells, as tpulbm's _collide_block does
    from tpulbm.ops.step_jax import _collide_block
    solid = torch.from_numpy(problem.solid)
    post = step_torch.collide_block(problem, torch.from_numpy(f), solid)
    np.testing.assert_allclose(
        post.numpy(), np.asarray(_collide_block(jproblem, jnp.asarray(f),
                                                jnp.asarray(problem.solid))),
        **F64_TOL)
    assert torch.equal(post[:, solid], torch.from_numpy(f)[:, solid])


def test_momentum_exchange_pairs_across_a_periodic_x_edge():
    # a solid block on the x = 0 column: on a periodic x axis its fluid
    # neighbours at x = nx-1 exchange momentum with it, as in tpulbm; on a
    # bounded one they do not
    params = _params(nx=16, ny=12, tau=0.7, inlet_velocity=0.05)
    solid = np.zeros((12, 16), bool)
    solid[4:8, 0] = True
    f = _noisy(port_problem(params), 9)
    results = []
    for periodic in (True, False):
        mine = dataclasses.replace(port_problem(params), solid=solid,
                                   periodic_x=periodic)
        ref = dataclasses.replace(jax_problem(params), solid=solid,
                                  periodic_x=periodic)
        got = forces.momentum_exchange(mine, torch.from_numpy(f),
                                       torch.from_numpy(solid))
        want = jforces.momentum_exchange(ref, jnp.asarray(f),
                                         jnp.asarray(solid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-15)
        # the masks built once give the same bits as built per call
        masks = forces.shifted_masks(mine, torch.from_numpy(solid))
        again = forces.momentum_exchange(mine, torch.from_numpy(f),
                                         torch.from_numpy(solid), masks)
        assert torch.equal(got, again)
        results.append(got)
    assert not torch.equal(results[0], results[1])


# ---- the cavity's invariants (tests/test_cavity.py:132-177) ---------------

def test_cavity_rest_state_is_fixed_point():
    params = _params(problem="cavity", nx=16, ny=16, inlet_velocity=0.0,
                     tau=0.8, cylinder_radius=0.0)
    problem = port_problem(params)
    assert problem.closed_box
    step = make_step_rolled(problem, "cpu")
    f0 = state_from_numpy(problem.initial_state(), problem, "cpu")
    f = f0
    for _ in range(40):
        f = step(f)
    np.testing.assert_allclose(f.numpy(), f0.numpy(), atol=1e-14)


def test_cavity_step_is_degree_one_homogeneous():
    params = _params(problem="cavity", nx=24, ny=24, inlet_velocity=0.1,
                     tau=cavity.tau_for_cavity_reynolds(100.0, 0.1, 24),
                     cylinder_radius=0.0)
    problem = port_problem(params)
    step = make_step_rolled(problem, "cpu")
    f = state_from_numpy(problem.initial_state(), problem, "cpu")
    for _ in range(30):
        f = step(f)
    lam = 0.7
    np.testing.assert_allclose(step(lam * f).numpy(), lam * step(f).numpy(),
                               rtol=1e-12, atol=1e-15)


# ---- the Runner against tpulbm's -------------------------------------------

RUNNER_CASES = {
    "channel": dict(problem="poiseuille", nx=32, ny=32, tau=0.8,
                    inlet_velocity=0.0, body_force=(2e-6, 0.0)),
    "cavity": dict(problem="cavity", nx=24, ny=24, inlet_velocity=0.1,
                   tau=cavity.tau_for_cavity_reynolds(100.0, 0.1, 24),
                   cylinder_radius=0.0),
    "duct": dict(problem="poiseuille", nx=8, ny=17, nz=17, tau=0.8,
                 inlet_velocity=0.0, body_force=(2e-6, 0.0)),
}


def _runner_params(tmp, case, **kw):
    d = dict(RUNNER_CASES[case], num_timesteps=60, output_frequency=5,
             output_dir=str(tmp), backend="jax", precision="f32",
             enable_vtk=False)
    d.update(kw)
    return SimulationParams(**d)


def _table(path):
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def _assert_fields_close(got_dir, ref_dir, params, rtol=1e-5, atol=5e-6):
    if params.is_3d:
        g, r = (np.load(d / "fields3d.npz") for d in (got_dir, ref_dir))
        for name in ("rho", "ux", "uy", "uz"):
            np.testing.assert_allclose(g[name], r[name], rtol=rtol,
                                       atol=atol, err_msg=name)
        return
    vg, vr = (_table(d / "velocity_field.csv") for d in (got_dir, ref_dir))
    assert vg.shape == vr.shape == (params.nx * params.ny, 6)
    np.testing.assert_array_equal(vg[:, :2], vr[:, :2])
    np.testing.assert_allclose(vg, vr, rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", RUNNER_CASES)
def test_runner_artifacts_match_tpulbm(tmp_path, case):
    # 60 steps every 5: one super-chunk of 8 intervals, then the tail; the
    # port's kernel module (its CPU path) against tpulbm's jax tier in f32
    ref = _runner_params(tmp_path / "ref", case)
    assert JaxRunner(ref, verbose=False).run().success
    got = _runner_params(tmp_path / "port", case, backend="pallas")
    result = Runner(port_params(got), device="cpu", verbose=False).run()
    assert result.success and result.final_step == 60
    assert result.stats is None
    assert not (tmp_path / "port" / "forces.csv").exists()
    _assert_fields_close(tmp_path / "port", tmp_path / "ref", got)


def test_runner_pins_the_cavity_mass_f64(tmp_path):
    # tests/test_cavity.py:173-177 through the port's Runner: the mass after
    # 800 steps (a super-chunk and tail chunks, each renormalized) is 24·24
    params = _runner_params(tmp_path, "cavity", precision="f64",
                            num_timesteps=800, output_frequency=100,
                            checkpoint_every=1)
    result = Runner(port_params(params), device="cpu", verbose=False).run(
        resume=False)
    assert result.success
    step, f = jckpt.load(jckpt.latest(str(tmp_path / params.checkpoint_dir)))
    assert step == 800
    np.testing.assert_allclose(float(np.sum(f)), 24.0 * 24.0, rtol=1e-10)
    # without the gauge the walls drift the mass
    problem = port_problem(params)
    stepf = make_step_rolled(problem, "cpu")
    g = state_from_numpy(problem.initial_state(), problem, "cpu")
    for _ in range(200):
        g = stepf(g)
    assert abs(float(g.sum()) - 576.0) > 1e-8


@pytest.mark.parametrize("case", ["channel", "cavity"])
def test_runner_launch_plan_2d(monkeypatch, tmp_path, case):
    # the main path's cadence: 2240 steps every 140 run 525 N=4 and 140
    # 1-step launches, all of the domain's own library (the state is held)
    for k in ("TPULBM_NO_FUSED2", "TPULBM_SUBSTEPS"):
        monkeypatch.delenv(k, raising=False)
    launches = {}
    for name in ("collide_stream", "collide_stream_blocked"):
        def spy(f, out, solid, consts, *rest, _name=name):
            depth = rest[0] if _name.endswith("blocked") else 1
            key = (consts.library, depth)
            launches[key] = launches.get(key, 0) + 1
            return out.copy_(f)
        monkeypatch.setattr(step_cuda, name, spy)
    params = _runner_params(tmp_path, case, nx=12, ny=12, num_timesteps=2240,
                            output_frequency=140, backend="pallas")
    result = Runner(port_params(params), device="cpu", verbose=False).run()
    assert result.success and result.final_step == 2240
    library = {"channel": "bgk+channel+source", "cavity": "bgk+cavity"}[case]
    assert launches == {(library, 4): 525, (library, 1): 140}


def test_runner_launch_plan_duct(monkeypatch, tmp_path):
    for k in ("TPULBM_NO_FUSED2", "TPULBM_SUBSTEPS"):
        monkeypatch.delenv(k, raising=False)
    launches = {}
    for name in ("collide_stream_3d", "collide_stream_3d_blocked"):
        def spy(f, out, solid, consts, *rest, _name=name):
            depth = rest[0] if _name.endswith("blocked") else 1
            key = (consts.library, depth)
            launches[key] = launches.get(key, 0) + 1
            return out.copy_(f)
        monkeypatch.setattr(step_cuda, name, spy)
    params = _runner_params(tmp_path, "duct", nx=8, ny=6, nz=4,
                            num_timesteps=2240, output_frequency=140,
                            backend="pallas")
    result = Runner(port_params(params), device="cpu", verbose=False).run()
    assert result.success
    lib = "bgk+duct+source"
    assert launches == {(lib, 3): 735, (lib, 2): 17, (lib, 1): 1}


@pytest.mark.parametrize("case", ["channel", "cavity", "duct"])
def test_tpulbm_checkpoint_continues_in_the_port(tmp_path, case):
    # a state tpulbm's Runner wrote, loaded and continued by the port's,
    # equal to tpulbm's straight run at the artifact tolerance
    kw = dict(precision="f32", num_timesteps=40, output_frequency=10)
    straight = _runner_params(tmp_path / "straight", case, **kw)
    assert JaxRunner(straight, verbose=False).run().success
    half = _runner_params(tmp_path / "moved", case, checkpoint_every=1,
                          **{**kw, "num_timesteps": 20})
    assert JaxRunner(half, verbose=False).run().success
    path = jckpt.latest(str(tmp_path / "moved" / half.checkpoint_dir))
    step, f = load_tpulbm_checkpoint(path, port_params(half), "cpu")
    assert step == 20 and f.shape[0] == (19 if half.is_3d else 9)
    result = Runner(port_params(half.replace(num_timesteps=40,
                                             backend="pallas")),
                    device="cpu", verbose=False).run(resume=True)
    assert result.success and result.final_step == 40
    _assert_fields_close(tmp_path / "moved", tmp_path / "straight", straight)


@pytest.mark.parametrize("argv", [
    ["--problem", "poiseuille", "--nx", "16", "--ny", "12", "--tau", "0.8",
     "--collision", "mrt"],
    ["--preset", "cavity", "--nx", "16", "--ny", "16"],
    ["--nx", "48", "--ny", "24", "--obstacle-bc", "bounce_back"]],
    ids=["channel_mrt", "cavity", "cylinder_bounce_back"])
def test_cli_runs_the_new_problems_on_the_cpu(tmp_path, argv):
    from tpulbm_torch.__main__ import main
    assert main([*argv, "--cpu", "--num-timesteps", "20",
                 "--output-frequency", "10", "--no-vtk", "--output-dir",
                 str(tmp_path)]) == 0
    field = _table(tmp_path / "velocity_field.csv")
    assert np.isfinite(field).all()
    assert (tmp_path / "forces.csv").exists() == ("bounce_back" in argv)


# ---- the kernel module's domains -------------------------------------------

@pytest.mark.parametrize("case,library", [
    ("channel_bgk", "bgk+channel+source"),
    ("channel_mrt", "mrt+channel+source"),
    ("cavity_bgk", "bgk+cavity"),
    ("cylinder_bounce_back_force", "bgk+source+bounce_back"),
    ("duct_trt", "trt+duct+source"),
    ("sphere_bounce_back", "bgk+bounce_back")])
def test_step_constants_pick_the_library(case, library):
    problem = port_problem(_params(precision="f32", **CASES[case]))
    consts = step_cuda.StepConstants.of(problem)
    assert consts.library == library
    defines = step_cuda.build_defines(consts.mode, consts.variant)
    assert ("-DTPULBM_DOMAIN=1" in defines) == ("channel" in library
                                               or "duct" in library)
    assert ("-DTPULBM_DOMAIN=2" in defines) == ("cavity" in library)
    assert ("-DTPULBM_SOURCE=1" in defines) == bool(problem.body_force)
    assert ("-DTPULBM_BOUNCE_BACK=1" in defines) == ("bounce" in library)
    src = np.array(consts.src or (0.0,) * problem.lattice.Q)
    want = (physics.force_source(problem.lattice, problem.body_force)
            if problem.body_force else np.zeros(problem.lattice.Q))
    np.testing.assert_array_equal(src, want)
    if problem.lid_u:
        # 6 w_i (c_i · u_lid) of tpulbm's apply_moving_wall for i = 7, 8
        np.testing.assert_allclose(consts.lid, (-0.1 / 6.0, 0.1 / 6.0),
                                   rtol=1e-15)


def test_the_cylinder_bgk_library_takes_no_define():
    problem = port_problem(_params(precision="f32", nx=48, ny=24))
    consts = step_cuda.StepConstants.of(problem)
    assert consts.variant == 0 and consts.library == "bgk"
    assert step_cuda.build_defines(consts.mode, consts.variant) == ()


def test_kernels_refuse_layouts_they_do_not_hold():
    channel = port_problem(_params(precision="f32", **CHANNEL))
    solid = np.zeros(channel.spatial_shape, bool)
    solid[3, 4] = True
    for bad in (dataclasses.replace(channel, solid=solid),
                dataclasses.replace(channel, walls_y=False),
                dataclasses.replace(channel, periodic_y=True)):
        with pytest.raises(NotImplementedError, match="boundary layout"):
            step_cuda.make_local_step_cuda(bad, "cpu")
    tiny = port_problem(_params(precision="f32", **dict(CAVITY, nx=2, ny=2)))
    with pytest.raises(ValueError, match=">= 3"):
        step_cuda.make_local_step_cuda(tiny, "cpu")
    duct = port_problem(_params(precision="f32", **DUCT))
    with pytest.raises(NotImplementedError):
        step_cuda.make_local_step_cuda(duct, "cpu")     # a D2Q9 wrapper
    step = step_cuda.make_local_step_cuda_3d(duct, "cpu")
    f = state_from_numpy(duct.initial_state(), duct, "cpu")
    before = step_cuda.launches(step_cuda.collide_stream_3d)
    out = step(f, torch.empty_like(f))
    assert step_cuda.launches(step_cuda.collide_stream_3d) == before  # CPU
    assert torch.equal(out, make_step_rolled(duct, "cpu")(f))


def test_launch_counts_are_kept_per_library():
    consts = step_cuda.StepConstants.of(port_problem(_params(
        precision="f32", **CHANNEL)))
    step_cuda.reset_launch_counts()
    step_cuda._count(step_cuda.collide_stream, consts.library)
    step_cuda._count(step_cuda.collide_stream, "mrt")
    for _ in range(2):
        step_cuda._count(step_cuda.collide_stream_blocked, consts.library, 4)
    assert step_cuda.collide_stream.launches_by_library == {
        "bgk+channel+source": 1, "mrt": 1}
    assert step_cuda.collide_stream_blocked.launches_by_library == {
        "bgk+channel+source": {2: 0, 3: 0, 4: 2}}
    # the per-mode and total counts are sums of the per-library one
    by_mode = step_cuda.launches_by_mode(step_cuda.collide_stream)
    assert by_mode == dict.fromkeys(step_cuda.COLLISION_MODES, 0) | {
        "bgk": 1, "mrt": 1}
    assert step_cuda.launches(step_cuda.collide_stream) == 2
    assert step_cuda.launches_by_mode(
        step_cuda.collide_stream_blocked)["bgk"] == {2: 0, 3: 0, 4: 2}
    assert step_cuda.launches(step_cuda.collide_stream_blocked) == {
        2: 0, 3: 0, 4: 2}
    step_cuda.reset_launch_counts()
    assert step_cuda.collide_stream.launches_by_library == {}
    assert step_cuda.launches(step_cuda.collide_stream_blocked) == {
        2: 0, 3: 0, 4: 0}


# ---- the kernels' edge code on the host ------------------------------------

# One step of csrc/d2q9_common.cuh or d3q19_common.cuh built for the host
# (the CUDA qualifiers defined away, g++ without contraction as nvcc's
# -fmad=false): every cell collided (collide_cell: the source, the
# bounce-back skip), then per cell the pull (post() reads the collided
# values, wrapping x in the periodic domain) and the domain's boundary
# sequence, as the 1-step kernels do with their shared tiles.
_HOST_STEP = r"""
#define __device__
#define __forceinline__ inline
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <vector>
#include "HEADER"
#if Q3
namespace k_ = tpulbm3d;
constexpr int kConsts = 1 + 3 * 19;
#else
namespace k_ = tpulbm;
constexpr int kConsts = 3 + 3 * 9 + 2;
#endif
int main(int argc, char** argv) {
  const int nx = atoi(argv[1]), ny = atoi(argv[2]), nz = atoi(argv[3]);
  const bool corners = atoi(argv[4]) != 0;
  const int q = k_::kQ;
  const size_t n = (size_t)nx * ny * nz;
  std::vector<float> sc(kConsts), mode(k_::kModeFloats), solid(n), f(q * n),
      post(q * n), out(q * n);
  FILE* fp = fopen(argv[5], "rb");
  if (fread(sc.data(), 4, kConsts, fp) != (size_t)kConsts ||
      fread(mode.data(), 4, k_::kModeFloats, fp) != (size_t)k_::kModeFloats ||
      fread(solid.data(), 4, n, fp) != n ||
      fread(f.data(), 4, q * n, fp) != q * n) return 1;
  fclose(fp);
#if Q3
  const k_::Consts k = k_::make_consts(sc[0], &sc[1], &sc[20], mode.data(),
                                       &sc[39]);
#else
  const k_::StepConsts k = k_::make_consts(sc[0], sc[1], sc[2], &sc[3],
                                           &sc[12], mode.data(), &sc[21],
                                           sc[30], sc[31]);
#endif
  for (size_t c = 0; c < n; ++c) {
    float v[k_::kQ];
    for (int i = 0; i < q; ++i) v[i] = f[i * n + c];
    k_::collide_cell(v, k, tpulbm::kBounceBack && solid[c] != 0.0f);
    for (int i = 0; i < q; ++i) post[i * n + c] = v[i];
  }
  auto wrap = [&](int x) {
    return tpulbm::kPeriodicX ? ((x % nx) + nx) % nx : x;
  };
  for (int z = 0; z < nz; ++z)
    for (int y = 0; y < ny; ++y)
      for (int x = 0; x < nx; ++x) {
        const size_t c = ((size_t)z * ny + y) * nx + x;
        float g[k_::kQ];
#if Q3
        auto post_at = [&](auto i, int ox, int oy, int oz) {
          return post[decltype(i)::value * n +
                      ((size_t)(z + oz) * ny + y + oy) * nx + wrap(x + ox)];
        };
        k_::step_cell(g, [&](int ox) { return solid[c + ox] != 0.0f; }, x, y,
                      z, nx, ny, nz, k, post_at);
#else
        auto post_at = [&](int i, int dx, int dy) {
          return post[i * n + (size_t)(y + dy) * nx + wrap(x + dx)];
        };
        auto solid_at = [&](int dx, int dy) {
          return solid[(size_t)(y + dy) * nx + x + dx] != 0.0f;
        };
        k_::pull_d2q9(g, x, y, nx, ny, k, post_at);
        const bool s = tpulbm::kHasObstacle && solid[c] != 0.0f;
        if (corners)
          k_::apply_boundaries<true>(g, s, x, y, nx, ny, k, post_at, solid_at);
        else
          k_::apply_boundaries<false>(g, s, x, y, nx, ny, k, post_at,
                                      solid_at);
#endif
        for (int i = 0; i < q; ++i) out[i * n + c] = g[i];
      }
  fp = fopen(argv[6], "wb");
  fwrite(out.data(), 4, q * n, fp);
  fclose(fp);
  return 0;
}
"""

HOST_CASES = {
    "channel_bgk": CHANNEL, "channel_power_law": dict(CHANNEL,
                                                      power_law_n=0.7),
    "cavity_bgk": CAVITY, "cavity_mrt": dict(CAVITY, collision="mrt"),
    "cylinder_bounce_back_force": CYLINDER_BB,
    "cylinder_clean_corners_force": dict(nx=48, ny=24, tau=0.6,
                                         inlet_velocity=0.05,
                                         zou_he_corners="clean",
                                         body_force=(1e-5, 0.0)),
    "duct_bgk": DUCT, "sphere_bounce_back": SPHERE_BB,
    "sphere_force": dict(SPHERE_BB, obstacle_bc="equilibrium",
                         body_force=(1e-4, 0.0, 1e-5)),
}


@pytest.mark.parametrize("case", HOST_CASES)
def test_kernel_edge_code_matches_plain_step(tmp_path, case):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' edge code for the host")
    params = _params(precision="f32", **HOST_CASES[case])
    problem = port_problem(params)
    d3 = problem.lattice.D == 3
    consts = step_cuda.StepConstants.of(problem)
    src = tmp_path / "step.cpp"
    header = "d3q19_common.cuh" if d3 else "d2q9_common.cuh"
    src.write_text(_HOST_STEP.replace("HEADER", header))
    exe = tmp_path / "step"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    f"-DQ3={int(d3)}",
                    *step_cuda.build_defines(consts.mode, consts.variant),
                    "-I", str(cuda_build.SOURCE_DIR), str(src), "-o",
                    str(exe)], check=True, capture_output=True)
    f = _noisy(problem, 29)
    q = problem.lattice.Q
    if d3:
        head = [consts.inv_tau, *consts.eq_in, *consts.w,
                *(consts.src or (0.0,) * q)]
    else:
        head = [consts.inv_tau, consts.u_in, 1.0 - consts.u_in, *consts.eq_in,
                *consts.w, *(consts.src or (0.0,) * q), *consts.lid]
    solid = (np.zeros(problem.spatial_shape) if problem.solid is None
             else problem.solid)
    np.concatenate([np.array(head, np.float32),
                    np.array(consts.modes, np.float32),
                    np.asarray(solid, np.float32).ravel(),
                    f.ravel()]).tofile(tmp_path / "in.bin")
    shape = problem.spatial_shape
    nz = shape[0] if d3 else 1
    subprocess.run([str(exe), str(shape[-1]), str(shape[-2]), str(nz),
                    str(int(problem.clean_corners)), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True)
    got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(f.shape)
    want = make_step_rolled(problem, "cpu")(torch.from_numpy(f)).numpy()
    tol = (CAVITY_TOL if params.problem == "cavity" else
           PLAW_TOL if params.power_law_n != 1.0 else F32_TOL)
    np.testing.assert_allclose(got, want, **tol)
    # the edge code acts: the obstacle domain's BGK library without these
    # choices steps the same state elsewhere
    if consts.variant:
        plain_cyl = dataclasses.replace(
            problem, obstacle_bc="equilibrium", body_force=(), lid_u=0.0)
        other = make_step_rolled(plain_cyl, "cpu")(torch.from_numpy(f))
        assert not np.allclose(other.numpy(), got, **tol)
