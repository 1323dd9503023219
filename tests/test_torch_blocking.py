"""Temporal blocking in the port against tpulbm's.

* the port's chunk at a forced depth (TPULBM_SUBSTEPS = 2, 3) against
  tpulbm's make_chunk_fn(backend="pallas") at the same depth, in interpret
  mode on 128x64 with TPULBM_PALLAS_TY=8, 2 chunks, f32 at rtol 5e-6 /
  atol 1e-7 (tests/test_torch_step.py's F32_TOL: the Pallas kernels
  multiply by 1/rho where the plain step divides). N=2 reaches
  make_local_step_pallas2, N=3 make_local_step_pallasN; N=4, the main
  path's depth, is test_torch_step.py's cascade test. On the CPU the
  N-step wrapper runs its plain version, N plain steps;
* the depth choice: the port's chunk.substeps equals tpulbm's
  pallas_substeps for every chunk length the runner and bench.py use, by
  default, with blocking off and with a forced depth, on a grid where
  tpulbm's slab-count condition does not bind;
* the Runner's schedule at the main path's cadence (2800 steps, output
  every 140): 665 N=4 and 140 1-step launches, as chip_smoke.py gates on
  the card;
* make_super_chunk_fn against the per-interval diagnostics, bitwise;
* the N-step wrapper's guards.
"""
import collections

import jax
import numpy as np
import pytest
import torch

import tpulbm.ops.step_pallas as jax_step_pallas
from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.parallel.mesh import make_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm_torch import stepper
from tpulbm_torch.convert import state_from_numpy
from tpulbm_torch.ops import diagnostics, forces, step_cuda, step_torch
from tpulbm_torch.runner import Runner
from test_torch_compat import port_params, port_problem

from test_torch_step import F32_TOL, _jax_pallas_chunks, _params, _port_chunks

CHUNK_LENS = [1, 2, 3, 4, 5, 6, 9, 10, 139, 140, 280]


@pytest.mark.parametrize("n_sub", [2, 3])
def test_port_chunk_matches_pallas_cascade(monkeypatch, n_sub):
    monkeypatch.setenv("TPULBM_PALLAS_TY", "8")
    monkeypatch.setenv("TPULBM_SUBSTEPS", str(n_sub))
    built_2step = []
    real_2step = jax_step_pallas.make_local_step_pallas2

    def spy(*args, **kw):
        built_2step.append(True)
        return real_2step(*args, **kw)

    monkeypatch.setattr(jax_step_pallas, "make_local_step_pallas2", spy)
    params = _params(nx=128, ny=64)
    chunk, ref = _jax_pallas_chunks(params, n_sub, 2)
    port = stepper.make_chunk_fn(port_problem(params), "cpu", n_sub)
    assert chunk.pallas_substeps == port.substeps == n_sub
    assert bool(built_2step) == (n_sub == 2)
    got = _port_chunks(params, n_sub, 2)
    for k, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(g, r, err_msg=f"chunk {k}", **F32_TOL)


@pytest.mark.parametrize("env", [{}, {"TPULBM_NO_FUSED2": "1"},
                                 {"TPULBM_SUBSTEPS": "3"}],
                         ids=["default", "no_fused2", "substeps3"])
@pytest.mark.parametrize("chunk_len", CHUNK_LENS)
def test_depth_choice_matches_tpulbm(monkeypatch, env, chunk_len):
    # 128x64 at TPULBM_PALLAS_TY=8 holds 8 slabs, more than tpulbm's
    # N+1 for every depth
    monkeypatch.setenv("TPULBM_PALLAS_TY", "8")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    params = _params(nx=128, ny=64)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    ref = jax_chunk_fn(jax_problem(params), mesh, chunk_len,
                       backend="pallas")
    port = stepper.make_chunk_fn(port_problem(params), "cpu", chunk_len)
    assert port.substeps == ref.pallas_substeps
    assert stepper.choose_substeps(chunk_len) == port.substeps


def test_depth_above_four_is_refused(monkeypatch):
    # depths 5-8 run (the deep build on the card, N plain steps here); the
    # port refuses a forced depth above its cap of 8
    monkeypatch.setenv("TPULBM_SUBSTEPS", "5")
    problem = port_problem(_params())
    chunk = stepper.make_chunk_fn(problem, "cpu", 10)
    assert chunk.substeps == 5 and chunk.plan == [(5, 2)]
    f = state_from_numpy(problem.initial_state(), problem, "cpu")
    want = f.clone()
    plain = step_torch.make_step_rolled(problem, "cpu")
    for _ in range(10):
        want = plain(want)
    assert torch.equal(chunk(f), want)
    assert stepper.make_chunk_fn(problem, "cpu", 7).substeps == 1
    monkeypatch.setenv("TPULBM_SUBSTEPS", "9")
    with pytest.raises(NotImplementedError, match="2 to 8, its cap"):
        stepper.make_chunk_fn(problem, "cpu", 18)
    assert stepper.make_chunk_fn(problem, "cpu", 7).substeps == 1


def test_runner_main_path_schedule(monkeypatch, tmp_path):
    # count the wrapper calls per depth on the CPU (the launch counters
    # count only CUDA launches); the cadence is chip_smoke.py's phase 4
    calls = collections.Counter()

    def counting(make, depth_of):
        def build(problem, device, *args):
            step = make(problem, device, *args)
            depth = depth_of(args)

            def counted(f, out):
                calls[depth] += 1
                return step(f, out)
            return counted
        return build

    monkeypatch.setattr(step_cuda, "make_local_step_cuda", counting(
        step_cuda.make_local_step_cuda, lambda args: 1))
    monkeypatch.setattr(step_cuda, "make_local_step_cuda_blocked", counting(
        step_cuda.make_local_step_cuda_blocked, lambda args: args[0]))
    params = SimulationParams(nx=40, ny=16, tau=0.6, inlet_velocity=0.05,
                              num_timesteps=2800, output_frequency=140,
                              precision="f32", backend="pallas",
                              enable_vtk=False, output_dir=str(tmp_path))
    result = Runner(port_params(params), device="cpu", verbose=False).run()
    assert result.success and result.final_step == 2800
    assert dict(calls) == {4: 665, 1: 140}
    # 2 super-chunks, 4 per-interval diagnostics, the final fields (rho
    # and u) and the final stability check
    assert result.host_fetches == 9
    rows = open(tmp_path / "forces.csv").read().splitlines()[1:]
    assert [int(r.split(",")[0]) for r in rows] == list(range(0, 2800, 140))


@pytest.mark.parametrize("with_fields", [False, True])
def test_super_chunk_matches_interval_diagnostics(with_fields):
    params = _params(nx=48, ny=24)
    problem = port_problem(params)
    f0 = state_from_numpy(problem.initial_state(), problem, "cpu")
    fn = stepper.make_super_chunk_fn(problem, "cpu", 12, 3,
                                     with_fields=with_fields)
    f_super, flat = fn(f0.clone())
    got = fn.unpack(flat.numpy())

    chunk = stepper.make_chunk_fn(problem, "cpu", 12)
    assert chunk.substeps == 4
    force = forces.forces_fn(problem, "cpu")
    max_vel = diagnostics.max_velocity_fn(problem, "cpu")
    stable = diagnostics.stability_fn(problem)
    fields = diagnostics.fields_fn(problem, "cpu")
    f = f0.clone()
    for j in range(3):
        np.testing.assert_array_equal(got["forces"][j], force(f).numpy())
        assert got["max_vel"][j] == max_vel(f).item()
        assert got["stable"][j] == float(stable(f))
        if with_fields:
            rho, u = fields(f)
            np.testing.assert_array_equal(got["rho"][j], rho.numpy())
            np.testing.assert_array_equal(got["u"][j], u.numpy())
        f = chunk(f)
    assert set(got) == ({"forces", "max_vel", "stable"}
                        | ({"rho", "u"} if with_fields else set()))
    torch.testing.assert_close(f_super, f, rtol=0.0, atol=0.0)


def _blocked_args(ny=6, nx=10):
    problem = port_problem(_params(nx=nx, ny=ny))
    f = torch.rand(9, ny, nx, dtype=torch.float32)
    return (f, torch.empty_like(f), torch.zeros(ny, nx, dtype=torch.uint8),
            step_cuda.StepConstants.of(problem),
            step_torch.make_step_rolled(problem, "cpu"))


@pytest.mark.parametrize("bad,exc", [
    ("f64", TypeError), ("solid_bool", TypeError), ("q8", ValueError),
    ("out_shape", ValueError), ("solid_shape", ValueError),
    ("noncontig", ValueError), ("alias", ValueError), ("meta", ValueError),
    ("depth1", NotImplementedError), ("depth9", NotImplementedError)])
def test_blocked_wrapper_rejects_bad_inputs(bad, exc):
    f, out, solid, consts, plain = _blocked_args()
    n_sub = 4
    if bad == "f64":
        f = f.double()
    elif bad == "solid_bool":
        solid = solid.bool()
    elif bad == "q8":
        f, out = f[:8].clone(), out[:8].clone()
    elif bad == "out_shape":
        out = out[:, :, :-1].clone()
    elif bad == "solid_shape":
        solid = solid[:-1].clone()
    elif bad == "noncontig":
        f = torch.rand(9, 10, 6).transpose(1, 2)
    elif bad == "alias":
        out = f
    elif bad == "meta":
        f, out, solid = (t.to("meta") for t in (f, out, solid))
    elif bad.startswith("depth"):
        n_sub = int(bad[-1])
    with pytest.raises(exc):
        step_cuda.collide_stream_blocked(f, out, solid, consts, n_sub, plain)


@pytest.mark.parametrize("n_sub", step_cuda.BLOCKED_DEPTHS
                         + step_cuda.DEEP_DEPTHS)
def test_blocked_wrapper_counts_only_kernel_launches(n_sub):
    # a CPU tensor runs n_sub plain steps; no kernel launch is counted
    problem = port_problem(_params(nx=40, ny=20))
    step = step_cuda.make_local_step_cuda_blocked(problem, "cpu", n_sub)
    plain = step_torch.make_step_rolled(problem, "cpu")
    before = step_cuda.launches(step_cuda.collide_stream_blocked)
    ones = step_cuda.launches(step_cuda.collide_stream)
    f = state_from_numpy(problem.initial_state(), problem, "cpu")
    got = step(f, torch.empty_like(f))
    want = f
    for _ in range(n_sub):
        want = plain(want)
    torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)
    assert step_cuda.launches(step_cuda.collide_stream_blocked) == before
    assert step_cuda.launches(step_cuda.collide_stream) == ones
