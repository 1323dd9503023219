"""The fully periodic 2-D boxes (Taylor-Green, the shear layer, Kolmogorov
forcing) and the periodic passive scalar against tpulbm, on the CPU.

* problem arrays and initial states byte for byte; Kolmogorov's constants
  and the force profile's source against tpulbm's _add_force_field;
* the plain steps (ops/step_torch.py, ops/step_thermal.py) against
  tpulbm's make_step_rolled and make_step_thermal in f64 at rtol 1e-12,
  under several collisions, with the force along y (Kolmogorov) and along
  x (tpulbm's tests/test_kolmogorov.py:239);
* the kernel module: the library each problem picks, its defines and its
  force table, the CPU path, the chunk plan, and the kernels' box and
  force code (csrc/d2q9_common.cuh) built with g++ and stepped cell by
  cell against the plain step;
* meshes: the plain mesh chunk against tpulbm's backend="jax" in f64, the
  kernel module's CPU path on (2,1), (2,2), (1,2) and the overlap mode
  against one device, the dispatch of a force under TPULBM_HALO_OVERLAP;
* the Runner's artifacts against tpulbm's (scalar_variance.csv and no
  nusselt.csv for the scalar), a mesh run against one device, checkpoints
  both ways and the CLI; the 3-D boxes raise naming ROADMAP item 16.

The kernel module against tpulbm's Pallas kernels in interpret mode is
tests/test_torch_periodic_pallas.py.
"""
import dataclasses
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.models import periodic2d as jperiodic
from tpulbm.ops import step_jax
from tpulbm.ops import step_thermal as jthermal
from tpulbm.parallel.mesh import make_mesh as jax_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state as jax_shard_state
from tpulbm.runner import Runner as JaxRunner
from tpulbm_torch import stepper
from tpulbm_torch.config import PRESETS
from tpulbm_torch.convert import split_state, state_from_numpy
from tpulbm_torch.models import make_problem
from tpulbm_torch.models import periodic2d
from tpulbm_torch.models.base import ForceProfile
from tpulbm_torch.ops import step_cuda, step_thermal, step_torch
from tpulbm_torch.parallel import sharded_step
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import cuda_build
from test_torch_3d_blocking import _setenv
from test_torch_compat import port_params, port_problem
from test_torch_mesh import cpu_mesh

F64_TOL = dict(rtol=1e-12, atol=0.0)
F32_TOL = dict(rtol=5e-6, atol=1e-7)
PLAW_TOL = dict(rtol=1e-4, atol=1e-7)
BOX = dict(nx=24, ny=16, tau=0.8, inlet_velocity=0.04, kolmogorov_n=2,
           periodic_x=True, cylinder_radius=0.0)
SCALAR = dict(thermal_tau=0.5704)


def _params(problem, precision="f64", **kw):
    return SimulationParams(**{**BOX, "problem": problem,
                               "precision": precision, **kw})


def _noisy(state, seed):
    rng = np.random.default_rng(seed)
    return (state * rng.uniform(0.9, 1.1, state.shape)).astype(state.dtype)


def _x_force(params):
    """tpulbm's x-varying test force F_y = F0 cos(kx x)
    (tests/test_kolmogorov.py:239): (tpulbm's force_fn, the port's
    profile)."""
    kx = 2.0 * np.pi * 2 / params.nx
    f0 = jperiodic.kolmogorov_f0(params)
    return ((lambda c: (0.0, f0 * jnp.cos(kx * c["xx"]))),
            ForceProfile("x", lambda x: (0.0, f0 * torch.cos(kx * x))))


def _pair(params, x_force=False):
    """(tpulbm's problem, the port's) of `params`, with the x force."""
    ref, mine = jax_problem(params), port_problem(params)
    if x_force:
        fn, prof = _x_force(params)
        ref = dataclasses.replace(ref, force_fn=fn)
        mine = dataclasses.replace(mine, force_profile=prof)
    return ref, mine


# ---- models ---------------------------------------------------------------

PROBLEMS = {"taylor-green": {}, "shear-layer": {}, "kolmogorov": {},
            "passive-scalar": dict(thermal_tau=0.5704)}


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_problem_arrays_match_tpulbm_bytewise(name, precision):
    params = _params(name, precision, **PROBLEMS[name])
    ref, mine = jax_problem(params), port_problem(params)
    for field in ("walls_y", "walls_x", "periodic_x", "periodic_y",
                  "body_force", "collision", "init_u"):
        assert getattr(mine, field) == getattr(ref, field), field
    assert mine.solid is None and ref.solid is None
    assert (mine.force_profile is None) == (ref.force_fn is None)
    for got, want in ((mine.ghost_ring_values(), ref.ghost_ring_values()),
                      (mine.initial_state(), ref.initial_state())):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    if name == "passive-scalar":
        th, jth = mine.thermal, ref.thermal
        assert (th.tau_g, th.t_bottom, th.t_top, th.buoyancy, th.perturb) \
            == (jth.tau_g, jth.t_bottom, jth.t_top, jth.buoyancy,
                jth.perturb)


def test_passive_scalar_at_rest_and_fields_match_tpulbm():
    params = _params("passive-scalar", inlet_velocity=0.0, **SCALAR)
    assert port_problem(params).initial_state().tobytes() == \
        jax_problem(params).initial_state().tobytes()
    for fn in ("taylor_green_fields", "shear_layer_fields",
               "kolmogorov_fields"):
        for got, want in zip(getattr(periodic2d, fn)(params),
                             getattr(jperiodic, fn)(params)):
            assert got.tobytes() == want.tobytes(), fn
    assert periodic2d.passive_scalar_T0(params).tobytes() == \
        jperiodic.passive_scalar_T0(params).tobytes()
    with pytest.raises(ValueError, match="thermal_tau > 0.5"):
        port_problem(_params("passive-scalar"))


@pytest.mark.parametrize("x_force", [False, True], ids=["y", "x"])
def test_force_source_matches_tpulbm(x_force):
    params = _params("kolmogorov")
    ref, mine = _pair(params, x_force)
    assert periodic2d.kolmogorov_kappa(params) == \
        jperiodic.kolmogorov_kappa(params)
    assert periodic2d.kolmogorov_f0(params) == jperiodic.kolmogorov_f0(params)
    zeros = jnp.zeros((9,) + ref.spatial_shape)
    want = step_jax._add_force_field(ref, zeros, step_jax._coords(ref))
    cd = step_torch.coords(mine, "cpu")
    got = step_torch.force_source(mine, cd, torch.float64, "cpu")
    np.testing.assert_allclose(np.broadcast_to(got.numpy(), want.shape),
                               np.asarray(want), rtol=1e-14, atol=1e-20)


# the 3-D boxes run on one device (tests/test_torch_3d_periodic.py) and on
# a mesh (tests/test_torch_mesh3d.py: error None, the Problem builds);
# tpulbm's 2-D-only problems raise its ValueError in 3-D
@pytest.mark.parametrize("preset,override,error,match", [
    ("kolmogorov3d", dict(mesh_shape=(2, 1)), None, None),
    ("taylor-green", dict(nz=16, mesh_shape=(1, 2)), None, None),
    ("shear-layer", dict(nz=16), ValueError, "2-D only"),
    ("taylor-green", dict(problem="passive-scalar", thermal_tau=0.6, nz=16),
     ValueError, "2-D only")])
def test_3d_boxes_raise(preset, override, error, match):
    params = PRESETS[preset].replace(**override)
    if error is None:
        problem = make_problem(params)
        assert problem.lattice.D == 3 and problem.periodic_z
        return
    with pytest.raises(error, match=match):
        make_problem(params)


def test_force_profile_refuses_what_the_kernels_do_not_hold():
    # a profile along one axis: x or y in 2-D (the D2Q9 kernels' table),
    # z in 3-D (3-D Kolmogorov, the 3-D kernels' table)
    with pytest.raises(NotImplementedError, match="one axis"):
        ForceProfile("w", lambda w: (w, 0.0, 0.0))
    with pytest.raises(NotImplementedError, match="one axis"):
        ForceProfile("xy", lambda c: (c, c))
    duct = make_problem(PRESETS["poiseuille"].replace(nx=8, ny=9, nz=7,
                                                      precision="f32"))
    forced = dataclasses.replace(duct, force_profile=ForceProfile(
        "y", lambda y: (0.0 * y, 0.0)))
    with pytest.raises(NotImplementedError, match="along 'y'"):
        step_cuda.kernel_constants(forced, q=19)
    box = make_problem(PRESETS["taylor-green"].replace(nx=8, ny=8,
                                                       precision="f32"))
    along_z = dataclasses.replace(box, force_profile=ForceProfile(
        "z", lambda z: (0.0 * z, 0.0)))
    with pytest.raises(NotImplementedError, match="along 'z'"):
        step_cuda.kernel_constants(along_z)


# ---- the plain steps --------------------------------------------------------

PLAIN_CASES = {
    "taylor_green": ("taylor-green", {}),
    "taylor_green_trt": ("taylor-green", dict(collision="trt")),
    "taylor_green_mrt": ("taylor-green", dict(collision="mrt")),
    "shear_layer": ("shear-layer", {}),
    "shear_layer_regularized": ("shear-layer", dict(collision="regularized")),
    "shear_layer_kbc": ("shear-layer", dict(collision="kbc")),
    "kolmogorov": ("kolmogorov", {}),
    "kolmogorov_les": ("kolmogorov", dict(smagorinsky=0.17)),
    "kolmogorov_power_law": ("kolmogorov", dict(power_law_n=0.7)),
    "kolmogorov_x_force": ("kolmogorov", dict(x_force=True)),
    "kolmogorov_body_force": ("kolmogorov", dict(body_force=(1e-5, 2e-5))),
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_step_matches_jax_rolled_f64(case):
    name, kw = PLAIN_CASES[case]
    x_force = kw.get("x_force", False)
    kw = {k: v for k, v in kw.items() if k != "x_force"}
    ref, mine = _pair(_params(name, **kw), x_force)
    f = _noisy(ref.initial_state(), 5)
    jstep = jax.jit(step_jax.make_step_rolled(ref))
    pstep = step_torch.make_step_rolled(mine, "cpu")
    a, b = jnp.asarray(f), torch.from_numpy(f.copy())
    for _ in range(3):
        a, b = jstep(a), pstep(b)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **F64_TOL)


@pytest.mark.parametrize("u0", [0.0, 0.04], ids=["rest", "stirred"])
def test_passive_scalar_plain_step_matches_tpulbm_f64(u0):
    ref, mine = _pair(_params("passive-scalar", inlet_velocity=u0,
                              **SCALAR))
    s = _noisy(ref.initial_state(), 9)
    jstep = jax.jit(jthermal.make_step_thermal(ref))
    pstep = step_thermal.make_step_thermal(mine, "cpu")
    a, b = jnp.asarray(s), torch.from_numpy(s.copy())
    for _ in range(3):
        a, b = jstep(a), pstep(b)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **F64_TOL)
    np.testing.assert_allclose(
        float(step_thermal.scalar_variance(mine, b)),
        float(jthermal.scalar_variance(ref, a)), rtol=1e-12)


# ---- the kernel module ------------------------------------------------------

@pytest.mark.parametrize("case,library", [
    ("taylor_green", "bgk+box"), ("kolmogorov", "bgk+box+force"),
    ("kolmogorov_x_force", "bgk+box+force"),
    ("shear_layer_regularized", "regularized+box"),
    ("kolmogorov_body_force", "bgk+box+source+force"),
    ("kolmogorov_power_law", "power_law+box+force")])
def test_step_constants_pick_the_library(case, library):
    name, kw = PLAIN_CASES[case]
    x_force = kw.get("x_force", False)
    kw = {k: v for k, v in kw.items() if k != "x_force"}
    _, problem = _pair(_params(name, "f32", **kw), x_force)
    consts = step_cuda.kernel_constants(problem)
    assert consts.library == library
    defines = step_cuda.build_defines(consts.mode, consts.variant)
    assert "-DTPULBM_DOMAIN=3" in defines
    assert ("-DTPULBM_FORCE=1" in defines) == ("force" in library)
    if "force" in library:
        axis = problem.force_profile.index
        assert consts.force_axis == axis == (0 if x_force else 1)
        n = problem.spatial_shape[::-1][axis]
        want = problem.force_profile.table(problem.lattice, n,
                                           torch.float32, "cpu")
        got = torch.tensor(consts.force_table, dtype=torch.float32)
        assert torch.equal(got, want.reshape(-1))
        cpu = torch.device("cpu")
        assert consts.force_args(cpu, problem.spatial_shape)[0] == axis
        # a table of another grid's extent, or none, never reaches a launch
        with pytest.raises(ValueError, match="not 9 x"):
            consts.force_args(cpu, (n + 1, n + 1))
        with pytest.raises(ValueError, match="force table of 0"):
            dataclasses.replace(consts, force_table=()).force_args(
                cpu, problem.spatial_shape)
    else:
        assert consts.force_args(torch.device("cpu"),
                                 problem.spatial_shape) == (-1, None)


def test_kernel_domain_needs_both_axes_periodic_and_no_walls():
    tg = port_problem(_params("taylor-green", "f32"))
    assert step_cuda.kernel_domain(tg) == step_cuda.DOMAINS.index("box")
    for bad in (dataclasses.replace(tg, periodic_x=False),
                dataclasses.replace(tg, walls_y=True),
                dataclasses.replace(tg, walls_x=True)):
        with pytest.raises(NotImplementedError, match="boundary layout"):
            step_cuda.kernel_constants(bad)
    assert step_cuda.variant_defines(step_cuda.FORCE | 3) == (
        "-DTPULBM_DOMAIN=3", "-DTPULBM_FORCE=1")


def test_kernel_module_cpu_path_is_the_plain_step():
    _, problem = _pair(_params("kolmogorov", "f32"))
    f = state_from_numpy(_noisy(problem.initial_state(), 4), problem, "cpu")
    step_cuda.reset_launch_counts()
    got1 = step_cuda.make_local_step_cuda(problem, "cpu")(
        f, torch.empty_like(f))
    got3 = step_cuda.make_local_step_cuda_blocked(problem, "cpu", 3)(
        f, torch.empty_like(f))
    plain = step_torch.make_step_rolled(problem, "cpu")
    assert torch.equal(got1, plain(f))
    assert torch.equal(got3, plain(plain(plain(f))))
    assert step_cuda.collide_stream.launches_by_library == {}
    assert step_cuda.launches(step_cuda.collide_stream_blocked) == {
        2: 0, 3: 0, 4: 0}


@pytest.mark.parametrize("name,chunk_len,plan", [
    ("taylor-green", 140, [(4, 35)]), ("kolmogorov", 139, [(1, 139)]),
    ("kolmogorov", 150, [(3, 50)]), ("passive-scalar", 140, [(1, 140)])])
def test_chunk_plan(name, chunk_len, plan):
    problem = port_problem(_params(name, "f32", **PROBLEMS[name]))
    assert stepper.make_chunk_fn(problem, "cpu", chunk_len).plan == plan


# One step of csrc/d2q9_common.cuh built for the host (the CUDA qualifiers
# defined away, g++ without contraction as nvcc's -fmad=false): every cell
# collided with its coordinate's force entries (collide_cell, the table's
# row along the force's axis), then pulled with both axes wrapped, as the
# kernels' tiles wrap in the box, and the domain's boundary sequence.
_HOST_STEP = r"""
#define __device__
#define __forceinline__ inline
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <vector>
#include "d2q9_common.cuh"
int main(int argc, char** argv) {
  const int nx = atoi(argv[1]), ny = atoi(argv[2]), axis = atoi(argv[3]);
  const size_t n = (size_t)nx * ny;
  const int nf = axis == 0 ? nx : ny;
  const int nc = 3 + 3 * 9 + 2;
  std::vector<float> sc(nc), mode(tpulbm::kModeFloats), tab(9 * nf),
      f(9 * n), post(9 * n), out(9 * n);
  FILE* fp = fopen(argv[4], "rb");
  if (fread(sc.data(), 4, nc, fp) != (size_t)nc ||
      fread(mode.data(), 4, tpulbm::kModeFloats, fp) !=
          (size_t)tpulbm::kModeFloats ||
      fread(tab.data(), 4, 9 * nf, fp) != (size_t)(9 * nf) ||
      fread(f.data(), 4, 9 * n, fp) != 9 * n) return 1;
  fclose(fp);
  const tpulbm::StepConsts k = tpulbm::make_consts(
      sc[0], sc[1], sc[2], &sc[3], &sc[12], mode.data(), &sc[21], sc[30],
      sc[31]);
  for (int y = 0; y < ny; ++y)
    for (int x = 0; x < nx; ++x) {
      const size_t c = (size_t)y * nx + x;
      float v[9];
      for (int i = 0; i < 9; ++i) v[i] = f[i * n + c];
      tpulbm::collide_cell(v, k, false, &tab[axis == 0 ? x : y], nf);
      for (int i = 0; i < 9; ++i) post[i * n + c] = v[i];
    }
  auto wrap = [](int v, int m) { return ((v % m) + m) % m; };
  for (int y = 0; y < ny; ++y)
    for (int x = 0; x < nx; ++x) {
      float g[9];
      auto post_at = [&](int i, int dx, int dy) {
        return post[i * n + (size_t)wrap(y + dy, ny) * nx + wrap(x + dx, nx)];
      };
      auto solid_at = [](int, int) { return false; };
      tpulbm::pull_d2q9(g, x, y, nx, ny, k, post_at);
      tpulbm::apply_boundaries<false>(g, false, x, y, nx, ny, k, post_at,
                                      solid_at);
      for (int i = 0; i < 9; ++i) out[i * n + (size_t)y * nx + x] = g[i];
    }
  fp = fopen(argv[5], "wb");
  fwrite(out.data(), 4, 9 * n, fp);
  fclose(fp);
  return 0;
}
"""

HOST_CASES = ["taylor_green", "kolmogorov", "kolmogorov_x_force",
              "kolmogorov_power_law", "kolmogorov_body_force"]


@pytest.mark.parametrize("case", HOST_CASES)
def test_kernel_box_code_matches_plain_step(tmp_path, case):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' box code for the host")
    name, kw = PLAIN_CASES[case]
    x_force = kw.get("x_force", False)
    kw = {k: v for k, v in kw.items() if k != "x_force"}
    _, problem = _pair(_params(name, "f32", nx=19, ny=11, **kw), x_force)
    consts = step_cuda.kernel_constants(problem)
    src = tmp_path / "step.cpp"
    src.write_text(_HOST_STEP)
    exe = tmp_path / "step"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    *step_cuda.build_defines(consts.mode, consts.variant),
                    "-I", str(cuda_build.SOURCE_DIR), str(src), "-o",
                    str(exe)], check=True, capture_output=True)
    f = _noisy(problem.initial_state(), 29)
    axis = max(consts.force_axis, 0)
    ny, nx = problem.spatial_shape
    table = consts.force_table or (0.0,) * (9 * (nx, ny)[axis])
    head = [consts.inv_tau, consts.u_in, 1.0 - consts.u_in, *consts.eq_in,
            *consts.w, *(consts.src or (0.0,) * 9), *consts.lid]
    np.concatenate([np.array(head, np.float32),
                    np.array(consts.modes, np.float32),
                    np.array(table, np.float32),
                    f.ravel()]).tofile(tmp_path / "in.bin")
    subprocess.run([str(exe), str(nx), str(ny), str(axis),
                    str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
                   check=True)
    got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(f.shape)
    want = step_torch.make_step_rolled(problem, "cpu")(
        torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, want, **(PLAW_TOL if "power" in case
                                             else F32_TOL))
    # the box acts: the channel's walls change the same step
    walled = dataclasses.replace(problem, walls_y=True, periodic_y=False)
    other = step_torch.make_step_rolled(walled, "cpu")(torch.from_numpy(f))
    assert not np.allclose(other.numpy(), got, **F32_TOL)


# ---- meshes -----------------------------------------------------------------

def _tpulbm_mesh_chunks(ref, mesh_shape, chunk_len, n_chunks, f0):
    mesh = jax_mesh(mesh_shape,
                    devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    chunk = jax_chunk_fn(ref, mesh, chunk_len, backend="jax")
    f, solid = jax_shard_state(mesh, f0, np.zeros(ref.spatial_shape, bool))
    out = []
    for _ in range(n_chunks):
        f = chunk(f, solid)
        out.append(np.asarray(jax.device_get(f)))
    return out


def _port_mesh_chunks(problem, mesh_shape, chunk_len, n_chunks, f0,
                      backend):
    mesh = cpu_mesh(mesh_shape)
    chunk = sharded_step.make_chunk_fn(problem, mesh, chunk_len,
                                       backend=backend)
    shards = split_state(f0, problem, mesh)
    out = []
    for _ in range(n_chunks):
        shards = chunk(shards)
        out.append(sharded_step.gather(shards).numpy())
    return out, chunk


@pytest.mark.parametrize("case", ["taylor_green", "kolmogorov",
                                  "kolmogorov_x_force"])
@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2), (1, 2)])
def test_plain_mesh_chunk_matches_tpulbm(case, mesh_shape):
    name, kw = PLAIN_CASES[case]
    ref, mine = _pair(_params(name), kw.get("x_force", False))
    f0 = _noisy(ref.initial_state(), 1)
    want = _tpulbm_mesh_chunks(ref, mesh_shape, 4, 2, f0)
    got, chunk = _port_mesh_chunks(mine, mesh_shape, 4, 2, f0, "jax")
    assert chunk.mode == "plain"
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-15,
                                   err_msg=f"mesh {mesh_shape} chunk {k}")


@pytest.mark.parametrize("case", ["taylor_green", "kolmogorov_x_force"])
@pytest.mark.parametrize("mesh_shape,env,mode,depth", [
    ((2, 1), {}, "rows", 3), ((2, 2), {}, "tiled", 3),
    ((1, 2), {"TPULBM_NO_FUSED2": "1"}, "tiled", 1),
    ((2, 1), {"TPULBM_HALO_OVERLAP": "1", "TPULBM_NO_FUSED2": "1"},
     "overlap", 1)])
def test_kernel_module_on_a_mesh_matches_one_device(monkeypatch, case,
                                                    mesh_shape, env, mode,
                                                    depth):
    _setenv(monkeypatch, env)
    name, kw = PLAIN_CASES[case]
    x_force = kw.get("x_force", False)
    _, problem = _pair(_params(name, "f32", nx=24, ny=24), x_force)
    f0 = _noisy(problem.initial_state(), 2)
    got, chunk = _port_mesh_chunks(problem, mesh_shape, 6, 2, f0, "pallas")
    if x_force and mode == "overlap":
        # tpulbm builds no 1-step ranged kernel for a force_fn
        mode = "rows"
    assert (chunk.mode, chunk.substeps) == (mode, depth)
    one = stepper.make_chunk_fn(problem, "cpu", 6)
    g = torch.from_numpy(f0.copy())
    for k in range(2):
        g = one(g)
        np.testing.assert_allclose(got[k], g.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"chunk {k}")


@pytest.mark.parametrize("env,chunk_len,want,want_force", [
    ({"TPULBM_HALO_OVERLAP": "1"}, 8, ("overlap", 4), ("overlap", 4)),
    ({"TPULBM_HALO_OVERLAP": "1", "TPULBM_NO_FUSED2": "1"}, 8,
     ("overlap", 1), ("rows", 1)),
    ({"TPULBM_HALO_OVERLAP": "1"}, 5, ("overlap", 1), ("rows", 1))])
def test_plan_of_a_force_under_the_overlap_mode(monkeypatch, env, chunk_len,
                                                want, want_force):
    # tpulbm's ranged N-step kernels thread force_fn, its ranged 1-step
    # kernel does not (step_pallas.py:1276-1277): the full-width kernels
    # run instead
    _setenv(monkeypatch, env)
    tg = port_problem(_params("taylor-green", "f32", nx=64, ny=64))
    kol = port_problem(_params("kolmogorov", "f32", nx=64, ny=64))
    mesh = cpu_mesh((4, 1))
    assert sharded_step.plan(tg, mesh, chunk_len) == want
    assert sharded_step.plan(kol, mesh, chunk_len) == want_force


def test_shard_initial_state_starts_from_the_fields():
    problem = port_problem(_params("taylor-green", "f32"))
    mesh = cpu_mesh((2, 2))
    shards, solid = sharded_step.shard_initial_state(problem, mesh)
    assert solid is None
    assert sharded_step.gather(shards).numpy().tobytes() == \
        problem.initial_state().tobytes()


# ---- the Runner, checkpoints, the CLI ---------------------------------------

def _runner_params(tmp, name, **kw):
    d = dict(num_timesteps=200, output_frequency=50, output_dir=str(tmp),
             backend="jax", enable_vtk=False, nx=24, ny=16, **PROBLEMS[name])
    d.update(kw)
    return _params(name, **d)


def _table(path):
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


RUNNER_CASES = {
    "taylor-green": ("taylor-green", {}),
    "shear-layer-regularized": ("shear-layer", dict(collision="regularized")),
    "kolmogorov": ("kolmogorov", {}),
    "passive-scalar": ("passive-scalar", {}),
    # the kernel module (its CPU path) in f32 against tpulbm's f32 jax
    # tier: tests/test_torch_runner.py's drift tolerance
    "kolmogorov-f32": ("kolmogorov", dict(precision="f32",
                                          backend="pallas")),
    "passive-scalar-f32": ("passive-scalar", dict(precision="f32",
                                                  backend="pallas")),
}


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_runner_artifacts_match_tpulbm(tmp_path, case):
    name, kw = RUNNER_CASES[case]
    f32 = kw.get("precision") == "f32"
    tol = dict(rtol=1e-5, atol=5e-6) if f32 else dict(rtol=1e-9, atol=1e-12)
    ref_p = _runner_params(tmp_path / "ref", name,
                           **{**kw, "backend": "jax"})
    ref = JaxRunner(ref_p, verbose=False).run()
    got = Runner(port_params(_runner_params(tmp_path / "port", name, **kw)),
                 device="cpu", verbose=False).run()
    assert ref.success and got.success and got.final_step == 200
    assert got.forces_path is None
    scalar = name == "passive-scalar"
    names = ["velocity_field.csv", "simulation_params.csv"]
    for d in ("ref", "port"):
        assert not (tmp_path / d / "forces.csv").exists()
        assert not (tmp_path / d / "nusselt.csv").exists()
        assert (tmp_path / d / "scalar_variance.csv").exists() == scalar
    if scalar:
        names.append("temperature_field.csv")
        lines = [(tmp_path / d / "scalar_variance.csv").read_text()
                 .splitlines() for d in ("port", "ref")]
        assert lines[0][0] == lines[1][0] == "timestep,scalar_variance"
        assert len(lines[0]) == len(lines[1]) == 5
        for a, b in zip(lines[0][1:], lines[1][1:]):
            assert re.fullmatch(r"\d+,\d\.\d{8}e[-+]\d\d", a), a
            assert a.split(",")[0] == b.split(",")[0]
            np.testing.assert_allclose(float(a.split(",")[1]),
                                       float(b.split(",")[1]),
                                       rtol=1e-4 if f32 else 1e-9)
        assert set(got.stats) == set(ref.stats) == {"scalar_variance"}
        np.testing.assert_allclose(got.stats["scalar_variance"],
                                   ref.stats["scalar_variance"],
                                   rtol=1e-4 if f32 else 1e-9)
    else:
        assert got.stats is None and ref.stats is None
    got_rows, ref_rows = (
        (tmp_path / d / "simulation_params.csv").read_text().splitlines()
        for d in ("port", "ref"))
    assert [r.split(",")[0] for r in got_rows] == \
        [r.split(",")[0] for r in ref_rows]
    for fname in names[:1] + names[2:]:
        got_t = _table(tmp_path / "port" / fname)
        ref_t = _table(tmp_path / "ref" / fname)
        assert got_t.shape == ref_t.shape == (24 * 16, got_t.shape[1])
        np.testing.assert_allclose(got_t, ref_t, err_msg=fname, **tol)


def test_runner_on_a_mesh_matches_one_device(tmp_path):
    # the kernel module's CPU path on a 2x2 mesh of host shards against
    # one device, Kolmogorov in f32: the Runner's artifacts
    base = dict(precision="f32", backend="pallas", nx=32, ny=32)
    one = _runner_params(tmp_path / "one", "kolmogorov", **base)
    mesh = one.replace(mesh_shape=(2, 2), output_dir=str(tmp_path / "mesh"))
    for p in (one, mesh):
        assert Runner(port_params(p), device="cpu",
                      verbose=False).run().success
    got = _table(tmp_path / "mesh" / "velocity_field.csv")
    want = _table(tmp_path / "one" / "velocity_field.csv")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-6)


@pytest.mark.parametrize("direction", ["tpulbm_to_port", "port_to_tpulbm"])
@pytest.mark.parametrize("name", ["kolmogorov", "passive-scalar"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, direction, name):
    def run(which, params, **kw):
        if which == "port":
            return Runner(port_params(params), device="cpu",
                          verbose=False).run(**kw)
        return JaxRunner(params, verbose=False).run(**kw)

    writer, reader = (("port", "tpulbm") if direction == "port_to_tpulbm"
                      else ("tpulbm", "port"))
    run(reader, _runner_params(tmp_path / "straight", name))
    half = _runner_params(tmp_path / "moved", name, num_timesteps=100,
                          checkpoint_every=1)
    run(writer, half)
    result = run(reader, half.replace(num_timesteps=200), resume=True)
    assert result.success and result.final_step == 200
    names = ["velocity_field.csv"] + (
        ["scalar_variance.csv", "temperature_field.csv"]
        if name == "passive-scalar" else [])
    for fname in names:
        got = _table(tmp_path / "moved" / fname)
        want = _table(tmp_path / "straight" / fname)
        assert got.shape == want.shape, fname
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12,
                                   err_msg=fname)


@pytest.mark.parametrize("argv,files", [
    (["--preset", "taylor-green"], ["velocity_field.csv"]),
    (["--preset", "shear-layer"], ["velocity_field.csv"]),
    (["--preset", "kolmogorov", "--stats-from", "-1"],
     ["velocity_field.csv"]),
    (["--problem", "passive-scalar", "--thermal-tau", "0.6",
      "--inlet-velocity", "0.04", "--tau", "0.8", "--cylinder-radius", "0"],
     ["scalar_variance.csv", "temperature_field.csv"]),
    (["--preset", "taylor-green", "--mesh", "2x2"], ["velocity_field.csv"]),
    (["--preset", "kolmogorov", "--stats-from", "-1", "--mesh", "2x2"],
     ["velocity_field.csv"])],
    ids=["taylor-green", "shear-layer", "kolmogorov", "passive-scalar",
         "taylor-green-2x2", "kolmogorov-2x2"])
def test_cli_runs_the_periodic_problems_on_the_cpu(tmp_path, capsys, argv,
                                                    files):
    from tpulbm_torch.__main__ import main
    assert main(["--cpu", *argv, "--nx", "32", "--ny", "16",
                 "--num-timesteps", "20", "--output-frequency", "10",
                 "--output-dir", str(tmp_path), "--no-vtk"]) == 0
    out = capsys.readouterr().out
    assert "Cylinder:" not in out
    for fname in files:
        table = _table(tmp_path / fname)
        assert np.isfinite(table).all(), fname
    assert not (tmp_path / "nusselt.csv").exists()
    assert not (tmp_path / "forces.csv").exists()


def test_cli_kolmogorov_preset_keeps_the_statistics_refusal(tmp_path):
    # the preset's statistics, once refused (item 15), now run: the CLI
    # with a cut depth writes stats_fields.npz from stats_from on
    from tpulbm_torch.__main__ import main
    assert main(["--cpu", "--preset", "kolmogorov", "--nx", "32", "--ny",
                 "16", "--num-timesteps", "400", "--output-frequency", "100",
                 "--stats-from", "200", "--output-dir", str(tmp_path)]) == 0
    with np.load(tmp_path / "stats_fields.npz") as st:
        assert (int(st["n_samples"]), int(st["first_step"]),
                int(st["sample_interval"])) == (2, 200, 100)
        assert np.isfinite(st["re_uxuy"]).all()
