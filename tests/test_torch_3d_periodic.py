"""The fully periodic 3-D boxes (the 3-D Taylor-Green vortex and 3-D
Kolmogorov flow, ROADMAP Queue 1 item 16) against tpulbm, on the CPU.

* the problem arrays byte for byte (initial fields, ghost values, flags)
  on D3Q19 and D3Q27, and the z force's table against tpulbm's
  _add_force_field in f64;
* the plain step against tpulbm.ops.step_jax.make_step_rolled in f64 at
  1e-12 under every 3-D collision tpulbm runs (MRT on D3Q19), and the
  repair of the z edge rule: a z-periodic shear wave, which the plain step
  once froze at the z edges;
* the kernel module (its CPU path, the plain step) against tpulbm's 3-D
  Pallas kernels in interpret mode from a ±10% perturbed state, f32 at
  rtol 5e-6 / atol 1e-7: the cascade (row 7's extended sweep) at N = 3
  and 2, with and without the force, and the full-plane 1-step kernel
  (row 6's wrapped z planes) with the force. tpulbm's Pallas force takes
  the unwrapped halo coordinates -1 and nz (tests/test_kolmogorov.py), so
  kernel and plain version agree at f32 rounding, not bit for bit;
* the kernels' box code (csrc/d3q19_common.cuh: collide_cell with the
  force table, the wrapped pull, no walls) built with g++ on the host and
  stepped cell by cell against the plain step, on both velocity sets;
* the libraries (the box domain, the force table, the D3Q27 bit) and the
  one-device plan against tpulbm's for the box;
* the Runner's fields3d.npz, stats_fields.npz and probes.csv against
  tpulbm's Runner at the artifact tolerance, f32; the CLI's
  `--preset kolmogorov3d` and `--preset kolmogorov` at a cut depth; the
  3-D box runs on a mesh, the thermal box there raises naming ROADMAP
  item 19.

The float32 weights sum to 1 + 2^-26 on D3Q19 and 1 + 2^-27 on D3Q27: a
closed box's f32 mass grows by that term times 1/tau a step (the card's
gates take it off, chip_smoke.py).
"""
import dataclasses
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulbm.ops.step_pallas3d as jax_pallas3d
from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.ops import step_jax
from tpulbm.parallel.mesh import make_mesh as jax_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state as jax_shard_state
from tpulbm.runner import Runner as JaxRunner
from tpulbm_torch import stepper
from tpulbm_torch.config import PRESETS
from tpulbm_torch.convert import state_from_numpy, state_to_numpy
from tpulbm_torch.lattice import D3Q19, D3Q27
from tpulbm_torch.models import make_problem
from tpulbm_torch.ops import step_cuda, step_torch
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import cuda_build
from test_torch_3d_blocking import _setenv, _spy_tiled
from test_torch_compat import port_params, port_problem
from test_torch_stats import _close_csv

F32_TOL = dict(rtol=5e-6, atol=1e-7)
PLAW_TOL = dict(rtol=1e-4, atol=1e-7)
ART = dict(rtol=1e-4, atol=5e-6)
BOX = dict(nx=16, ny=8, nz=12, tau=0.8, inlet_velocity=0.05,
           kolmogorov_n=2, periodic_x=True, cylinder_radius=0.0)
OPERATORS = {"bgk": {}, "trt": dict(collision="trt"),
             "mrt": dict(collision="mrt"),
             "regularized": dict(collision="regularized"),
             "les": dict(smagorinsky=0.17),
             "power_law": dict(power_law_n=0.7, power_law_k=0.02)}


def _params(problem, precision="f64", **kw):
    return SimulationParams(problem=problem, precision=precision,
                            **{**BOX, **kw})


def _noisy(state, seed):
    rng = np.random.default_rng(seed)
    return (state * (1.0 + 0.1 * (2.0 * rng.random(state.shape) - 1.0))
            ).astype(state.dtype)


def test_f32_weights_sum_past_one():
    # the closed boxes' mass term (chip_smoke.py's gates take it off)
    for lat, excess in ((D3Q19, 2.0 ** -26), (D3Q27, 2.0 ** -27)):
        assert lat.w.astype(np.float32).astype(np.float64).sum() - 1.0 \
            == excess


@pytest.mark.parametrize("lattice3d", ["d3q19", "d3q27"])
@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("problem", ["taylor-green", "kolmogorov"])
def test_problem_arrays_match_tpulbm_bytewise(problem, precision, lattice3d):
    params = _params(problem, precision, lattice3d=lattice3d)
    mine, ref = port_problem(params), jax_problem(params)
    assert (mine.lattice.name, mine.lattice.velocities,
            mine.lattice.weights) == (ref.lattice.name, ref.lattice.velocities,
                                      ref.lattice.weights)
    flags = ("periodic_x", "periodic_y", "periodic_z", "walls_y", "walls_z",
             "init_u", "solid")
    assert [getattr(mine, k) for k in flags] == \
        [getattr(ref, k) for k in flags]
    assert (mine.force_profile is None) == (ref.force_fn is None)
    for got, want in ((mine.ghost_ring_values(), ref.ghost_ring_values()),
                      (mine.initial_state(), ref.initial_state())):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("lattice3d", ["d3q19", "d3q27"])
def test_z_force_matches_tpulbm(lattice3d):
    params = _params("kolmogorov", lattice3d=lattice3d)
    mine, ref = port_problem(params), jax_problem(params)
    zeros = jnp.zeros((ref.lattice.Q,) + ref.spatial_shape)
    want = step_jax._add_force_field(ref, zeros, step_jax._coords(ref))
    got = step_torch.force_source(mine, step_torch.coords(mine, "cpu"),
                                  torch.float64, "cpu")
    assert got.shape == (mine.lattice.Q, params.nz, 1, 1)
    np.testing.assert_allclose(np.broadcast_to(got.numpy(), want.shape),
                               np.asarray(want), rtol=1e-14, atol=1e-20)


# ---- the plain step ---------------------------------------------------------

@pytest.mark.parametrize("op", OPERATORS)
@pytest.mark.parametrize("problem", ["taylor-green", "kolmogorov"])
def test_plain_step_matches_jax_rolled_f64(problem, op):
    params = _params(problem, **OPERATORS[op])
    ref, mine = jax_problem(params), port_problem(params)
    f = _noisy(ref.initial_state(), 3)
    jstep = jax.jit(step_jax.make_step_rolled(ref))
    pstep = step_torch.make_step_rolled(mine, "cpu")
    a, b = jnp.asarray(f), torch.from_numpy(f)
    for _ in range(4):
        a, b = jstep(a), pstep(b)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                               atol=1e-15)


def _z_wave(problem):
    """The box at rest but for a shear wave u_x = u0 sin(2π z / nz): every
    population crosses the z edges."""
    p = problem.params
    z = np.arange(p.nz, dtype=np.float64)[:, None, None]
    ux = 0.05 * np.sin(2.0 * np.pi * z / p.nz) * np.ones((1, p.ny, p.nx))
    zeros = np.zeros_like(ux)
    return dataclasses.replace(problem, init_fields=(
        np.ones_like(ux), np.stack([ux, zeros, zeros])))


def test_plain_step_wraps_z_under_periodic_z():
    # the z edge rule applied under periodic_z once pinned the planes z = 0
    # and nz-1 to the frozen equilibrium: the wave then tore at the edges
    params = _params("taylor-green", nz=10)
    ref, mine = _z_wave(jax_problem(params)), _z_wave(port_problem(params))
    jstep = jax.jit(step_jax.make_step_rolled(ref))
    pstep = step_torch.make_step_rolled(mine, "cpu")
    a = jnp.asarray(ref.initial_state())
    b = torch.from_numpy(mine.initial_state())
    for _ in range(20):
        a, b = jstep(a), pstep(b)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                               atol=1e-15)
    # and it stays one odd wave across the z edges: u(nz - z) = -u(z)
    u = step_torch.physics.moments(mine.lattice, b)[1][0, :, 0, 0].numpy()
    np.testing.assert_allclose(u[1:5], -u[:5:-1], rtol=1e-9)


# ---- the kernel module against tpulbm's Pallas kernels ------------------

@pytest.mark.parametrize("problem,chunk_len,depths", [
    ("taylor-green", 7, [3, 2]), ("kolmogorov", 7, [3, 2]),
    ("kolmogorov", 1, None)],
    ids=["tg-cascade", "kolmogorov-cascade", "kolmogorov-full-plane"])
def test_kernel_module_matches_pallas3d(monkeypatch, problem, chunk_len,
                                        depths):
    _setenv(monkeypatch, {})
    built = _spy_tiled(monkeypatch)
    # 32x16: tpulbm's interpret-mode tile is 16 rows, at least 4 halo rows
    # at depths 2 and 3 (test_torch_3d_blocking.py)
    params = _params(problem, "f32", nx=32, ny=16, nz=8)
    ref = jax_problem(params)
    mesh = jax_mesh((1, 1), devices=jax.devices()[:1])
    jchunk = jax_chunk_fn(ref, mesh, chunk_len, backend="pallas")
    assert jchunk.pallas3d_depths == depths
    assert [d for d, ok in built if ok] == (depths or [])
    mine = port_problem(params)
    pchunk = stepper.make_chunk_fn(mine, "cpu", chunk_len)
    assert pchunk.pallas3d_depths == depths
    f0 = _noisy(ref.initial_state(), 17)
    f, solid = jax_shard_state(mesh, f0, np.zeros(ref.spatial_shape, bool))
    g = state_from_numpy(f0, mine, "cpu")
    for k in range(2):
        f = jchunk(f, solid)
        g = pchunk(g)
        np.testing.assert_allclose(state_to_numpy(g),
                                   np.asarray(jax.device_get(f)),
                                   err_msg=f"chunk {k}", **F32_TOL)


# ---- the kernels' box code on the host --------------------------------------

# One step of csrc/d3q19_common.cuh built for the host (the CUDA qualifiers
# defined away, g++ without contraction as nvcc's -fmad=false): every cell
# collided with the force table's column at its z (collide_cell, the
# bounce-back skip), then per cell the pull (post() wraps the periodic
# axes, as the kernels' halo loads do) and the domain's boundary sequence
# (step_cell), on either velocity set.
HOST_STEP = r"""
#define __device__
#define __forceinline__ inline
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <vector>
#include "d3q19_common.cuh"
namespace k_ = tpulbm3d;
int main(int argc, char** argv) {
  const int nx = atoi(argv[1]), ny = atoi(argv[2]), nz = atoi(argv[3]);
  const int q = k_::kQ;
  const size_t n = (size_t)nx * ny * nz;
  const int nc = 1 + 3 * q;
  std::vector<float> sc(nc), mode(k_::kModeFloats), tab(q * nz), solid(n),
      f(q * n), post(q * n), out(q * n);
  FILE* fp = fopen(argv[4], "rb");
  if (fread(sc.data(), 4, nc, fp) != (size_t)nc ||
      fread(mode.data(), 4, k_::kModeFloats, fp) != (size_t)k_::kModeFloats ||
      fread(tab.data(), 4, q * nz, fp) != (size_t)(q * nz) ||
      fread(solid.data(), 4, n, fp) != n ||
      fread(f.data(), 4, q * n, fp) != q * n) return 1;
  fclose(fp);
  const k_::Consts k = k_::make_consts(sc[0], &sc[1], &sc[1 + q],
                                       mode.data(), &sc[1 + 2 * q]);
  for (int z = 0; z < nz; ++z)
    for (size_t c = (size_t)z * nx * ny; c < (size_t)(z + 1) * nx * ny; ++c) {
      float v[k_::kQ];
      for (int i = 0; i < q; ++i) v[i] = f[i * n + c];
      k_::collide_cell(v, k, tpulbm::kBounceBack && solid[c] != 0.0f,
                       &tab[z], nz);
      for (int i = 0; i < q; ++i) post[i * n + c] = v[i];
    }
  auto wrap = [](bool periodic, int v, int m) {
    return periodic ? ((v % m) + m) % m : v;
  };
  for (int z = 0; z < nz; ++z)
    for (int y = 0; y < ny; ++y)
      for (int x = 0; x < nx; ++x) {
        const size_t c = ((size_t)z * ny + y) * nx + x;
        float g[k_::kQ];
        auto post_at = [&](auto i, int ox, int oy, int oz) {
          return post[decltype(i)::value * n +
                      ((size_t)wrap(k_::kPeriodicZ, z + oz, nz) * ny +
                       wrap(k_::kPeriodicY, y + oy, ny)) * nx +
                      wrap(k_::kPeriodicX, x + ox, nx)];
        };
        k_::step_cell(g, [&](int ox) { return solid[c + ox] != 0.0f; }, x, y,
                      z, nx, ny, nz, k, post_at);
        for (int i = 0; i < q; ++i) out[i * n + c] = g[i];
      }
  fp = fopen(argv[5], "wb");
  fwrite(out.data(), 4, q * n, fp);
  fclose(fp);
  return 0;
}
"""


def host_step(tmp_path, problem, f):
    """One step of `problem` from f (float32) through the kernels' header
    built with g++ for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' code for the host")
    consts = step_cuda.kernel_constants(problem, 19)
    src = tmp_path / "step.cpp"
    src.write_text(HOST_STEP)
    exe = tmp_path / "step"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    *step_cuda.build_defines(consts.mode, consts.variant),
                    "-I", str(cuda_build.SOURCE_DIR), str(src), "-o",
                    str(exe)], check=True, capture_output=True)
    q = problem.lattice.Q
    nz, ny, nx = problem.spatial_shape
    table = consts.force_table or (0.0,) * (q * nz)
    head = [consts.inv_tau, *consts.eq_in, *consts.w,
            *(consts.src or (0.0,) * q)]
    np.concatenate([np.array(head, np.float32),
                    np.array(consts.modes, np.float32),
                    np.array(table, np.float32),
                    step_cuda.kernel_mask(problem).astype(np.float32).ravel(),
                    f.ravel()]).tofile(tmp_path / "in.bin")
    subprocess.run([str(exe), str(nx), str(ny), str(nz),
                    str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
                   check=True)
    return np.fromfile(tmp_path / "out.bin", np.float32).reshape(f.shape)


@pytest.mark.parametrize("op", ["bgk", "trt", "regularized", "power_law"])
@pytest.mark.parametrize("lattice3d", ["d3q19", "d3q27"])
@pytest.mark.parametrize("problem", ["taylor-green", "kolmogorov"])
def test_kernel_box_code_matches_plain_step(tmp_path, problem, lattice3d, op):
    params = _params(problem, "f32", nx=9, ny=7, nz=6, lattice3d=lattice3d,
                     **OPERATORS[op])
    mine = port_problem(params)
    f = _noisy(mine.initial_state(), 29)
    got = host_step(tmp_path, mine, f)
    want = step_torch.make_step_rolled(mine, "cpu")(torch.from_numpy(f))
    np.testing.assert_allclose(got, want.numpy(),
                               **(PLAW_TOL if op == "power_law"
                                  else F32_TOL))
    # the box acts: the duct's walls change the same step, and so does
    # the force, where there is one
    walled = dataclasses.replace(mine, walls_y=True, walls_z=True,
                                 periodic_y=False, periodic_z=False)
    others = [walled]
    if mine.force_profile is not None:
        others.append(dataclasses.replace(mine, force_profile=None))
    for other in others:
        alt = step_torch.make_step_rolled(other, "cpu")(torch.from_numpy(f))
        assert not np.allclose(alt.numpy(), got, **F32_TOL)


# ---- libraries and the plan -------------------------------------------------

@pytest.mark.parametrize("problem,kw,library,defines", [
    ("taylor-green", {}, "bgk+box", ("-DTPULBM_DOMAIN=3",)),
    ("kolmogorov", {}, "bgk+box+force",
     ("-DTPULBM_DOMAIN=3", "-DTPULBM_FORCE=1")),
    ("kolmogorov", dict(lattice3d="d3q27", collision="trt"),
     "trt+box+force+d3q27", ("-DTPULBM_COLLISION=1", "-DTPULBM_DOMAIN=3",
                             "-DTPULBM_FORCE=1", "-DTPULBM_Q=27")),
    ("taylor-green", dict(body_force=(1e-6, 0.0, 0.0)), "bgk+box+source",
     ("-DTPULBM_DOMAIN=3", "-DTPULBM_SOURCE=1"))])
def test_step_constants_pick_the_box_library(problem, kw, library, defines):
    mine = port_problem(_params(problem, "f32", **kw))
    consts = step_cuda.kernel_constants(mine, 19)
    assert step_cuda.kernel_domain(mine) == 3
    assert consts.library == library
    assert step_cuda.build_defines(consts.mode, consts.variant) == defines
    q, nz = mine.lattice.Q, mine.params.nz
    assert len(consts.w) == len(consts.eq_in) == q
    assert len(consts.modes) == step_cuda.mode_floats_3d(q)
    if mine.force_profile is None:
        assert consts.force_table == () and consts.force_axis == -1
    else:
        assert consts.force_axis == 2 and len(consts.force_table) == q * nz
        table = step_torch.force_source(mine, step_torch.coords(mine, "cpu"),
                                        torch.float32, "cpu")
        np.testing.assert_array_equal(
            np.array(consts.force_table, np.float32).reshape(q, nz),
            table.numpy()[:, :, 0, 0])
    assert not step_cuda.kernel_mask(mine).any()


@pytest.mark.parametrize("env", ["default", "substeps2"])
@pytest.mark.parametrize("chunk_len", [1, 2, 3, 5, 7, 139, 140])
@pytest.mark.parametrize("lattice3d", ["d3q19", "d3q27"])
def test_plan_matches_tpulbm(monkeypatch, chunk_len, env, lattice3d):
    _setenv(monkeypatch, {"default": {},
                          "substeps2": {"TPULBM_SUBSTEPS": "2"}}[env])
    params = _params("kolmogorov", "f32", nx=32, ny=16, nz=8,
                     lattice3d=lattice3d)
    mesh = jax_mesh((1, 1), devices=jax.devices()[:1])
    ref = jax_chunk_fn(jax_problem(params), mesh, chunk_len,
                       backend="pallas")
    port = stepper.make_chunk_fn(port_problem(params), "cpu", chunk_len)
    assert port.pallas3d_depths == ref.pallas3d_depths


# ---- the Runner and the CLI -------------------------------------------------

def _runner_params(tmp, problem, **kw):
    d = dict(BOX, problem=problem, precision="f32", num_timesteps=97,
             output_frequency=10, enable_vtk=False, output_dir=str(tmp))
    d.update(kw)
    return SimulationParams(**d)


@pytest.mark.parametrize("problem,kw", [
    ("kolmogorov", dict(stats_from=25,
                        probe_points=((0.5, 0.25, 0.5), (0.0, 1.0, 0.9)))),
    ("taylor-green", dict(lattice3d="d3q27", collision="trt"))],
    ids=["kolmogorov-stats-probes", "tg-d3q27-trt"])
def test_runner_artifacts_match_tpulbm(tmp_path, problem, kw):
    ref = JaxRunner(_runner_params(tmp_path / "ref", problem, backend="jax",
                                   **kw), verbose=False).run()
    got = Runner(port_params(_runner_params(tmp_path / "port", problem,
                                            **kw)),
                 device="cpu", verbose=False).run()
    assert ref.success and got.success and got.final_step == 97
    names = ["fields3d.npz"] + (["stats_fields.npz"] if "stats_from" in kw
                                else [])
    for name in names:
        with np.load(tmp_path / "port" / name) as a, \
                np.load(tmp_path / "ref" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                if k == "params":      # the run's JSON (its output_dir)
                    continue
                if a[k].dtype == np.int64:
                    assert np.array_equal(a[k], b[k]), k
                else:
                    np.testing.assert_allclose(a[k], b[k], err_msg=k, **ART)
    assert (tmp_path / "port" / "probes.csv").exists() == \
        ("probe_points" in kw)
    if "probe_points" in kw:
        _close_csv(tmp_path / "port" / "probes.csv",
                   tmp_path / "ref" / "probes.csv", **ART)
    for d in ("port", "ref"):
        assert not (tmp_path / d / "velocity_field.csv").exists()


@pytest.mark.parametrize("argv,files", [
    (["--preset", "kolmogorov3d", "--nx", "16", "--ny", "16", "--nz", "16",
      "--num-timesteps", "40", "--output-frequency", "10", "--stats-from",
      "20"], ["fields3d.npz", "stats_fields.npz"]),
    (["--preset", "kolmogorov", "--nx", "32", "--ny", "16",
      "--num-timesteps", "40", "--output-frequency", "10", "--stats-from",
      "20"], ["velocity_field.csv", "stats_fields.npz"]),
    (["--preset", "taylor-green", "--nz", "8", "--nx", "16", "--ny", "8",
      "--lattice3d", "d3q27", "--num-timesteps", "20",
      "--output-frequency", "10"], ["fields3d.npz"])],
    ids=["kolmogorov3d", "kolmogorov", "taylor-green-3d-d3q27"])
def test_cli_runs_the_presets_on_the_cpu(tmp_path, argv, files):
    from tpulbm_torch.__main__ import main
    assert main(["--cpu", *argv, "--output-dir", str(tmp_path),
                 "--no-vtk"]) == 0
    for name in files:
        with np.load(tmp_path / name) if name.endswith(".npz") else \
                open(tmp_path / name) as data:
            if name == "stats_fields.npz":
                assert int(data["n_samples"]) == 2
                assert all(np.isfinite(data[k]).all() for k in data.files)
            elif name == "fields3d.npz":
                assert data["ux"].shape == tuple(
                    int(argv[argv.index(f"--n{a}") + 1]) for a in "zyx")
                assert np.isfinite(data["ux"]).all()


def test_box_and_scalar_on_a_mesh(tmp_path):
    # the 3-D box runs on a mesh (tests/test_torch_mesh3d.py), and so does
    # the thermal box, the passive scalar, since its ring build
    # (tests/test_torch_mesh_thermal.py)
    params = PRESETS["kolmogorov3d"].replace(
        nx=16, ny=16, nz=16, mesh_shape=(2, 1), output_dir=str(tmp_path))
    runner = Runner(params, device="cpu")
    assert runner.mesh.shape == (2, 1)
    scalar = PRESETS["taylor-green"].replace(
        problem="passive-scalar", thermal_tau=0.6, mesh_shape=(2, 1),
        output_dir=str(tmp_path))
    assert Runner(scalar, device="cpu").mesh.shape == (2, 1)
    assert PRESETS["kolmogorov3d"].to_json() == \
        __import__("tpulbm.config").config.PRESETS["kolmogorov3d"].to_json()
