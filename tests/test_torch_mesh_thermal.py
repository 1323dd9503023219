"""The thermal problems on a mesh of shards (tpulbm_torch/parallel/,
the thermal kernel's ring build) against tpulbm's on its virtual CPU
devices, the port's shards all on `cpu`, inputs made by numpy from a
seed, at dryrun_multichip's small shapes (32 columns and 16 rows a shard
or more):

* the plain mesh chunk (--backend jax, tpulbm's body_jax with
  make_local_step_padded_thermal) equals tpulbm's
  make_chunk_fn(backend="jax") in f64 at rtol 1e-12 / atol 1e-15 on
  (2,1), (1,2) and (2,2), for Rayleigh-Bénard, its Smagorinsky closure,
  the heated cavity (the x walls at the global edge columns only) and the
  passive scalar (a periodic y through the rings), from a ±10% perturbed
  state;
* the kernel module's CPU path (the plain ring step of each shard)
  against the port's one-device chunk, and the dispatch;
* the thermal trace (the Nusselt number, the scalar variance) and the
  temperature on meshes against one device, on (1,1) bit for bit;
* the Runner on a mesh against its one-device run and against tpulbm's
  mesh run, per-shard checkpoints both ways, the CLI's --mesh;
* the thermal kernel's source and its ring build (csrc/step_thermal.cu,
  -DTPULBM_RINGS=1) built with g++ against a small fake CUDA runtime and
  stepped on the host: every mesh bitwise the one-device build, each
  shard within the one-step tolerance of its plain ring step,
  equilibrium rings far off it;
* the ring wrapper's checks and counts, and the refusal of several hosts.

The kernel module against tpulbm's thermal Pallas kernel in interpret
mode on meshes is in tests/test_torch_mesh_coupled_pallas.py.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.runner import Runner as JaxRunner
from tpulbm_torch import stepper
from tpulbm_torch.ops import step_cuda, step_thermal, step_thermal_cuda
from tpulbm_torch.parallel import halo, sharded_step
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import checkpoint as ckpt
from tpulbm_torch.utils import cuda_build
from test_torch_compat import port_problem
from test_torch_mesh import _port_chunks, _tpulbm_chunks, cpu_mesh, perturbed

THERMAL = dict(tau=0.55, thermal_tau=0.5704, rayleigh=1e4,
               inlet_velocity=0.0, cylinder_radius=0.0)
CASES = {
    "rb": dict(THERMAL, problem="rayleigh-benard", periodic_x=True),
    "rb_les": dict(THERMAL, problem="rayleigh-benard", periodic_x=True,
                   smagorinsky=0.17),
    "cavity": dict(THERMAL, problem="heated-cavity"),
    "scalar": dict(problem="passive-scalar", tau=0.8, thermal_tau=0.6,
                   inlet_velocity=0.04, cylinder_radius=0.0),
}
MESHES = [(2, 1), (1, 2), (2, 2)]
# the kernel module's CPU path against the one-device chunk: the same
# arithmetic, up to the order of PyTorch's sums over the planes on blocks
# of another shape (a float32 rounding a step)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
ARTIFACT_TOL = dict(rtol=1e-4, atol=5e-6)


def params(case, precision="f64", nx=64, ny=32, **kw):
    return SimulationParams(precision=precision, nx=nx, ny=ny,
                            **dict(CASES[case], **kw))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_plain_mesh_chunk_matches_tpulbm(case, mesh_shape):
    p = params(case)
    f0 = perturbed(jax_problem(p))
    want = _tpulbm_chunks(p, mesh_shape, 4, 1, f0)
    got, chunk = _port_chunks(p, mesh_shape, 4, 1, f0)
    assert chunk.mode == "plain"
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_kernel_module_on_a_mesh_matches_one_device(case, mesh_shape):
    p = params(case, precision="f32")
    f0 = perturbed(jax_problem(p))
    got, chunk = _port_chunks(p, mesh_shape, 6, 2, f0, backend="pallas")
    assert (chunk.mode, chunk.substeps, chunk.plan) == (
        "tiled" if mesh_shape[1] > 1 else "rows", 1, [(1, 6)])
    one = stepper.make_chunk_fn(port_problem(p), "cpu", 6)
    g = torch.from_numpy(f0.copy())
    for k in range(2):
        g = one(g)
        np.testing.assert_allclose(got[k], g.numpy(), err_msg=f"chunk {k}",
                                   **F32_TOL)


def test_dispatch_follows_tpulbm(monkeypatch):
    # tpulbm's thermal kernel takes x rings where the mesh cuts x only
    # (th_xh): TPULBM_FORCE_XHALO leaves one shard on the one-device path
    problem = port_problem(params("rb", precision="f32"))
    monkeypatch.setenv("TPULBM_FORCE_XHALO", "1")
    assert sharded_step.make_chunk_fn(problem, cpu_mesh((1, 1)),
                                      4).mode == "one-device"
    assert sharded_step.make_chunk_fn(problem, cpu_mesh((2, 1)),
                                      4).mode == "rows"
    with pytest.raises(ValueError, match="too small"):
        sharded_step.make_chunk_fn(port_problem(params(
            "rb", precision="f32", ny=8)), cpu_mesh((4, 1)), 4)
    with pytest.raises(NotImplementedError, match="float32"):
        sharded_step.make_chunk_fn(port_problem(params("rb")),
                                   cpu_mesh((2, 1)), 4)


@pytest.mark.parametrize("case", ["rb", "cavity", "scalar"])
def test_thermal_trace_and_temperature_on_meshes(case):
    problem = port_problem(params(case, precision="f32"))
    f = torch.from_numpy(perturbed(problem))
    one = sharded_step.Diagnostics(problem, cpu_mesh((1, 1)))
    # (1,1): the one-device functions, bit for bit
    assert torch.equal(one.nusselt([[f]]),
                       (step_thermal.nusselt if problem.walls_y
                        else step_thermal.scalar_variance)(problem, f))
    assert torch.equal(one.temperature([[f]]),
                       step_thermal.temperature(problem, f))
    for shape in MESHES + [(4, 2)]:
        mesh = cpu_mesh(shape)
        diag = sharded_step.Diagnostics(problem, mesh)
        blocks = sharded_step.split(mesh, f)
        # float64 partial sums per shard against one float32 mean
        np.testing.assert_allclose(float(diag.nusselt(blocks)),
                                   float(one.nusselt([[f]])), rtol=1e-6,
                                   err_msg=str(shape))
        torch.testing.assert_close(diag.temperature(blocks),
                                   one.temperature([[f]]), rtol=1e-6,
                                   atol=1e-7)
        assert diag.nusselt(blocks).dtype == torch.float32


def _csv(path):
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


@pytest.mark.parametrize("case", ["rb", "scalar"])
def test_runner_on_a_mesh_matches_one_device(tmp_path, case):
    trace = "nusselt.csv" if case == "rb" else "scalar_variance.csv"
    kw = dict(precision="f32", num_timesteps=60, output_frequency=20,
              enable_vtk=False, probe_points=((0.5, 0.25), (0.1, 0.9)))
    one = Runner(params(case, output_dir=str(tmp_path / "one"), **kw),
                 device="cpu", verbose=False).run()
    mesh = Runner(params(case, output_dir=str(tmp_path / "mesh"),
                         mesh_shape=(2, 2), **kw),
                  device="cpu", verbose=False).run()
    assert one.success and mesh.success
    for name in (trace, "temperature_field.csv", "velocity_field.csv",
                 "probes.csv"):
        got, ref = _csv(tmp_path / "mesh" / name), _csv(tmp_path / "one" /
                                                        name)
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, err_msg=name, **ARTIFACT_TOL)
    assert len(_csv(tmp_path / "mesh" / trace)) == 3
    assert not (tmp_path / "mesh" / "forces.csv").exists()


def test_runner_on_a_mesh_with_vtk_and_statistics(tmp_path):
    # the super-chunk path on a mesh: the Nusselt number a sample, the
    # temperature block of every VTK frame, Reynolds statistics
    kw = dict(precision="f32", num_timesteps=160, output_frequency=10,
              stats_from=40, vtk_start_step=150)
    for name, mesh in (("one", (1, 1)), ("mesh", (2, 2))):
        assert Runner(params("rb", output_dir=str(tmp_path / name),
                             mesh_shape=mesh, **kw), device="cpu",
                      verbose=False).run().success
    np.testing.assert_allclose(_csv(tmp_path / "mesh" / "nusselt.csv"),
                               _csv(tmp_path / "one" / "nusselt.csv"),
                               **ARTIFACT_TOL)
    frames = sorted(p.name for p in (tmp_path / "mesh" /
                                     "vtk_output").iterdir())
    assert frames == sorted(p.name for p in (tmp_path / "one" /
                                             "vtk_output").iterdir())
    assert b"temperature" in (tmp_path / "mesh" / "vtk_output" /
                              frames[-1]).read_bytes()
    with np.load(tmp_path / "mesh" / "stats_fields.npz") as got, \
            np.load(tmp_path / "one" / "stats_fields.npz") as ref:
        assert int(got["n_samples"]) == int(ref["n_samples"]) == 12
        np.testing.assert_allclose(got["mean_ux"], ref["mean_ux"],
                                   **ARTIFACT_TOL)


def test_runner_on_a_mesh_matches_tpulbm(tmp_path):
    # both packages' plain tier in f64 on a (2, 2) mesh
    kw = dict(backend="jax", num_timesteps=40, output_frequency=20,
              enable_vtk=False, mesh_shape=(2, 2))
    Runner(params("cavity", output_dir=str(tmp_path / "port"), **kw),
           device="cpu", verbose=False).run()
    JaxRunner(params("cavity", output_dir=str(tmp_path / "jax"), **kw),
              devices=jax.devices()[:4], verbose=False).run()
    for name in ("nusselt.csv", "temperature_field.csv",
                 "velocity_field.csv"):
        np.testing.assert_allclose(_csv(tmp_path / "port" / name),
                                   _csv(tmp_path / "jax" / name),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("direction", ["port_to_tpulbm", "tpulbm_to_port"])
def test_per_shard_checkpoint_resumes_in_the_other_package(tmp_path,
                                                           direction):
    writer, reader = ((Runner, JaxRunner) if direction == "port_to_tpulbm"
                      else (JaxRunner, Runner))

    def run(cls, p, **kw):
        if cls is Runner:
            return Runner(p, device="cpu", verbose=False).run(**kw)
        return JaxRunner(p, devices=jax.devices()[:4],
                         verbose=False).run(**kw)

    kw = dict(backend="jax", output_frequency=10, enable_vtk=False,
              mesh_shape=(2, 2))
    run(reader, params("scalar", output_dir=str(tmp_path / "straight"),
                       num_timesteps=40, **kw))
    half = params("scalar", output_dir=str(tmp_path / "moved"),
                  num_timesteps=20, checkpoint_every=1, **kw)
    run(writer, half)
    latest = ckpt.latest(str(tmp_path / "moved" / "checkpoints"))
    step, blocks = ckpt.load_sharded(latest, (2, 2), half)
    assert step == 20 and blocks[1][1].shape == (14, 16, 32)
    result = run(reader, half.replace(num_timesteps=40), resume=True)
    assert result.success and result.final_step == 40
    for name in ("scalar_variance.csv", "temperature_field.csv"):
        np.testing.assert_allclose(_csv(tmp_path / "moved" / name),
                                   _csv(tmp_path / "straight" / name),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def test_cli_mesh_runs_a_thermal_preset(tmp_path, capsys):
    from tpulbm_torch.__main__ import main
    assert main(["--cpu", "--mesh", "2x2", "--preset", "rayleigh-benard",
                 "--nx", "64", "--ny", "32", "--num-timesteps", "20",
                 "--output-frequency", "10", "--probe", "0.5,0.5",
                 "--no-vtk", "--output-dir", str(tmp_path)]) == 0
    assert "Device mesh: 2×2" in capsys.readouterr().out
    assert _csv(tmp_path / "nusselt.csv").shape == (2, 2)
    assert _csv(tmp_path / "temperature_field.csv").shape == (64 * 32, 3)
    assert _csv(tmp_path / "probes.csv").shape[0] == 2


def test_several_hosts_stay_refused():
    # ROADMAP Queue 1 item 19, step 4: one process per host
    from tpulbm_torch.__main__ import main
    with pytest.raises(NotImplementedError, match="item 19"):
        main(["--distributed", "--cpu", "--preset", "rayleigh-benard"])


# ---- the ring wrapper -----------------------------------------------------

def _shard_and_rings(problem, mesh_shape=(2, 2), cell=(0, 0)):
    mesh = cpu_mesh(mesh_shape)
    f = torch.from_numpy(perturbed(problem))
    blocks = sharded_step.split(mesh, f)
    x_rings = mesh_shape[1] > 1
    rings = halo.exchange(blocks, eq_ring=problem.ghost_ring_values(),
                          depth=1, periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, x_rings=x_rings)
    local = sharded_step.block_shape(problem, mesh)
    shard = step_cuda.Shard(index=cell, origin=sharded_step.origin(
        mesh, local, *cell), local_shape=local,
        grid=problem.spatial_shape, depth=1, x_rings=x_rings)
    return blocks[cell[0]][cell[1]], rings[cell[0]][cell[1]], shard


@pytest.mark.parametrize("bad", ["depth", "mask", "rl_missing", "planes"])
def test_thermal_ring_wrapper_rejects_bad_inputs(bad):
    problem = port_problem(params("rb", precision="f32"))
    consts = step_thermal_cuda.ThermalConstants.of(problem)
    s, rings, shard = _shard_and_rings(problem)
    if bad == "depth":
        shard = step_cuda.Shard(**{**shard.__dict__, "depth": 2})
    elif bad == "mask":
        shard = step_cuda.Shard(**{**shard.__dict__, "mask": torch.zeros(
            (18, 34), dtype=torch.uint8)})
    elif bad == "rl_missing":
        rings = rings[:2] + (None, rings[3])
    elif bad == "planes":
        s, rings = s[:9].contiguous(), tuple(r[:9].contiguous()
                                            for r in rings)
    with pytest.raises(ValueError):
        step_thermal_cuda.collide_stream_thermal_rings(
            s, torch.empty_like(s), rings, shard, consts,
            plain=lambda *a: a[0])


def test_thermal_ring_wrapper_counts_only_kernel_launches():
    problem = port_problem(params("rb", precision="f32"))
    s, rings, shard = _shard_and_rings(problem)
    plain = step_thermal.make_ring_step_thermal(problem, shard.origin,
                                                shard.local_shape, "cpu")
    step_cuda.reset_launch_counts()
    out = step_thermal_cuda.collide_stream_thermal_rings(
        s, torch.empty_like(s), rings, shard,
        step_thermal_cuda.ThermalConstants.of(problem), plain=plain)
    assert torch.equal(out, plain(s, *rings))
    assert step_cuda.launches_by_shard(
        step_thermal_cuda.collide_stream_thermal_rings) == {}
    assert step_cuda.launches(
        step_thermal_cuda.collide_stream_thermal_rings) == {1: 0}


# ---- the CUDA sources on the host ----------------------------------------

# A small CUDA runtime for the host: __shared__ arrays are statics (the
# blocks run one after another), each CUDA thread is a std::thread, and
# __syncthreads() a std::barrier; `kernel<<<grid, block, smem, stream>>>(
# args);` becomes fake_launch(grid, block, smem, stream, [&] { kernel(args);
# }) (host_source).
FAKE_RUNTIME = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline std::barrier<>* fake_barrier = nullptr;
inline void __syncthreads() { fake_barrier->arrive_and_wait(); }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
template <class S, class F>
void fake_launch(dim3 grid, dim3 block, int, S, F body) {
  const unsigned n = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(n);
        fake_barrier = &bar;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < n; ++t)
          threads.emplace_back([=] {
            threadIdx = dim3(t % block.x, t / block.x % block.y,
                             t / (block.x * block.y));
            blockIdx = dim3(bx, by, bz);
            body();
          });
        for (auto& th : threads) th.join();
      }
}
"""
_LAUNCH = re.compile(r"(\w+)<<<(.*?)>>>\((.*?)\);", re.S)


def host_source(src: str) -> str:
    """A .cu source with its launches rewritten for FAKE_RUNTIME."""
    return _LAUNCH.sub(lambda m: f"fake_launch({m.group(2)}, [&] {{ "
                       f"{m.group(1)}({m.group(3)}); }});", src)


@pytest.fixture(scope="module")
def host_cuda(tmp_path_factory):
    """build(source, defines) -> the ctypes library of a csrc/ kernel
    source built for the host with g++ against FAKE_RUNTIME."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' sources for the host")
    tmp = tmp_path_factory.mktemp("host_cuda")
    (tmp / "cuda_runtime.h").write_text(FAKE_RUNTIME)
    libs = {}

    def build(source: str, defines: tuple = ()) -> ctypes.CDLL:
        key = (source, tuple(defines))
        if key not in libs:
            tag = "".join("_" + d.rsplit("=", 1)[-1] for d in defines)
            cpp = tmp / f"{Path(source).stem}{tag}.cpp"
            cpp.write_text(host_source(
                (cuda_build.SOURCE_DIR / source).read_text()))
            so = cpp.with_suffix(".so")
            subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                            "-shared", "-fPIC", "-pthread", *defines, "-I",
                            str(tmp), "-I", str(cuda_build.SOURCE_DIR),
                            str(cpp), "-o", str(so)], check=True,
                           capture_output=True)
            libs[key] = ctypes.CDLL(str(so))
        return libs[key]

    return build


_P, _I = ctypes.c_void_p, ctypes.c_int


def host_thermal_step(build, problem, s):
    """One step of the one-device thermal build on the host."""
    consts = step_thermal_cuda.ThermalConstants.of(problem)
    fn = build("step_thermal.cu",
               step_cuda.mode_defines(consts.mode)).tpulbm_thermal_step
    fn.argtypes = [_P] * 2 + [_I] * 2 + [_P] * 7 + [_I] * 5 + [_P]
    out = torch.empty_like(s)
    ny, nx = s.shape[1:]
    assert fn(s.data_ptr(), out.data_ptr(), nx, ny, *consts.arrays,
              consts.baxis, int(consts.walls_y), int(consts.walls_y),
              int(consts.walls_x), 0, None) == 0
    return out


def host_ring_steps(build, problem, f, mesh_shape, x_rings):
    """One launch of every shard of the ring build on the host, through
    the wrapper's argument list (ring_args): (the gathered state, the
    largest difference from a shard's plain ring step, the smallest from
    the launch fed rings of the frozen equilibrium)."""
    thermal = problem.thermal is not None
    if thermal:
        from tpulbm_torch.ops import step_thermal_cuda as mod
        consts = mod.ThermalConstants.of(problem)
        fn = build("step_thermal.cu", step_cuda.build_defines(
            consts.mode, step_cuda.RINGS)).tpulbm_thermal_step_rings
        fn.argtypes = [_P] * 6 + [_I] * 7 + [_P] * 7 + [_I] * 4 + [_P]
        depth, make_plain = 1, step_thermal.make_ring_step_thermal
    else:
        from tpulbm_torch.ops import step_multiphase, \
            step_multiphase_cuda as mod
        consts = mod.MultiphaseConstants.of(problem)
        fn = build("step_multiphase.cu", step_cuda.build_defines(
            "bgk", step_cuda.RINGS)).tpulbm_multiphase_step_rings
        fn.argtypes = [_P] * 6 + [_I] * 7 + [_P, _P, _I, _P]
        depth, make_plain = mod.DEPTH, step_multiphase.make_ring_step_multiphase
    mesh = cpu_mesh(mesh_shape)
    local = sharded_step.block_shape(problem, mesh)
    blocks = sharded_step.split(mesh, f)
    rings = halo.exchange(blocks, eq_ring=problem.ghost_ring_values(),
                          depth=depth, periodic_x=problem.periodic_x,
                          periodic_y=problem.periodic_y, x_rings=x_rings)
    eq = torch.as_tensor(problem.ghost_ring_values(),
                         dtype=torch.float32).reshape(-1, 1, 1)
    outs = [[torch.empty_like(b) for b in row] for row in blocks]
    plain_err, eq_off = 0.0, np.inf
    for iy, ix in mesh.shards():
        shard = step_cuda.Shard(
            index=(iy, ix), origin=sharded_step.origin(mesh, local, iy, ix),
            local_shape=local, grid=problem.spatial_shape, depth=depth,
            x_rings=x_rings)
        b, r = blocks[iy][ix], rings[iy][ix]
        step_cuda.check_shard(b, outs[iy][ix], r, shard, 1,
                              (0, local[0]), q2d=b.shape[0],
                              depths={depth: 1})
        assert fn(*mod.ring_args(b, outs[iy][ix], r, shard, consts, 0,
                                 None)) == 0
        plain = make_plain(problem, shard.origin, local, "cpu")(b, *r)
        plain_err = max(plain_err,
                        float((outs[iy][ix] - plain).abs().max()))
        flat = tuple(None if x is None else eq.expand(x.shape).contiguous()
                     for x in r)
        off = torch.empty_like(b)
        assert fn(*mod.ring_args(b, off, flat, shard, consts, 0, None)) == 0
        eq_off = min(eq_off, float((off - plain).abs().max()))
    return sharded_step.gather(outs), plain_err, eq_off


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh_shape,x_rings", [
    ((1, 1), True), ((2, 1), False), ((1, 2), True), ((2, 2), True),
    ((5, 1), False)])
def test_host_ring_build_equals_the_one_device_build(host_cuda, case,
                                                     mesh_shape, x_rings):
    # a ragged grid: shards of 14-35 rows and 50-100 columns, none a
    # multiple of the 32x8 tile
    problem = port_problem(params(case, precision="f32", nx=100, ny=70))
    f = torch.from_numpy(perturbed(problem))
    want = host_thermal_step(host_cuda, problem, f)
    got, plain_err, eq_off = host_ring_steps(host_cuda, problem, f,
                                             mesh_shape, x_rings)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert plain_err <= 1e-7
    # where a shard has a neighbour (or wraps), its rings carry data
    if mesh_shape != (1, 1) or problem.periodic_x:
        assert eq_off > 1e-4
