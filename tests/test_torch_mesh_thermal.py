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


def test_several_hosts_stay_refused(tmp_path):
    # the name is older than the port's several processes: --distributed
    # was refused until parallel/multihost.py. Now two processes over
    # gloo run Rayleigh-Benard on (2,1) and process 0 writes the one-process
    # mesh run's bytes
    from test_torch_multihost import spawn
    from tpulbm_torch.__main__ import main
    cli = ["--cpu", "--mesh", "2x1", "--preset", "rayleigh-benard", "--nx",
           "64", "--ny", "32", "--num-timesteps", "40",
           "--output-frequency", "20", "--no-vtk"]
    runs = spawn(2, ["-m", "tpulbm_torch", "--distributed", *cli,
                     "--output-dir", str(tmp_path / "two")])
    for rank, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out[-4000:]}"
    assert main([*cli, "--output-dir", str(tmp_path / "one")]) == 0
    for name in ("nusselt.csv", "temperature_field.csv",
                 "velocity_field.csv"):
        assert (tmp_path / "two" / name).read_bytes() == \
            (tmp_path / "one" / name).read_bytes(), name


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
# blocks of a launch without a cluster run one after another), each CUDA
# thread is a fiber (ucontext: its own stack, switched on one host thread),
# and __syncthreads() a barrier at which a fiber yields until every thread
# of its block has arrived; the fibers run in turns whose order reverses
# from one turn to the next, so a read that a missing barrier leaves
# unordered meets the write on one side or the other; a barrier that some
# thread never reaches aborts the process with a message. `kernel<<<grid,
# block, smem, stream>>>(args);` becomes fake_launch(grid, block, smem,
# stream, [&] { kernel(args); }) (host_source). Dynamic shared memory is a
# NaN-filled buffer per block. A thread-block cluster (cudaLaunchKernelEx
# with cudaLaunchAttributeClusterDimension) runs its blocks' threads
# together: cluster_group::sync() is a barrier over all of them and
# map_shared_rank() points into the dynamic shared memory of the block of
# that rank (x fastest). An asynchronous copy (__pipeline_memcpy_async) is a
# synchronous copy whose wait completes at once. The deep 3-D build's
# scratch kernel reads gridDim and the occupancy queries (a card of 2 SMs,
# one block or cluster each).
FAKE_RUNTIME = r"""
#pragma once
#include <ucontext.h>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <math.h>
#include <memory>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __grid_constant__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
// A barrier of `count` fibers: the last to arrive opens it (gen + 1).
struct FakeBarrier {
  unsigned count = 0, arrived = 0;
  unsigned long gen = 0;
};
struct FakeFiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  dim3 thread, block;
  FakeBarrier* bar;
  unsigned char* smem;
  bool done;
  unsigned long arrived;  // the cluster barrier's gen at its split arrive
};
// the running fiber's thread and block, its block barrier and cluster
// barrier, its block's dynamic shared memory and that of each block of its
// cluster by rank (set at every switch)
inline thread_local dim3 threadIdx, blockIdx, gridDim;
inline thread_local FakeBarrier* fake_barrier = nullptr;
inline thread_local FakeBarrier* fake_cluster_barrier = nullptr;
inline thread_local unsigned char* fake_dyn_smem = nullptr;
inline thread_local unsigned char* const* fake_cluster_smem = nullptr;
inline thread_local ucontext_t fake_main;
inline thread_local FakeFiber* fake_current = nullptr;
inline thread_local const std::function<void()>* fake_body = nullptr;
inline thread_local unsigned long fake_progress = 0;
inline void fake_wait(FakeBarrier* b) {
  const unsigned long gen = b->gen;
  ++fake_progress;
  if (++b->arrived == b->count) {
    b->arrived = 0;
    ++b->gen;
    return;
  }
  while (b->gen == gen) swapcontext(&fake_current->ctx, &fake_main);
}
inline void __syncthreads() { fake_wait(fake_barrier); }
inline void fake_yield() { swapcontext(&fake_current->ctx, &fake_main); }
// the cluster barrier split in two: arrive, then wait for the others
inline void fake_cluster_arrive() {
  FakeBarrier* b = fake_cluster_barrier;
  fake_current->arrived = b->gen;
  ++fake_progress;
  if (++b->arrived == b->count) {
    b->arrived = 0;
    ++b->gen;
  }
}
inline void fake_cluster_wait() {
  while (fake_cluster_barrier->gen == fake_current->arrived) fake_yield();
}
inline void fake_fiber_entry() {
  (*fake_body)();
  fake_current->done = true;
  ++fake_progress;
}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaDevAttrMultiProcessorCount = 16 };
enum {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 9
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 2;
  return cudaSuccess;
}
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
template <class K>
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, K,
                                                  const cudaLaunchConfig_t*) {
  *n = 2;
  return cudaSuccess;
}
template <class K>
inline int cudaFuncSetAttribute(K, int, int) { return 0; }
inline void fake_launch_clusters(dim3 grid, dim3 block, size_t smem,
                                 dim3 cluster,
                                 const std::function<void()>& body) {
  constexpr size_t kStack = 256 * 1024;
  const unsigned n = block.x * block.y * block.z;
  const unsigned nb = cluster.x * cluster.y * cluster.z;
  std::vector<FakeFiber> fibers(n * nb);
  for (auto& f : fibers) f.stack.reset(new char[kStack]);
  std::vector<std::vector<float>> dyn(nb);
  std::vector<unsigned char*> bases(nb);
  std::vector<FakeBarrier> bars(nb);
  FakeBarrier whole;
  fake_body = &body;
  for (unsigned cz = 0; cz < grid.z; cz += cluster.z)
    for (unsigned cy = 0; cy < grid.y; cy += cluster.y)
      for (unsigned cx = 0; cx < grid.x; cx += cluster.x) {
        whole = FakeBarrier{n * nb};
        for (unsigned r = 0; r < nb; ++r) {
          dyn[r].assign(smem / sizeof(float) + 1, NAN);
          bases[r] = reinterpret_cast<unsigned char*>(dyn[r].data());
          bars[r] = FakeBarrier{n};
          for (unsigned t = 0; t < n; ++t) {
            FakeFiber& f = fibers[r * n + t];
            f.thread = dim3(t % block.x, t / block.x % block.y,
                            t / (block.x * block.y));
            f.block = dim3(cx + r % cluster.x, cy + r / cluster.x % cluster.y,
                           cz + r / (cluster.x * cluster.y));
            f.bar = &bars[r];
            f.smem = bases[r];
            f.done = false;
            getcontext(&f.ctx);
            f.ctx.uc_stack.ss_sp = f.stack.get();
            f.ctx.uc_stack.ss_size = kStack;
            f.ctx.uc_link = &fake_main;
            makecontext(&f.ctx, fake_fiber_entry, 0);
          }
        }
        gridDim = grid;
        fake_cluster_barrier = &whole;
        fake_cluster_smem = bases.data();
        for (unsigned turn = 0, left = n * nb; left > 0; ++turn) {
          const unsigned long before = fake_progress;
          left = 0;
          for (unsigned k = 0; k < n * nb; ++k) {
            FakeFiber& f = fibers[turn % 2 ? n * nb - 1 - k : k];
            if (f.done) continue;
            threadIdx = f.thread;
            blockIdx = f.block;
            fake_barrier = f.bar;
            fake_dyn_smem = f.smem;
            fake_current = &f;
            swapcontext(&fake_main, &f.ctx);
            left += f.done ? 0 : 1;
          }
          if (left > 0 && fake_progress == before) {
            fprintf(stderr, "fake CUDA runtime: a barrier that some thread "
                            "never reaches\n");
            abort();
          }
        }
      }
}
template <class S, class F>
void fake_launch(dim3 grid, dim3 block, size_t smem, S, F body) {
  fake_launch_clusters(grid, block, smem, dim3(1, 1, 1), body);
}
template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c,
                               void (*kernel)(E...), A&&... args) {
  dim3 cluster(1, 1, 1);
  for (unsigned i = 0; i < c->numAttrs; ++i)
    if (c->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cluster = dim3(c->attrs[i].val.clusterDim.x,
                     c->attrs[i].val.clusterDim.y,
                     c->attrs[i].val.clusterDim.z);
  // the runtime refuses a grid of partial clusters
  if (c->gridDim.x % cluster.x || c->gridDim.y % cluster.y ||
      c->gridDim.z % cluster.z)
    return cudaErrorInvalidValue;
  fake_launch_clusters(c->gridDim, c->blockDim, c->dynamicSmemBytes, cluster,
                       [&] { kernel(args...); });
  return cudaSuccess;
}
"""
# the headers FAKE_RUNTIME stands for, by name
FAKE_HEADERS = {
    "cooperative_groups.h": r"""
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  void sync() const { fake_wait(fake_cluster_barrier); }
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    return reinterpret_cast<T*>(
        fake_cluster_smem[rank] +
        (reinterpret_cast<unsigned char*>(p) - fake_dyn_smem));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
""",
    # transaction barriers as two words in their 8 bytes: the completed
    # phases (x 2) plus 1 while armed, and the bytes still expected
    "hopper_async.cuh": r"""
#pragma once
#include <stdint.h>
#include "cuda_runtime.h"
namespace tpulbm_async {
inline int32_t* fake_words(const uint64_t* bar) {
  return reinterpret_cast<int32_t*>(const_cast<uint64_t*>(bar));
}
inline void fake_settle(int32_t* w) {
  if ((w[0] & 1) && w[1] == 0) w[0] += 1;  // armed and complete: next phase
}
inline void barrier_init(uint64_t* bar) {
  fake_words(bar)[0] = 0;
  fake_words(bar)[1] = 0;
}
inline void barrier_init_fence() {}
inline void arm_bytes(uint64_t* bar, uint32_t bytes) {
  int32_t* w = fake_words(bar);
  w[0] |= 1;
  w[1] += static_cast<int32_t>(bytes);
  fake_settle(w);
}
inline void wait_phase(uint64_t* bar, uint32_t parity) {
  while (((fake_words(bar)[0] >> 1) & 1) == static_cast<int32_t>(parity))
    fake_yield();
}
template <class T>
inline T* fake_remote(const T* p, uint32_t rank) {
  return reinterpret_cast<T*>(
      fake_cluster_smem[rank] +
      (reinterpret_cast<const unsigned char*>(p) - fake_dyn_smem));
}
inline void store_remote(const float* at, const uint64_t* bar, uint32_t rank,
                         float v) {
  *fake_remote(at, rank) = v;
  int32_t* w = fake_words(fake_remote(bar, rank));
  w[1] -= 4;
  fake_settle(w);
}
inline void prefetch_l1(const void*) {}
inline void cluster_arrive_relaxed() { fake_cluster_arrive(); }
inline void cluster_wait() { fake_cluster_wait(); }
}  // namespace tpulbm_async
""",
    "cuda_pipeline.h": r"""
#pragma once
#include <cstring>
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t = 0) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
""",
}
_LAUNCH = re.compile(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)
_DYNAMIC = re.compile(r"extern __shared__ float (\w+)\[\];")
GXX_FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC")


_HEADER = re.compile(r'^#include "(\w+\.cuh)"\n', re.M)


def _inline_kernel_headers(src: str) -> str:
    """`src` with each csrc/ header that launches a kernel or declares
    dynamic shared memory (the D2Q9 march, d2q9_march.cuh) pasted in place
    of its #include, so that host_source rewrites it too."""
    def paste(m):
        text = (cuda_build.SOURCE_DIR / m.group(1)).read_text()
        if "<<<" not in text and "extern __shared__" not in text:
            return m.group(0)
        return text.replace("#pragma once\n", "")
    return _HEADER.sub(paste, src)


def host_source(src: str) -> str:
    """A .cu source (with the kernel headers it includes) with its
    launches and its dynamic shared memory rewritten for FAKE_RUNTIME."""
    src = _DYNAMIC.sub(r"float* \1 = reinterpret_cast<float*>(fake_dyn_smem);",
                       _inline_kernel_headers(src))
    return _LAUNCH.sub(lambda m: f"fake_launch({m.group(2)}, [&] {{ "
                       f"{m.group(1)}({m.group(3)}); }});", src)


def host_library(text: str, defines: tuple = (),
                 runtime: str = FAKE_RUNTIME) -> ctypes.CDLL:
    """`text` (a csrc/ source rewritten for the host) built with g++ against
    `runtime` and FAKE_HEADERS, once a session: the library lies under
    cuda_build.build_dir()/host, named by a hash of the runtime, the
    source, every csrc/ header, the defines and the flags, and a file lock
    keeps the test workers from building it twice."""
    import fcntl
    import hashlib
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' sources for the host")
    h = hashlib.sha256()
    for part in (runtime, *FAKE_HEADERS.values(), text,
                 *(p.read_text() for p in
                   sorted(cuda_build.SOURCE_DIR.glob("*.cuh"))),
                 *defines, *GXX_FLAGS):
        h.update(part.encode() + b"\0")
    out = cuda_build.build_dir() / "host" / h.hexdigest()[:24]
    so = out / "kernel.so"
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            (out / "cuda_runtime.h").write_text(runtime)
            for name, header in FAKE_HEADERS.items():
                (out / name).write_text(header)
            cpp = out / "kernel.cpp"
            cpp.write_text(text)
            part = out / "kernel.so.part"
            subprocess.run([gxx, *GXX_FLAGS, *defines, "-I", str(out), "-I",
                            str(cuda_build.SOURCE_DIR), str(cpp), "-o",
                            str(part)], check=True, capture_output=True)
            part.rename(so)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def host_cuda():
    """build(source, defines) -> the ctypes library of a csrc/ kernel
    source built for the host with g++ against FAKE_RUNTIME."""
    def build(source: str, defines: tuple = ()) -> ctypes.CDLL:
        return host_library(host_source(
            (cuda_build.SOURCE_DIR / source).read_text()), tuple(defines))

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
