"""Several processes on torch.distributed (tpulbm_torch/parallel/
multihost.py): real OS processes over the gloo backend on the host,
held bit for bit to one process driving every shard.

* the rings: halo.exchange and halo.pad_block of numpy-seeded blocks on
  (2,1), (1,2), (2,2) and (4,2) meshes over 2 and 4 processes, every
  periodic x and y, depths 1-4, 2-D and 3-D blocks;
* tpulbm's five dryrun_multichip families (tests/test_torch_mesh_
  multiphase.py) on their (4,2) and (8,1) meshes over 4 processes of 2
  shards, through the kernel module: bitwise the one-process mesh chunk,
  within F32_TOL of the one-device chunk;
* the Runner: a 64x32 cylinder on (2,1) over 2 processes, f64 on the
  plain tier and f32 through the kernel module, each process with its own
  output directory: process 0's artifacts are the one-process mesh run's
  bytes, the other writes none, a resume gives an unbroken run's bytes,
  the forces match tpulbm's one-process Runner at the artifact tolerance,
  a corrupt checkpoint raises on both processes (process 0's manifest;
  process 1's shard file);
* checkpoints both ways with tpulbm's one-process load_sharded;
* two processes that save into one directory and prune it at once;
* the CLI's --distributed.

Each spawn has its own wall limit; past it every child is killed and the
test fails. The children import this module: its top level imports
neither jax nor tpulbm.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from tpulbm_torch.config import SimulationParams
from tpulbm_torch.models import make_problem
from tpulbm_torch.parallel import halo, multihost, sharded_step
from tpulbm_torch.parallel.mesh import make_mesh
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import checkpoint as ckpt

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
SPAWN_LIMIT = 120

CHILD = textwrap.dedent("""
    import json, sys
    sys.path[:0] = [__TESTS__, __REPO__]
    import torch
    torch.set_num_threads(1)
    from tpulbm_torch.parallel import multihost
    multihost.initialize(backend="gloo", cpu=True)
    import test_torch_multihost as T
    try:
        getattr(T, "task_" + sys.argv[1])(json.loads(sys.argv[2]))
    finally:
        multihost.shutdown()
""").replace("__TESTS__", repr(TESTS)).replace("__REPO__", repr(REPO))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(n: int, argv: list, limit: float = SPAWN_LIMIT, env=None):
    """Run `argv` (after the interpreter) in n processes that torchrun's
    variables join; returns [(exit code, output)] by rank. Past `limit`
    seconds every child is killed and the test fails."""
    port = _free_port()
    procs = []
    for rank in range(n):
        child_env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                         LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                         **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable] + argv, env=child_env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + limit
    outs = []
    for proc in procs:
        try:
            out, _ = proc.communicate(
                timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            tails = [p.communicate()[0].decode(errors="replace")[-2000:]
                     for p in procs]
            pytest.fail(f"{n} processes {argv[:3]} passed the {limit} s "
                        "limit; their output:\n" + "\n---\n".join(tails))
        outs.append(out.decode(errors="replace"))
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def run_tasks(n: int, task: str, args: dict, limit: float = SPAWN_LIMIT):
    """task_<task>(args) of this module in n processes; every child must
    exit 0."""
    results = spawn(n, ["-c", CHILD, task, json.dumps(args)], limit)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} of {n} exited {rc}:\n{out[-4000:]}"
    return results


def _cpu_mesh(shape):
    """A mesh of host shards: this process's run of them across several."""
    per = shape[0] * shape[1] // multihost.process_count()
    return make_mesh(tuple(shape), devices=["cpu"] * per)


# ---- the rings --------------------------------------------------------------

HALO_MESHES = [((2, 1), 2), ((1, 2), 2), ((2, 2), 2), ((2, 2), 4),
               ((4, 2), 2), ((4, 2), 4)]


def _halo_cases(world: int) -> list:
    return [dict(mesh=mesh, px=px, py=py, depth=depth, dims=dims)
            for mesh, p in HALO_MESHES if p == world
            for dims in (2, 3) for px in (False, True) for py in (False, True)
            for depth in (1, 2, 3, 4)]


def _case_id(case: dict) -> str:
    return (f"{case['mesh'][0]}x{case['mesh'][1]}-{case['dims']}d-"
            f"px{int(case['px'])}-py{int(case['py'])}-n{case['depth']}")


def _halo_results(case: dict) -> dict:
    """{key: host array} of this process's shards' rings and padded blocks
    for one case: numpy-seeded blocks and ghost equilibrium."""
    my, mx = case["mesh"]
    rng = np.random.default_rng(zlib.crc32(_case_id(case).encode()))
    q = 9 if case["dims"] == 2 else 19
    lead = (q,) if case["dims"] == 2 else (q, 3)
    whole = rng.standard_normal(lead + (my * 5, mx * 6)).astype(np.float32)
    eq = rng.standard_normal(q).astype(np.float32)
    mesh = _cpu_mesh((my, mx))
    blocks = sharded_step.split(mesh, whole)
    kw = dict(eq_ring=eq, depth=case["depth"], periodic_x=case["px"],
              periodic_y=case["py"], mesh=mesh)
    found = {"x": halo.exchange(blocks, x_rings=True, **kw),
             "pad": [[None if p is None else (p,) for p in row]
                     for row in halo.pad_block(blocks, **kw)]}
    if mx == 1:
        found["rows"] = halo.exchange(blocks, x_rings=False, **kw)
    out = {}
    for kind, grid in found.items():
        for iy, ix in mesh.local_shards():
            for k, t in enumerate(grid[iy][ix]):
                if t is not None:
                    out[f"{_case_id(case)}|{kind}|{iy}|{ix}|{k}"] = t.numpy()
    return out


def task_halo(args: dict) -> None:
    out = {}
    for case in _halo_cases(multihost.process_count()):
        out.update(_halo_results(case))
    np.savez(Path(args["out"]) / f"rank{multihost.process_index()}.npz",
             **out)


@pytest.fixture(scope="module")
def halo_runs(tmp_path_factory):
    """world -> {key: array} of every process's rings, one spawn a world
    size, run at first use."""
    runs = {}

    def get(world: int) -> dict:
        if world not in runs:
            out = tmp_path_factory.mktemp(f"halo{world}")
            run_tasks(world, "halo", {"out": str(out)})
            got = {}
            for rank in range(world):
                with np.load(out / f"rank{rank}.npz") as data:
                    for key in data.files:
                        assert key not in got, f"{key} from two processes"
                        got[key] = data[key]
            runs[world] = got
        return runs[world]
    return get


@pytest.mark.parametrize("mesh,world", HALO_MESHES,
                         ids=[f"{m[0]}x{m[1]}-{w}proc" for m, w in
                              HALO_MESHES])
@pytest.mark.parametrize("dims", [2, 3])
def test_rings_across_processes_are_one_process_rings(halo_runs, mesh, world,
                                                      dims):
    got = halo_runs(world)
    cases = [c for c in _halo_cases(world)
             if c["mesh"] == mesh and c["dims"] == dims]
    assert len(cases) == 16
    for case in cases:
        want = _halo_results(case)
        mine = {k: v for k, v in got.items()
                if k.startswith(_case_id(case) + "|")}
        assert sorted(mine) == sorted(want), _case_id(case)
        for key, ref in want.items():
            assert mine[key].tobytes() == ref.tobytes(), key


# ---- the five dryrun families ----------------------------------------------

def task_dryrun(args: dict) -> None:
    """Each family's 4-step chunk through the kernel module on this
    process's shards; process 0 saves the gathered state."""
    for name, (params_json, shape, env, f0_path) in args["families"].items():
        problem = make_problem(SimulationParams.from_json(params_json))
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            mesh = _cpu_mesh(shape)
            chunk = sharded_step.make_chunk_fn(problem, mesh, 4,
                                               backend="pallas")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        assert chunk.mode != "one-device"
        shards = sharded_step.split(mesh, np.load(f0_path))
        whole = multihost.fetch_global(chunk(shards), mesh)
        if multihost.is_primary():
            np.save(Path(args["out"]) / f"{name}.npy", whole)


@pytest.fixture(scope="module")
def dryrun_run(tmp_path_factory):
    from test_torch_compat import port_params
    from test_torch_mesh import perturbed
    from test_torch_mesh_multiphase import _dryrun_families
    from tpulbm.models import make_problem as jax_problem

    out = tmp_path_factory.mktemp("dryrun")
    families = {}
    for name, (params, shape, env) in _dryrun_families().items():
        f0 = perturbed(jax_problem(params))
        np.save(out / f"{name}_f0.npy", f0)
        families[name] = (port_params(params).to_json(), shape, env,
                          str(out / f"{name}_f0.npy"))
    run_tasks(4, "dryrun", {"families": families, "out": str(out)})
    return out


@pytest.mark.parametrize("family", ["bgk-cylinder", "bouzidi-blocked",
                                    "multiphase", "sphere-3d-tiled",
                                    "thermal-rb"])
def test_dryrun_families_across_four_processes(dryrun_run, monkeypatch,
                                               family):
    from test_torch_3d_blocking import _setenv
    from test_torch_compat import port_problem
    from test_torch_mesh import _port_chunks
    from test_torch_mesh_multiphase import _dryrun_families
    from test_torch_mesh_thermal import F32_TOL
    from tpulbm_torch import stepper

    params, shape, env = _dryrun_families()[family]
    assert shape[0] * shape[1] in (4, 8)
    _setenv(monkeypatch, env)
    f0 = np.load(dryrun_run / f"{family}_f0.npy")
    got = np.load(dryrun_run / f"{family}.npy")
    one_process, chunk = _port_chunks(params, shape, 4, 1, f0,
                                      backend="pallas")
    assert chunk.mode != "one-device"
    assert got.tobytes() == one_process[0].tobytes()
    want = stepper.make_chunk_fn(port_problem(params), "cpu", 4)(
        torch.from_numpy(f0.copy()))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want.numpy(), **F32_TOL)


# ---- the Runner -------------------------------------------------------------

RUNNER_STEPS, RUNNER_HALF = 80, 40
# a one-device run's single .npz, statistics included, resumed on a mesh:
# process 0 broadcasts the state and the sums
NPZ_RESUME = dict(checkpoint_every=1, stats_from=20)
RUNNER_CASES = {"f64-plain": dict(backend="jax", precision="f64"),
                "f32-kernel": dict(backend="pallas", precision="f32"),
                # two shards a process: the force partials of the three
                # shards the cylinder cuts reduce in the order one process
                # keeps; probes on two processes
                "f64-plain-4x1": dict(backend="jax", precision="f64",
                                      mesh_shape=(4, 1), cylinder_radius=0.3,
                                      probe_points=((0.3, 0.2), (0.7, 0.8)))}
ARTIFACTS = ("forces.csv", "velocity_field.csv", "simulation_params.csv")


def runner_params(out, **kw) -> SimulationParams:
    base = dict(nx=64, ny=32, tau=0.6, inlet_velocity=0.05,
                num_timesteps=RUNNER_STEPS, output_frequency=20,
                output_dir=str(out), mesh_shape=(2, 1), enable_vtk=False)
    base.update(kw)
    return SimulationParams(**base)


def _run(params, resume: bool = False):
    result = Runner(params, device="cpu", verbose=False).run(resume=resume)
    assert result.success and result.final_step == params.num_timesteps
    return result


def _expect_failure(params) -> str:
    try:
        Runner(params, device="cpu", verbose=False).run(resume=True)
    except RuntimeError as e:
        return str(e)
    return "no error"


def task_runner(args: dict) -> None:
    """The unbroken run, a run resumed from its own checkpoint, a resume
    from a corrupt checkpoint of each kind, and (f64) a run in a directory
    both processes share and a resume from tpulbm's checkpoint; each
    process in directories of its own but the shared one."""
    rank = multihost.process_index()
    base = Path(args["base"])
    p = SimulationParams.from_json(args["params"])

    def at(name: str, **kw) -> SimulationParams:
        return p.replace(output_dir=str(base / f"{name}{rank}"), **kw)

    _run(at("full"))
    _run(at("resumed", num_timesteps=RUNNER_HALF, checkpoint_every=1))
    _run(at("resumed", checkpoint_every=1), resume=True)
    # a corrupt checkpoint: process 0's manifest, then process 1's shards
    later = at("resumed", num_timesteps=RUNNER_STEPS + 20,
               checkpoint_every=1)
    path = Path(ckpt.latest(str(base / f"resumed{rank}" / "checkpoints")))
    manifest = (path / "manifest.json").read_bytes()
    if rank == 0:
        (path / "manifest.json").write_text("{ not json")
    errors = {"manifest": _expect_failure(later)}
    if rank == 0:
        (path / "manifest.json").write_bytes(manifest)
    else:
        shard = path / f"proc_{rank:05d}.npz"
        shard.write_bytes(shard.read_bytes()[:100])
    errors["shard"] = _expect_failure(later)
    (base / f"errors{rank}.json").write_text(json.dumps(errors))
    if args["both_ways"]:
        _run(p.replace(output_dir=str(base / "shared"),
                       num_timesteps=RUNNER_HALF, checkpoint_every=1))
        _run(at("from_tpulbm", checkpoint_every=1), resume=True)
        _run(at("from_npz", **NPZ_RESUME), resume=True)


@pytest.fixture(scope="module")
def runner_runs(tmp_path_factory):
    """case -> the directory of its 2-process runs, spawned at first use;
    the f64 case starts from a copy of tpulbm's per-shard checkpoint."""
    runs = {}

    def get(case: str) -> Path:
        if case not in runs:
            base = tmp_path_factory.mktemp(case)
            both_ways = case == "f64-plain"
            params = runner_params(base, **RUNNER_CASES[case])
            if both_ways:
                _tpulbm_run(runner_params(
                    base / "tpulbm_half", num_timesteps=RUNNER_HALF,
                    checkpoint_every=1, **RUNNER_CASES[case]))
                _run(runner_params(base / "npz_half", mesh_shape=(1, 1),
                                   num_timesteps=RUNNER_HALF,
                                   **NPZ_RESUME, **RUNNER_CASES[case]))
                for rank in range(2):
                    shutil.copytree(base / "tpulbm_half",
                                    base / f"from_tpulbm{rank}")
                    shutil.copytree(base / "npz_half",
                                    base / f"from_npz{rank}")
            run_tasks(2, "runner", {"base": str(base),
                                    "params": params.to_json(),
                                    "both_ways": both_ways})
            runs[case] = base
        return runs[case]
    return get


def _tpulbm_run(params, resume: bool = False):
    """tpulbm's Runner in this process on params.mesh_shape's virtual
    devices, without probes (tpulbm's refuse a sharded state)."""
    import jax
    from tpulbm.config import SimulationParams as JaxParams
    from tpulbm.runner import Runner as JaxRunner
    jparams = JaxParams.from_json(params.replace(probe_points=()).to_json())
    n = params.mesh_shape[0] * params.mesh_shape[1]
    result = JaxRunner(jparams, devices=jax.devices()[:n],
                       verbose=False).run(resume=resume)
    assert result.success


def _same_files(a: Path, b: Path, names=ARTIFACTS) -> None:
    if (b / "probes.csv").exists():
        names = names + ("probes.csv",)
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_runner_process0_writes_the_one_process_bytes(runner_runs, tmp_path,
                                                      case):
    base = runner_runs(case)
    _run(runner_params(tmp_path / "one", **RUNNER_CASES[case]))
    _same_files(base / "full0", tmp_path / "one")
    # process 1 writes no artifact; its checkpoints only its own shards
    assert sorted(os.listdir(base / "full1")) == []
    assert sorted(os.listdir(base / "resumed1")) == ["checkpoints"]
    latest = Path(ckpt.latest(str(base / "resumed1" / "checkpoints")))
    assert sorted(os.listdir(latest)) == ["manifest.json", "proc_00001.npz"]
    manifest = json.loads((latest / "manifest.json").read_text())
    my = RUNNER_CASES[case].get("mesh_shape", (2, 1))[0]
    assert manifest["files"] == {f"shard_0_{iy * 32 // my}_0":
                                 f"proc_{iy * 2 // my:05d}.npz"
                                 for iy in range(my)}


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_runner_resume_across_processes(runner_runs, tmp_path, case):
    # the bytes of one process resumed the same way; on the plain tier
    # also an unbroken run's (the kernel module's CPU path rounds a
    # chunk's sums by its depth, so a run chunked otherwise differs in the
    # last bits there: tests/test_torch_mesh_resume.py)
    base = runner_runs(case)
    one = runner_params(tmp_path, checkpoint_every=1, **RUNNER_CASES[case])
    _run(one.replace(num_timesteps=RUNNER_HALF))
    _run(one, resume=True)
    _same_files(base / "resumed0", tmp_path)
    if case == "f64-plain":
        _same_files(base / "resumed0", base / "full0")


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_runner_forces_match_tpulbm(runner_runs, tmp_path, case):
    from test_torch_resume import _rows
    base = runner_runs(case)
    # tpulbm's plain tier at the case's precision (its Pallas tier in
    # interpret mode takes half a minute here)
    _tpulbm_run(runner_params(tmp_path, **{**RUNNER_CASES[case],
                                           "backend": "jax"}))
    got, ref = _rows(base / "full0" / "forces.csv"), \
        _rows(tmp_path / "forces.csv")
    assert [r[0] for r in got] == [r[0] for r in ref]
    np.testing.assert_allclose(
        np.array([[float(v) for v in r[1:3]] for r in got]),
        np.array([[float(v) for v in r[1:3]] for r in ref]),
        rtol=1e-4, atol=5e-6)


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_runner_corrupt_checkpoint_raises_on_every_process(runner_runs,
                                                           case):
    base = runner_runs(case)
    errors = [json.loads((base / f"errors{r}.json").read_text())
              for r in range(2)]
    for rank, err in enumerate(errors):
        assert err["manifest"].startswith(
            "checkpoint load failed on process 0 (JSONDecodeError"), rank
        assert err["shard"].startswith(
            "checkpoint load failed on process 1"), rank


def test_checkpoints_both_ways_with_tpulbm(runner_runs, tmp_path):
    """A checkpoint both processes wrote into one directory loads in
    tpulbm's one-process load_sharded, bit for bit the one-process port
    run's; a run resumed across processes from tpulbm's checkpoint writes
    the bytes of the one-process port run resumed from it."""
    import jax
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P
    from tpulbm.utils import checkpoint as jckpt

    base = runner_runs("f64-plain")
    case = RUNNER_CASES["f64-plain"]
    one = runner_params(tmp_path / "one", num_timesteps=RUNNER_HALF,
                        checkpoint_every=1, **case)
    _run(one)
    shared = ckpt.latest(str(base / "shared" / "checkpoints"))
    assert sorted(os.listdir(shared)) == ["manifest.json", "proc_00000.npz",
                                          "proc_00001.npz"]
    mesh = JaxMesh(np.array(jax.devices()[:2]).reshape(2, 1), ("y", "x"))
    step, f = jckpt.load_sharded(shared, mesh, P(None, "y", "x"))
    assert step == RUNNER_HALF
    _, blocks = ckpt.load_sharded(ckpt.latest(str(tmp_path / "one" /
                                                  "checkpoints")), (2, 1))
    assert np.asarray(f).tobytes() == np.concatenate(
        [row[0] for row in blocks], axis=-2).tobytes()
    assert (base / "shared" / "forces.csv").read_bytes() == \
        (tmp_path / "one" / "forces.csv").read_bytes()
    # the reverse: tpulbm's checkpoint resumed by two processes and by one
    shutil.copytree(base / "tpulbm_half", tmp_path / "from_tpulbm")
    _run(runner_params(tmp_path / "from_tpulbm", checkpoint_every=1,
                       **case), resume=True)
    _same_files(base / "from_tpulbm0", tmp_path / "from_tpulbm")


def test_single_npz_resumes_across_processes(runner_runs, tmp_path):
    """A one-device run's .npz with its statistics, resumed by two
    processes (process 0 reads it and broadcasts state and sums) and by
    one: the same bytes."""
    base = runner_runs("f64-plain")
    assert sorted(os.listdir(base / "npz_half" / "checkpoints"))[-1] == \
        f"ckpt_{RUNNER_HALF:09d}.npz"
    shutil.copytree(base / "npz_half", tmp_path / "one")
    _run(runner_params(tmp_path / "one", **NPZ_RESUME,
                       **RUNNER_CASES["f64-plain"]), resume=True)
    _same_files(base / "from_npz0", tmp_path / "one")
    with np.load(base / "from_npz0" / "stats_fields.npz") as a, \
            np.load(tmp_path / "one" / "stats_fields.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].tobytes() == b[key].tobytes(), key


# ---- pruning a shared checkpoint directory ----------------------------------

PRUNE_OLD, PRUNE_FILES, PRUNE_STEPS = 24, 40, (100, 101, 102)


def task_prune(args: dict) -> None:
    """Both processes save PRUNE_STEPS into one directory with keep=2, each
    its own shard of a (2,1) grid, and so prune the same old checkpoints
    at once."""
    rank = multihost.process_index()
    mesh = _cpu_mesh((2, 1))
    grid = [[np.full((9, 4, 6), float(rank)) if mesh.is_local(iy, 0)
             else None] for iy in range(2)]
    for step in PRUNE_STEPS:
        ckpt.save_sharded(args["dir"], step, grid, runner_params(args["dir"]),
                          keep=2, owners=mesh.processes)


def test_processes_sharing_a_directory_both_prune(tmp_path):
    shared = tmp_path / "checkpoints"
    for k in range(PRUNE_OLD):
        old = shared / f"ckpt_{k:09d}"
        old.mkdir(parents=True)
        for j in range(PRUNE_FILES):
            (old / f"part{j}").write_bytes(b"x")
    run_tasks(2, "prune", {"dir": str(shared)})
    assert sorted(os.listdir(shared)) == [f"ckpt_{s:09d}"
                                          for s in PRUNE_STEPS[-2:]]
    step, blocks = ckpt.load_sharded(str(shared / "ckpt_000000102"), (2, 1))
    assert step == 102
    assert [float(row[0][0, 0, 0]) for row in blocks] == [0.0, 1.0]


@pytest.mark.parametrize("error", ["raced", "denied"])
def test_pruning_passes_over_only_what_another_process_deleted(
        tmp_path, monkeypatch, error):
    """A checkpoint another process deleted first is passed over; any other
    error of the deletion raises."""
    real = ckpt.shutil.rmtree

    def rmtree(path, *a, **kw):
        if error == "denied":
            raise PermissionError(13, "denied", path)
        real(path)                          # the other process, first
        raise FileNotFoundError(2, "gone", path)

    grid = [[np.zeros((9, 4, 6))], [np.ones((9, 4, 6))]]
    params = runner_params(tmp_path)
    ckpt.save_sharded(str(tmp_path), 1, grid, params)
    monkeypatch.setattr(ckpt.shutil, "rmtree", rmtree)
    if error == "denied":
        with pytest.raises(PermissionError):
            ckpt.save_sharded(str(tmp_path), 2, grid, params, keep=1)
        assert (tmp_path / "ckpt_000000001").exists()
    else:
        ckpt.save_sharded(str(tmp_path), 2, grid, params, keep=1)
        assert sorted(p.name for p in tmp_path.glob("ckpt_*")) == [
            "ckpt_000000002"]


# ---- the CLI ----------------------------------------------------------------

CLI = ["--cpu", "--mesh", "2x1", "--nx", "64", "--ny", "32", "--tau", "0.6",
       "--inlet-velocity", "0.05", "--num-timesteps", "60",
       "--output-frequency", "20", "--backend", "jax", "--precision", "f64",
       "--no-vtk"]


def test_cli_distributed_runs_across_two_processes(tmp_path, capsys):
    from tpulbm_torch.__main__ import main
    runs = spawn(2, ["-m", "tpulbm_torch", "--distributed", *CLI,
                     "--output-dir", str(tmp_path / "two")])
    for rank, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out[-4000:]}"
    assert "2 processes over gloo" in runs[0][1]
    assert "Timestep" not in runs[1][1] and "Device mesh" not in runs[1][1]
    assert main([*CLI, "--output-dir", str(tmp_path / "one")]) == 0
    _same_files(tmp_path / "two", tmp_path / "one")


def test_distributed_without_torchrun_variables_raises(monkeypatch):
    from tpulbm_torch.__main__ import main
    for name in multihost.ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE is not set"):
        main(["--distributed", *CLI])
    assert multihost.process_count() == 1


@pytest.mark.parametrize("ask", ["nccl_on_host", "no_card", "unknown"])
def test_initialize_refuses_rather_than_falls_back(monkeypatch, ask):
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT="1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw, exc, match = {
        "nccl_on_host": (dict(backend="nccl", cpu=True), ValueError,
                         "NCCL moves card tensors"),
        "no_card": (dict(), RuntimeError, "no CUDA device"),
        "unknown": (dict(backend="mpi", cpu=True), ValueError,
                    "unknown backend")}[ask]
    with pytest.raises(exc, match=match):
        multihost.initialize(**kw)
    assert multihost.backend() is None and multihost.process_count() == 1
