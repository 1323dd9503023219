"""Reynolds statistics and point probes (ROADMAP Queue 1 item 15) against
tpulbm, on the CPU.

* the sample and probe functions (diagnostics.stats_sample_fn, probes_fn,
  probe_cells, stats_pair_names) against tpulbm's in f64 at 1e-12 on the
  2-D and 3-D boxes, the cylinder (its solid-cell overrides) and
  Rayleigh-Bénard (a probe's temperature), and tpulbm's refusals of a
  probe point;
* the writers (ProbeWriter, write_stats_fields) byte for byte against
  tpulbm's, the resume dedup included;
* the Runner's stats_fields.npz, probes.csv, velocity_field.csv and
  simulation_params.csv against tpulbm's Runner on the same 2-D
  Kolmogorov parameters, f32 at the artifact tolerance rtol 1e-4 /
  atol 5e-6, the super path and the tail both sampled, stats_from inside
  a window;
* the accumulators on a (2, 2) host mesh bit for bit against one device
  from the same states (the sums are cell-local; on the card the states
  too are bitwise one device's, chip_smoke.py); the (2, 2) Runner's files
  against the one-device Runner's within the tolerance (on the CPU the
  plain ring steps round the state otherwise);
* resume: the accumulators ride the checkpoints, so a resumed run writes
  the straight run's stats_fields.npz byte for byte (one device and
  (2, 2)); checkpoints with statistics move both ways between the
  packages, in the single .npz and the per-shard format, and hold
  tpulbm's keys and manifest entries.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulbm.config import SimulationParams
from tpulbm.models import make_problem as jax_problem
from tpulbm.ops import diagnostics as jdiag
from tpulbm.runner import Runner as JaxRunner
from tpulbm.utils import io as jio
from tpulbm_torch.ops import diagnostics
from tpulbm_torch.parallel import sharded_step
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import checkpoint as ckpt
from tpulbm_torch.utils import io as io_mod
from test_torch_compat import port_params, port_problem
from test_torch_mesh import cpu_mesh

ART = dict(rtol=1e-4, atol=5e-6)
KOL = dict(problem="kolmogorov", nx=32, ny=16, tau=0.8, kolmogorov_n=2,
           inlet_velocity=0.05, periodic_x=True, cylinder_radius=0.0)
PROBES_2D = ((0.5, 0.25), (0.1, 0.9), (1.0, 0.0))
MESH = (2, 2)

FUNCTION_CASES = {
    "kolmogorov": dict(KOL, probe_points=PROBES_2D),
    "kolmogorov3d": dict(KOL, nz=8, probe_points=((0.5, 0.25, 0.5),
                                                  (0.0, 1.0, 0.9))),
    "cylinder": dict(nx=48, ny=24, tau=0.6, inlet_velocity=0.05,
                     probe_points=((0.25, 0.5), (0.7, 0.4))),
    "rayleigh-benard": dict(problem="rayleigh-benard", nx=32, ny=16,
                            tau=0.55, thermal_tau=0.5704,
                            cylinder_radius=0.0, inlet_velocity=0.0,
                            periodic_x=True, probe_points=((0.5, 0.5),)),
}


def _noisy(state, seed):
    rng = np.random.default_rng(seed)
    return state * (1.0 + 0.1 * (2.0 * rng.random(state.shape) - 1.0))


@pytest.mark.parametrize("case", FUNCTION_CASES)
def test_sample_and_probe_functions_match_tpulbm(case):
    params = SimulationParams(precision="f64", **FUNCTION_CASES[case])
    ref, mine = jax_problem(params), port_problem(params)
    f = _noisy(ref.initial_state(), 5)
    want = jdiag.stats_sample_fn(ref)(jnp.asarray(f))
    got = diagnostics.stats_sample_fn(mine, "cpu")(torch.from_numpy(f))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-15)
    d = mine.lattice.D
    assert diagnostics.stats_pair_names(d) == jdiag.stats_pair_names(d)
    assert diagnostics.probe_cells(mine) == jdiag.probe_cells(ref)
    want = np.asarray(jdiag.probes_fn(ref)(jnp.asarray(f)))
    got = diagnostics.probes_fn(mine)(torch.from_numpy(f)).numpy()
    assert got.shape == want.shape == (len(params.probe_points),
                                       1 + d + (case == "rayleigh-benard"))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("points", [((0.5, 0.5, 0.5),), ((0.5, 1.5),),
                                    ((-0.1, 0.5),)],
                         ids=["dimension", "above", "below"])
def test_probe_points_raise_tpulbms_error(points):
    params = SimulationParams(nx=32, ny=16, probe_points=points)
    with pytest.raises(ValueError) as want:
        jdiag.probe_cells(jax_problem(params))
    with pytest.raises(ValueError) as got:
        diagnostics.probe_cells(port_problem(params))
    assert str(got.value) == str(want.value)


def test_writers_write_tpulbms_bytes(tmp_path):
    rows = np.random.default_rng(2).normal(size=(5, 3, 4))
    for pkg, mod in (("port", io_mod), ("ref", jio)):
        path = tmp_path / f"{pkg}.csv"
        w = mod.ProbeWriter(str(path), n_probes=3, ndim=3)
        for t in range(4):
            w.record(10 * t, rows[t])
        w.close()
        # a resume at t = 20 keeps the rows before it and records again
        w = mod.ProbeWriter(str(path), n_probes=3, ndim=3, append=True,
                            resume_step=20)
        w.record(20, rows[4])
        w.close()
        thermal = mod.ProbeWriter(str(tmp_path / f"{pkg}_T.csv"),
                                  n_probes=1, ndim=2, thermal=True)
        thermal.record(0, rows[0][:1, :4])
        thermal.close()
        (tmp_path / pkg).mkdir()
        mod.write_stats_fields(rows[0, 0], rows[1], rows[2:5, 0],
                               ["uxux", "uxuy", "uyuy"], 7, 120, 20,
                               str(tmp_path / pkg))
    for name in ("{}.csv", "{}_T.csv"):
        assert (tmp_path / name.format("port")).read_bytes() == \
            (tmp_path / name.format("ref")).read_bytes()
    with np.load(tmp_path / "port" / "stats_fields.npz") as a, \
            np.load(tmp_path / "ref" / "stats_fields.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def _kol_params(tmp, **kw):
    d = dict(KOL, precision="f32", num_timesteps=97, output_frequency=10,
             stats_from=25, enable_vtk=False, probe_points=PROBES_2D,
             output_dir=str(tmp))
    d.update(kw)
    return SimulationParams(**d)


def _close_stats(a_dir, b_dir, exact=False, **tol):
    with np.load(a_dir / "stats_fields.npz") as a, \
            np.load(b_dir / "stats_fields.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if exact or a[k].dtype == np.int64:
                assert np.array_equal(a[k], b[k]), k
            else:
                np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


def _table(path):
    lines = path.read_text().splitlines()
    return lines[0], np.array([[float(v) for v in ln.split(",")]
                               for ln in lines[1:]])


def _close_csv(a, b, **tol):
    ha, ta = _table(a)
    hb, tb = _table(b)
    assert ha == hb and ta.shape == tb.shape
    np.testing.assert_array_equal(ta[:, 0], tb[:, 0])
    np.testing.assert_allclose(ta[:, 1:], tb[:, 1:], **tol)


def test_runner_statistics_and_probes_match_tpulbm(tmp_path):
    # 97 steps every 10: one super-chunk of 8 intervals (stats_from 25
    # skips its first three), then the tail's per-interval samples
    ref = JaxRunner(_kol_params(tmp_path / "ref", backend="jax"),
                    verbose=False).run()
    got = Runner(port_params(_kol_params(tmp_path / "port")), device="cpu",
                 verbose=False).run()
    assert ref.success and got.success
    with np.load(tmp_path / "port" / "stats_fields.npz") as st:
        assert (int(st["n_samples"]), int(st["first_step"]),
                int(st["sample_interval"])) == (7, 30, 10)
    _close_stats(tmp_path / "port", tmp_path / "ref", **ART)
    _close_csv(tmp_path / "port" / "probes.csv",
               tmp_path / "ref" / "probes.csv", **ART)
    _close_csv(tmp_path / "port" / "velocity_field.csv",
               tmp_path / "ref" / "velocity_field.csv", **ART)
    rows = [(tmp_path / d / "simulation_params.csv").read_text()
            .splitlines() for d in ("port", "ref")]
    assert [r.split(",")[0] for r in rows[0]] == \
        [r.split(",")[0] for r in rows[1]]


def test_mesh_accumulators_equal_one_device_bitwise():
    # the same states, sampled by the (2, 2) mesh's shards and by one
    # device: the same bits in every sum, the count and the means
    params = port_params(_kol_params("unused"))
    problem = port_problem(params)
    one, four = cpu_mesh((1, 1)), cpu_mesh(MESH)
    stats = [sharded_step.Stats(sharded_step.Diagnostics(problem, m),
                                torch.float32) for m in (one, four)]
    f = torch.from_numpy(_noisy(problem.initial_state(), 11)
                         .astype(np.float32))
    step = sharded_step.make_chunk_fn(problem, one, 3)
    for _ in range(4):
        stats[0].add([[f]])
        stats[1].add(sharded_step.split(four, f))
        f = step([[f]])[0][0]
    assert torch.equal(stats[0].count, stats[1].count)
    for name in sharded_step.Stats.NAMES:
        assert torch.equal(stats[0].sums[name][0][0],
                           sharded_step.gather(stats[1].sums[name]))
    for a, b in zip(stats[0].means(), stats[1].means()):
        assert torch.equal(a, b)
    diag = sharded_step.Diagnostics(problem, four)
    assert torch.equal(diag.probes(sharded_step.split(four, f)),
                       diagnostics.probes_fn(problem)(f))


def test_mesh_runner_statistics_match_one_device(tmp_path):
    one = Runner(port_params(_kol_params(tmp_path / "one")), device="cpu",
                 verbose=False).run()
    mesh = Runner(port_params(_kol_params(tmp_path / "mesh",
                                          mesh_shape=MESH)),
                  device="cpu", verbose=False).run()
    assert one.success and mesh.success
    _close_stats(tmp_path / "mesh", tmp_path / "one", **ART)
    _close_csv(tmp_path / "mesh" / "probes.csv",
               tmp_path / "one" / "probes.csv", **ART)


def _f64(tmp, **kw):
    return port_params(_kol_params(tmp, backend="jax", precision="f64",
                                   **kw))


@pytest.mark.parametrize("mesh", [(1, 1), MESH], ids=["one", "2x2"])
def test_resume_continues_the_statistics(tmp_path, mesh):
    # the plain tier (one step at a time on every shape): the resumed run
    # writes the straight run's bytes
    Runner(_f64(tmp_path / "full", mesh_shape=mesh), device="cpu",
           verbose=False).run()
    half = _f64(tmp_path / "resumed", mesh_shape=mesh, num_timesteps=50,
                checkpoint_every=1)
    Runner(half, device="cpu", verbose=False).run()
    result = Runner(half.replace(num_timesteps=97), device="cpu",
                    verbose=False).run(resume=True)
    assert result.success and result.final_step == 97
    _close_stats(tmp_path / "resumed", tmp_path / "full", exact=True)
    assert (tmp_path / "resumed" / "probes.csv").read_bytes() == \
        (tmp_path / "full" / "probes.csv").read_bytes()


def _run(cls, params, mesh, **kw):
    if cls is Runner:
        return Runner(port_params(params), device="cpu",
                      verbose=False).run(**kw)
    n = mesh[0] * mesh[1]
    return JaxRunner(params, devices=jax.devices()[:n],
                     verbose=False).run(**kw)


@pytest.mark.parametrize("mesh", [(1, 1), MESH], ids=["npz", "per-shard"])
@pytest.mark.parametrize("direction", ["port_to_tpulbm", "tpulbm_to_port"])
def test_statistics_checkpoint_resumes_in_the_other_package(tmp_path,
                                                            direction, mesh):
    writer, reader = ((Runner, JaxRunner) if direction == "port_to_tpulbm"
                      else (JaxRunner, Runner))
    # tpulbm's probes slice a sharded array, which its jax refuses on a
    # mesh: the per-shard runs take none
    kw = dict(backend="jax", precision="f64", mesh_shape=mesh,
              probe_points=PROBES_2D if mesh == (1, 1) else ())
    _run(reader, _kol_params(tmp_path / "straight", **kw), mesh)
    half = _kol_params(tmp_path / "moved", num_timesteps=50,
                       checkpoint_every=1, **kw)
    _run(writer, half, mesh)
    latest = ckpt.latest(str(tmp_path / "moved" / "checkpoints"))
    assert latest.endswith("ckpt_000000050" + (".npz" if mesh == (1, 1)
                                               else ""))
    result = _run(reader, half.replace(num_timesteps=97), mesh, resume=True)
    assert result.success and result.final_step == 97
    _close_stats(tmp_path / "moved", tmp_path / "straight", rtol=1e-9,
                 atol=1e-12)
    if mesh == (1, 1):
        _close_csv(tmp_path / "moved" / "probes.csv",
                   tmp_path / "straight" / "probes.csv", rtol=1e-7,
                   atol=1e-8)


@pytest.mark.parametrize("mesh", [(1, 1), MESH], ids=["npz", "per-shard"])
def test_statistics_checkpoint_holds_tpulbms_keys(tmp_path, mesh):
    kw = dict(backend="jax", precision="f64", mesh_shape=mesh,
              num_timesteps=50, checkpoint_every=1, probe_points=())
    paths = {}
    for cls, name in ((Runner, "port"), (JaxRunner, "ref")):
        _run(cls, _kol_params(tmp_path / name, **kw), mesh)
        paths[name] = ckpt.latest(str(tmp_path / name / "checkpoints"))
    if mesh == (1, 1):
        with np.load(paths["port"]) as a, np.load(paths["ref"]) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                if k.startswith("stats_"):
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_allclose(a[k], b[k], rtol=1e-9,
                                               atol=1e-12, err_msg=k)
        return
    manifests = [json.load(open(f"{paths[n]}/manifest.json"))
                 for n in ("port", "ref")]
    for key in ("stats", "stats_scalars", "files", "global_shape"):
        assert manifests[0][key] == manifests[1][key], key
    with np.load(f"{paths['port']}/proc_00000.npz") as a, \
            np.load(f"{paths['ref']}/proc_00000.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    _, _, stats = ckpt.load_sharded(paths["ref"], mesh, extras=True)
    # 50 steps every 10 from stats_from 25: samples at 30 and 40
    assert stats["count"] == manifests[1]["stats_scalars"]["count"] == 2.0
    assert stats["first"] == 30.0
    assert stats["s_uu"][1][0].shape == (3, 8, 16)


def test_cli_probes_and_statistics(tmp_path):
    from tpulbm_torch.__main__ import main
    assert main(["--cpu", "--preset", "kolmogorov", "--nx", "32", "--ny",
                 "16", "--num-timesteps", "60", "--output-frequency", "10",
                 "--stats-from", "20", "--probe", "0.5,0.5;0.25,0.75",
                 "--output-dir", str(tmp_path)]) == 0
    header, table = _table(tmp_path / "probes.csv")
    assert header == ("timestep,p0_rho,p0_ux,p0_uy,p1_rho,p1_ux,p1_uy")
    assert list(table[:, 0]) == [0, 10, 20, 30, 40, 50]
    with np.load(tmp_path / "stats_fields.npz") as st:
        assert int(st["n_samples"]) == 4 and int(st["first_step"]) == 20
