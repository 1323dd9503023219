"""The port's Runner: the super-chunk fast path and checkpoint/resume,
mirroring tests/test_runner_io.py for tpulbm's Runner.

* the super path (8 output intervals per host fetch) against the
  per-interval path (_SUPER_K patched): byte-identical forces.csv,
  velocity_field.csv and VTK frames;
* a resumed run reproduces a straight run byte for byte, across the
  per-interval path and across super-chunks; mismatched physics is
  refused;
* checkpoints move between the packages: one written by the port resumes
  in tpulbm's Runner and one written by tpulbm in the port's. The two
  frameworks round differently, so those runs are held to a straight run
  of the other package at tests/test_torch_runner.py's artifact tolerance
  (fields rtol 1e-5 / atol 5e-6, forces rtol 1e-4 / atol 5e-6).

The kernel backend runs f32 (its CPU path is the plain step, at the depth
the chunk stepper chooses); the plain backend runs f64, as
tests/test_runner_io.py does.
"""
import os

import numpy as np
import pytest

import tpulbm_torch.runner as runner_mod
from tpulbm.runner import Runner as JaxRunner
from tpulbm_torch.config import SimulationParams
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import checkpoint as ckpt

BACKENDS = {"pallas": "f32", "jax": "f64"}


def tiny_params(tmp, **kw):
    defaults = dict(nx=64, ny=32, tau=0.6, inlet_velocity=0.05,
                    num_timesteps=60, output_frequency=20,
                    output_dir=str(tmp), backend="pallas", precision="f32",
                    enable_vtk=False)
    defaults.update(kw)
    return SimulationParams(**defaults)


def _read(path) -> bytes:
    return open(path, "rb").read()


def _rows(path):
    return [r.split(",") for r in open(path).read().splitlines()[1:]]


@pytest.mark.parametrize("backend", BACKENDS)
def test_super_chunk_path_matches_interval_path(tmp_path, monkeypatch,
                                                backend):
    base = dict(num_timesteps=400, output_frequency=20, enable_vtk=True,
                backend=backend, precision=BACKENDS[backend])
    Runner(tiny_params(tmp_path / "super", **base), device="cpu",
           verbose=False).run()
    monkeypatch.setattr(runner_mod, "_SUPER_K", 10 ** 9)
    Runner(tiny_params(tmp_path / "plain", **base), device="cpu",
           verbose=False).run()
    for name in ("forces.csv", "velocity_field.csv"):
        assert _read(tmp_path / "super" / name) == \
            _read(tmp_path / "plain" / name), name
    frames_a = sorted(os.listdir(tmp_path / "super" / "vtk_output"))
    frames_b = sorted(os.listdir(tmp_path / "plain" / "vtk_output"))
    assert frames_a == frames_b and len(frames_a) == 19  # t=20..380
    for name in frames_a:
        assert _read(tmp_path / "super" / "vtk_output" / name) == \
            _read(tmp_path / "plain" / "vtk_output" / name), name


@pytest.mark.parametrize("backend", BACKENDS)
def test_checkpoint_resume_reproduces_run(tmp_path, backend):
    kw = dict(backend=backend, precision=BACKENDS[backend])
    Runner(tiny_params(tmp_path / "full", num_timesteps=80, **kw),
           device="cpu", verbose=False).run()

    p_half = tiny_params(tmp_path / "resumed", num_timesteps=40,
                         checkpoint_every=1, **kw)
    Runner(p_half, device="cpu", verbose=False).run()
    assert ckpt.latest(str(tmp_path / "resumed" / "checkpoints")) is not None
    result = Runner(p_half.replace(num_timesteps=80), device="cpu",
                    verbose=False).run(resume=True)
    assert result.final_step == 80
    for name in ("forces.csv", "velocity_field.csv"):
        assert _read(tmp_path / "resumed" / name) == \
            _read(tmp_path / "full" / name), name
    # forces.csv continues without duplicating rows
    assert [r[0] for r in _rows(tmp_path / "resumed" / "forces.csv")] == \
        ["0", "20", "40", "60"]


def test_resume_across_super_chunks(tmp_path):
    # chip_smoke.py's phase 4b at 1/10 of its steps: a checkpoint at the
    # end of the 8th chunk (t = 111), resumed into two super-chunks
    base = dict(num_timesteps=280, output_frequency=14)
    Runner(tiny_params(tmp_path / "full", **base), device="cpu",
           verbose=False).run()
    first = tiny_params(tmp_path / "resumed", **dict(
        base, num_timesteps=112, checkpoint_every=8))
    Runner(first, device="cpu", verbose=False).run()
    assert os.listdir(tmp_path / "resumed" / "checkpoints") == \
        ["ckpt_000000111.npz"]
    result = Runner(first.replace(num_timesteps=280), device="cpu",
                    verbose=False).run(resume=True)
    assert result.final_step == 280
    for name in ("forces.csv", "velocity_field.csv"):
        assert _read(tmp_path / "resumed" / name) == \
            _read(tmp_path / "full" / name), name


def test_checkpoint_rejects_mismatched_params(tmp_path):
    p = tiny_params(tmp_path, checkpoint_every=1)
    Runner(p, device="cpu", verbose=False).run()
    latest = ckpt.latest(str(tmp_path / "checkpoints"))
    with pytest.raises(ValueError):
        ckpt.load(latest, p.replace(tau=0.7))
    for change in (dict(inlet_velocity=0.01), dict(collision="trt"),
                   dict(obstacle_bc="bounce_back"), dict(precision="f64"),
                   dict(body_force=(1e-5, 0.0))):
        with pytest.raises(ValueError):
            ckpt.load(latest, p.replace(**change))
    step, _ = ckpt.load(latest, p.replace(num_timesteps=999,
                                          output_dir="/x", enable_vtk=True))
    assert step == 60
    # the Runner refuses to continue another simulation
    with pytest.raises(RuntimeError, match="checkpoint load failed"):
        Runner(p.replace(tau=0.7, num_timesteps=80), device="cpu",
               verbose=False).run(resume=True)


def test_per_shard_checkpoint_directory_is_refused(tmp_path):
    # a (2, 2) mesh's per-shard checkpoint does not line up with a (1, 1)
    # run's one block: refused, as tpulbm's load_sharded refuses it
    p = tiny_params(tmp_path, checkpoint_every=1)
    blocks = [[np.zeros((9, 16, 32), np.float32)] * 2] * 2
    ckpt.save_sharded(str(tmp_path / "checkpoints"), 40, blocks, p)
    with pytest.raises(RuntimeError, match="incompatible mesh"):
        Runner(p, device="cpu", verbose=False).run(resume=True)


def _close(got_dir, ref_dir):
    # the raw forces (columns 1-2), as tests/test_torch_runner.py compares
    # them: the coefficients divide by q ~ 2.5e-6 on this tiny cylinder
    for name, cols, tol in (
            ("forces.csv", slice(1, 3), dict(rtol=1e-4, atol=5e-6)),
            ("velocity_field.csv", slice(1, None),
             dict(rtol=1e-5, atol=5e-6))):
        got, ref = _rows(got_dir / name), _rows(ref_dir / name)
        assert [r[0] for r in got] == [r[0] for r in ref], name
        np.testing.assert_allclose(
            np.array([[float(v) for v in r[cols]] for r in got]),
            np.array([[float(v) for v in r[cols]] for r in ref]),
            err_msg=name, **tol)


@pytest.mark.parametrize("direction", ["port_to_tpulbm", "tpulbm_to_port"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, direction):
    writer, reader = ((Runner, JaxRunner) if direction == "port_to_tpulbm"
                      else (JaxRunner, Runner))

    def run(cls, params, **kw):
        if cls is Runner:
            return Runner(params, device="cpu", verbose=False).run(**kw)
        return JaxRunner(params.replace(backend="jax"),
                         verbose=False).run(**kw)

    run(reader, tiny_params(tmp_path / "straight", num_timesteps=80))
    p_half = tiny_params(tmp_path / "moved", num_timesteps=40,
                         checkpoint_every=1)
    run(writer, p_half)
    result = run(reader, p_half.replace(num_timesteps=80), resume=True)
    assert result.success and result.final_step == 80
    assert [r[0] for r in _rows(tmp_path / "moved" / "forces.csv")] == \
        ["0", "20", "40", "60"]
    _close(tmp_path / "moved", tmp_path / "straight")
