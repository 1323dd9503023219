"""The Runner on a mesh of shards: tpulbm's per-shard checkpoints both ways
and the artifacts, mirroring tests/test_torch_resume.py.

* a per-shard checkpoint written by tpulbm's Runner on a (2, 2) virtual
  mesh resumes in the port's Runner on (2, 2) `cpu` shards, and the
  reverse; each continued run is held to a straight run of the reading
  package at tests/test_torch_runner.py's artifact tolerance (forces
  rtol 1e-4 / atol 5e-6, fields rtol 1e-5 / atol 5e-6);
* a port mesh run resumed from its own per-shard checkpoint reproduces a
  straight mesh run byte for byte;
* a port mesh run writes the same files as its one-device run, forces.csv
  and velocity_field.csv within the artifact tolerance rtol 1e-4 /
  atol 5e-6 (the shards sum the force in another order);
* the per-shard format: tpulbm's manifest and shard keys.

Both packages run the plain tier in f64 here (tpulbm's Pallas tier in
interpret mode would take minutes); the port's kernel module on a mesh
runs in the one-device comparison.
"""
import json

import jax
import numpy as np
import pytest

from tpulbm.runner import Runner as JaxRunner
from tpulbm.utils import checkpoint as jckpt
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import checkpoint as ckpt
from test_torch_resume import _close, _read, _rows, tiny_params

MESH = (2, 2)


def _run(cls, params, **kw):
    if cls is Runner:
        return Runner(params, device="cpu", verbose=False).run(**kw)
    return JaxRunner(params, devices=jax.devices()[:4],
                     verbose=False).run(**kw)


@pytest.mark.parametrize("direction", ["port_to_tpulbm", "tpulbm_to_port"])
def test_per_shard_checkpoint_resumes_in_the_other_package(tmp_path,
                                                           direction):
    writer, reader = ((Runner, JaxRunner) if direction == "port_to_tpulbm"
                      else (JaxRunner, Runner))
    kw = dict(backend="jax", precision="f64", mesh_shape=MESH)
    _run(reader, tiny_params(tmp_path / "straight", num_timesteps=80, **kw))
    p_half = tiny_params(tmp_path / "moved", num_timesteps=40,
                         checkpoint_every=1, **kw)
    _run(writer, p_half)
    latest = ckpt.latest(str(tmp_path / "moved" / "checkpoints"))
    assert latest.endswith("ckpt_000000040")
    result = _run(reader, p_half.replace(num_timesteps=80), resume=True)
    assert result.success and result.final_step == 80
    assert [r[0] for r in _rows(tmp_path / "moved" / "forces.csv")] == \
        ["0", "20", "40", "60"]
    _close(tmp_path / "moved", tmp_path / "straight")


def test_mesh_resume_reproduces_a_straight_mesh_run(tmp_path):
    # the plain tier: one step of every shard's padded block at a time.
    # The kernel module's CPU path steps blocks of another shape at each
    # depth, and PyTorch's sum over the planes rounds by the shape, so a
    # run chunked otherwise differs there in the last bits (the kernels on
    # the card are bitwise equal at every depth: chip_smoke.py)
    kw = dict(mesh_shape=MESH, backend="jax", precision="f64")
    Runner(tiny_params(tmp_path / "full", num_timesteps=80, **kw),
           device="cpu", verbose=False).run()
    p_half = tiny_params(tmp_path / "resumed", num_timesteps=40,
                         checkpoint_every=1, **kw)
    Runner(p_half, device="cpu", verbose=False).run()
    result = Runner(p_half.replace(num_timesteps=80), device="cpu",
                    verbose=False).run(resume=True)
    assert result.final_step == 80
    for name in ("forces.csv", "velocity_field.csv"):
        assert _read(tmp_path / "resumed" / name) == \
            _read(tmp_path / "full" / name), name


@pytest.mark.parametrize("backend", ["pallas", "jax"])
def test_mesh_run_writes_the_one_device_files(tmp_path, backend):
    kw = dict(num_timesteps=200, backend=backend,
              precision="f32" if backend == "pallas" else "f64")
    one = Runner(tiny_params(tmp_path / "one", **kw), device="cpu",
                 verbose=False).run()
    mesh = Runner(tiny_params(tmp_path / "mesh", mesh_shape=MESH, **kw),
                  device="cpu", verbose=False).run()
    assert one.success and mesh.success
    for name in ("forces.csv", "velocity_field.csv"):
        got, ref = _rows(tmp_path / "mesh" / name), \
            _rows(tmp_path / "one" / name)
        assert [r[0] for r in got] == [r[0] for r in ref], name
        cols = slice(1, 3) if name == "forces.csv" else slice(1, None)
        np.testing.assert_allclose(
            np.array([[float(v) for v in r[cols]] for r in got]),
            np.array([[float(v) for v in r[cols]] for r in ref]),
            rtol=1e-4, atol=5e-6, err_msg=name)
    # the same parameters; the maximum velocity of the reported fields
    # within the field tolerance
    got, ref = (_rows(tmp_path / d / "simulation_params.csv")
                for d in ("mesh", "one"))
    assert [r[0] for r in got] == [r[0] for r in ref]
    for g, r in zip(got, ref):
        if g[0] == "max_velocity":
            assert abs(float(g[1]) - float(r[1])) <= 1e-5 * abs(float(r[1]))
        else:
            assert g == r


def test_per_shard_format_is_tpulbms(tmp_path):
    params = tiny_params(tmp_path, mesh_shape=MESH, checkpoint_every=1,
                         num_timesteps=20)
    Runner(params, device="cpu", verbose=False).run()
    path = ckpt.latest(str(tmp_path / "checkpoints"))
    manifest = json.load(open(f"{path}/manifest.json"))
    assert manifest["files"] == {f"shard_0_{y}_{x}": "proc_00000.npz"
                                 for y in (0, 16) for x in (0, 32)}
    assert (manifest["global_shape"], manifest["dtype"], manifest["step"]) \
        == ([9, 32, 64], "float32", 20)
    assert jckpt.check_manifest(path, params) == 20
    step, blocks = ckpt.load_sharded(path, MESH, params)
    assert step == 20 and blocks[1][0].shape == (9, 16, 32)
    with pytest.raises(ValueError, match="incompatible mesh"):
        ckpt.load_sharded(path, (1, 4), params)
    with pytest.raises(ValueError, match="tau"):
        ckpt.load_sharded(path, MESH, params.replace(tau=0.7))
