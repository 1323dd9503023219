"""The port's own copies of tpulbm's host modules against the originals:
config (every preset, the CLI), lattice, geometry, the artifact writers
(native and NumPy paths) and the checkpoint format.

`port_params` (and `port_problem` on it) is the one place where a tpulbm
SimulationParams becomes the port's: the port tests build their parameters with tpulbm's class and hand
them over through it (the two classes are equal field for field, which
the tests below hold, but not the same type).
"""
import argparse
import os

import numpy as np
import pytest
import torch

import tpulbm.config as jcfg
from tpulbm import geometry as jgeom
from tpulbm import lattice as jlat
from tpulbm.utils import checkpoint as jckpt
from tpulbm.utils import io as jio
from tpulbm_torch import config as cfg
from tpulbm_torch import geometry, lattice
from tpulbm_torch.models import make_problem
from tpulbm_torch.utils import checkpoint as ckpt
from tpulbm_torch.utils import io as io_mod

# One PyTorch thread in each test process. The tier-1 run spreads the test
# files over six pytest-xdist workers on the host's cores, and every worker
# collects (imports) every test module, this one among them; at PyTorch's
# default each worker would start an intra-op pool as wide as the host, and
# six such pools spinning over eight cores starve one another (measured on
# an 8-core host: eight of the port's CPU-heavy test files took 286 s at
# the default and 104 s at one thread a worker, the same tests passing).
torch.set_num_threads(1)


def port_params(params) -> cfg.SimulationParams:
    """The port's SimulationParams equal to a tpulbm SimulationParams."""
    return cfg.SimulationParams.from_json(params.to_json())


def port_problem(params):
    """The port's Problem for a tpulbm (or port) SimulationParams."""
    return make_problem(port_params(params))


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_equal_tpulbm(name):
    assert cfg.PRESETS[name].to_json() == jcfg.PRESETS[name].to_json()
    assert port_params(jcfg.PRESETS[name]) == cfg.PRESETS[name]


def _parse(module, argv):
    parser = argparse.ArgumentParser()
    module.add_cli_args(parser)
    return module.params_from_args(parser.parse_args(argv))


@pytest.mark.parametrize("argv", [
    [], ["--preset", "re200", "--nx", "256", "--no-vtk"],
    ["--preset", "cylinder3d-small", "--nz", "32", "--mesh", "2x1"],
    ["--problem", "cylinder3d", "--nx", "64", "--ny", "32", "--nz", "16",
     "--lattice3d", "d3q27", "--inlet-velocity", "0.05"],
    ["--preset", "rayleigh-benard", "--rayleigh", "5000", "--t-hot", "2",
     "--thermal-tau", "0.6", "--checkpoint-every", "3"],
    ["--preset", "heated-cavity", "--nx", "24", "--ny", "24",
     "--buoyancy", "1e-4", "--vtk-format", "binary", "--precision", "f64"],
    ["--reynolds", "120", "--collision", "mrt", "--mrt-rates", "e=1.5",
     "--probe", "0.3,0.5;0.8,0.5", "--output-dir", "out"]],
    ids=["defaults", "re200", "3d-mesh", "d3q27", "rayleigh-benard",
         "heated-cavity", "mrt-probes"])
def test_params_from_args_equal_tpulbm(argv):
    assert _parse(cfg, argv).to_json() == _parse(jcfg, argv).to_json()


@pytest.mark.parametrize("name", ["D2Q9", "D2Q5", "D3Q19"])
def test_lattices_equal_tpulbm(name):
    mine, ref = getattr(lattice, name), getattr(jlat, name)
    assert mine.Q == ref.Q and mine.D == ref.D
    for attr in ("c", "w", "opposite"):
        got, want = getattr(mine, attr), getattr(ref, attr)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("preset,mask", [
    ("re200", "cylinder_mask"), ("cylinder-small", "cylinder_mask"),
    ("cylinder3d-small", "sphere_mask")])
def test_masks_equal_tpulbm(preset, mask):
    params = cfg.PRESETS[preset]
    got = getattr(geometry, mask)(params)
    want = getattr(jgeom, mask)(jcfg.PRESETS[preset])
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    assert geometry.solid_cell_count(got) == jgeom.solid_cell_count(want)


def _fields(ny=7, nx=11, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.05, (ny, nx)), rng.normal(0, 0.05, (ny, nx)),
            1.0 + rng.normal(0, 0.01, (ny, nx)), rng.uniform(0, 1, (ny, nx)))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_vtk_frames_equal_tpulbm(tmp_path, monkeypatch, native, fmt):
    if not native:
        monkeypatch.setenv("TPULBM_NO_NATIVE", "1")
    ux, uy, rho, temp = _fields()
    p = cfg.SimulationParams(nx=11, ny=7)
    a = io_mod.write_vtk_timestep(ux, uy, rho, p, 40, str(tmp_path / "a"),
                                  fmt=fmt, temp=temp)
    b = jio.write_vtk_timestep(ux, uy, rho, jcfg.SimulationParams(nx=11, ny=7),
                               40, str(tmp_path / "b"), fmt=fmt, temp=temp)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_field_csvs_equal_tpulbm(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setenv("TPULBM_NO_NATIVE", "1")
    ux, uy, rho, temp = _fields()
    p, jp = cfg.SimulationParams(nx=11, ny=7), jcfg.SimulationParams(nx=11,
                                                                     ny=7)
    for d in ("a", "b"):
        os.makedirs(tmp_path / d)
    io_mod.write_velocity_field(ux, uy, rho, p, str(tmp_path / "a"))
    jio.write_velocity_field(ux, uy, rho, jp, str(tmp_path / "b"))
    io_mod.write_temperature_field(temp, p, str(tmp_path / "a"))
    jio.write_temperature_field(temp, jp, str(tmp_path / "b"))
    io_mod.write_simulation_params(ux, uy, p, str(tmp_path / "a"))
    jio.write_simulation_params(ux, uy, jp, str(tmp_path / "b"))
    for name in ("velocity_field.csv", "temperature_field.csv",
                 "simulation_params.csv"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name


def test_series_writers_equal_tpulbm(tmp_path):
    # the resume contract: rows at or after the resume step are dropped
    for mod, d in ((io_mod, "a"), (jio, "b")):
        os.makedirs(tmp_path / d)
        with open(tmp_path / d / "nusselt.csv", "w") as fh:
            fh.write("timestep,nusselt\n0,1.0\n100,1.5\n200,1.7\n")
        w = mod.NusseltWriter(str(tmp_path / d / "nusselt.csv"), append=True,
                              resume_step=200)
        w.record(200, 1.25)
        w.close()
        w = mod.ForceWriter(str(tmp_path / d / "forces.csv"))
        w.record(0, 0.5, -0.25, 1.0, -0.5)
        w.close()
    for name in ("nusselt.csv", "forces.csv"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name


@pytest.mark.parametrize("writer", ["port", "tpulbm"])
def test_checkpoints_move_between_packages(tmp_path, writer):
    params = cfg.PRESETS["rayleigh-benard"].replace(nx=16, ny=8)
    f = np.random.default_rng(5).uniform(0, 0.5, (14, 8, 16)).astype(
        np.float32)
    save, load = ((ckpt.save, jckpt.load) if writer == "port"
                  else (jckpt.save, ckpt.load))
    path = save(str(tmp_path), 300, f, params)
    assert os.path.basename(path) == "ckpt_000000300.npz"
    assert ckpt.latest(str(tmp_path)) == jckpt.latest(str(tmp_path)) == path
    step, back = load(path, params)
    assert step == 300 and back.tobytes() == f.tobytes()
    with pytest.raises(ValueError, match="rayleigh"):
        load(path, params.replace(rayleigh=2e4))
