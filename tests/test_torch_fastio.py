"""The native ASCII writer (csrc/fastio.cpp) against the NumPy path of
tpulbm_torch/utils/io.py, byte for byte, on values that test its exact
"%.8f" formatter: ties at the eighth decimal (rounded half to even),
negatives that round to zero ("-0.00000000"), subnormals, values near and
beyond its integer path's 1e10, and NaN and infinities."""
import os

import numpy as np
import pytest

from tpulbm_torch import config as cfg
from tpulbm_torch.utils import io as io_mod
from tpulbm_torch.utils import native

pytestmark = pytest.mark.skipif(native.get_native_io() is None,
                                reason="the native writer needs g++")


def edge_values(kind: str, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "ties":
        # k * 2^-j: exact binary values, many of them ties at 1e-8
        k = rng.integers(-10**6, 10**6, n)
        return np.ldexp(k.astype(np.float64), rng.integers(1, 40, n))
    if kind == "half_units":
        # multiples of 0.5e-8 and their neighbours one ulp away
        v = rng.integers(-10**7, 10**7, n // 3) * 0.5e-8
        return np.concatenate([v, np.nextafter(v, 1.0), np.nextafter(v, -1.0)])
    if kind == "float32":
        # the fields as the kernels leave them: float32 widened
        return np.concatenate([
            rng.normal(0, 0.05, n // 2).astype(np.float32),
            (1 + rng.normal(0, 0.01, n // 2)).astype(np.float32),
        ]).astype(np.float64)
    if kind == "scales":
        return (rng.uniform(-1, 1, n)
                * 10.0 ** rng.integers(-12, 13, n).astype(np.float64))
    if kind == "special":
        return np.array([0.0, -0.0, 5e-324, -5e-324, 1e-320, -4.9e-9, 5e-9,
                         -5e-9, 1.5e-8, 2.5e-8, 0.999999995, 9.99999999e9,
                         1e10, -1e10, 1e150, -1e150, np.inf,
                         -np.inf, np.nan, -np.nan, 123456789.123456789])
    raise ValueError(kind)


KINDS = ["ties", "half_units", "float32", "scales", "special"]


def shaped(v: np.ndarray, nx: int = 7) -> np.ndarray:
    v = np.resize(v, (len(v) + nx - 1) // nx * nx)
    return v.reshape(-1, nx)


def write_both(tmp_path, monkeypatch, write):
    """write(out_dir) through the native writer, then through the NumPy
    path; the two directories."""
    a, b = tmp_path / "native", tmp_path / "numpy"
    os.makedirs(a)
    os.makedirs(b)
    write(str(a))
    monkeypatch.setenv("TPULBM_NO_NATIVE", "1")
    write(str(b))
    return a, b


@pytest.mark.parametrize("kind", KINDS)
def test_velocity_field_native_equals_numpy(tmp_path, monkeypatch, kind):
    v = shaped(edge_values(kind))
    ux, uy, rho = v, v[::-1].copy(), np.roll(v, 1)
    p = cfg.SimulationParams(nx=v.shape[1], ny=v.shape[0])
    a, b = write_both(tmp_path, monkeypatch,
                      lambda d: io_mod.write_velocity_field(ux, uy, rho, p, d))
    name = "velocity_field.csv"
    assert (a / name).read_bytes() == (b / name).read_bytes()


@pytest.mark.parametrize("kind", KINDS)
def test_temperature_field_native_equals_numpy(tmp_path, monkeypatch, kind):
    t = shaped(edge_values(kind))
    p = cfg.SimulationParams(nx=t.shape[1], ny=t.shape[0])
    a, b = write_both(tmp_path, monkeypatch,
                      lambda d: io_mod.write_temperature_field(t, p, d))
    name = "temperature_field.csv"
    assert (a / name).read_bytes() == (b / name).read_bytes()


@pytest.mark.parametrize("kind", KINDS)
def test_vtk_frame_native_equals_numpy(tmp_path, monkeypatch, kind):
    v = shaped(edge_values(kind))
    p = cfg.SimulationParams(nx=v.shape[1], ny=v.shape[0])
    a, b = write_both(tmp_path, monkeypatch,
                      lambda d: io_mod.write_vtk_timestep(
                          v, v[::-1].copy(), np.roll(v, 1), p, 40, d,
                          fmt="ascii"))
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(b) for p in b.rglob("*")
                                     if p.is_file())
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
