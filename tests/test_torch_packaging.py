"""The port as an installed package, on the CPU: a wheel built offline
carries every kernel source under tpulbm_torch/csrc/, an installed CLI run
writes its artifacts and builds nothing beside the package, and the build
directory is chosen in one place (utils/cuda_build.build_dir).

The wheel is built from a copy of the packaging files and both packages in
a temporary directory, never in the checkout (setuptools writes build/ and
*.egg-info/ beside its sources).
"""
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from tpulbm_torch.utils import cuda_build, native

REPO = Path(__file__).resolve().parents[1]
PIP = [sys.executable, "-m", "pip", "--disable-pip-version-check",
       "--no-input"]
SOURCES = ("*.cu", "*.cuh", "*.cpp")


def _csrc_files() -> list[str]:
    return sorted(p.name for pattern in SOURCES
                  for p in cuda_build.SOURCE_DIR.glob(pattern))


@pytest.fixture(scope="module")
def wheel(tmp_path_factory) -> Path:
    src = tmp_path_factory.mktemp("src")
    for name in ("pyproject.toml", "MANIFEST.in"):
        shutil.copy(REPO / name, src / name)
    for pkg in ("tpulbm", "tpulbm_torch"):
        shutil.copytree(REPO / pkg, src / pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
    dist = tmp_path_factory.mktemp("dist")
    subprocess.run([*PIP, "wheel", "--no-deps", "--no-build-isolation",
                    "--no-index", "-q", "-w", str(dist), str(src)],
                   cwd=src, check=True, capture_output=True, timeout=300)
    (whl,) = dist.glob("*.whl")
    return whl


def test_wheel_carries_every_kernel_source(wheel):
    names = set(zipfile.ZipFile(wheel).namelist())
    files = _csrc_files()
    assert {"step_d3q19.cu", "step_d3q19_blocked.cu", "d3q19_common.cuh",
            "fastio.cpp"} <= set(files)
    missing = [f for f in files if f"tpulbm_torch/csrc/{f}" not in names]
    assert not missing, missing


def test_installed_cli_builds_outside_the_package(wheel, tmp_path):
    site = tmp_path / "site"
    subprocess.run([*PIP, "install", "--no-deps", "--no-index", "-q",
                    "--target", str(site), str(wheel)],
                   check=True, capture_output=True, timeout=300)
    before = sorted(os.listdir(site))
    run, bld = tmp_path / "run", tmp_path / "bld"
    run.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "TPULBM_NO_NATIVE")}
    env.update(PYTHONPATH=str(site), TPULBM_TORCH_BUILD_DIR=str(bld),
               PYTHONDONTWRITEBYTECODE="1")
    where = subprocess.run(
        [sys.executable, "-c",
         "import tpulbm_torch.utils.cuda_build as b; print(b.__file__); "
         "print(b.build_dir())"],
        cwd=run, env=env, check=True, capture_output=True, text=True,
        timeout=120).stdout.split()
    assert where == [str(site / "tpulbm_torch" / "utils" / "cuda_build.py"),
                     str(bld)]
    proc = subprocess.run(
        [sys.executable, "-m", "tpulbm_torch", "--preset", "cylinder-small",
         "--cpu", "--num-timesteps", "20", "--no-vtk"],
        cwd=run, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in ("forces.csv", "velocity_field.csv",
                 "simulation_params.csv"):
        assert (run / name).is_file(), name
    assert sorted(os.listdir(site)) == before
    assert not list(site.rglob("*.so"))
    if shutil.which("g++"):
        # the native writer was built where the build directory points
        assert list(bld.glob("fastio_*.so"))


def test_build_dir_is_chosen_in_one_place(monkeypatch, tmp_path):
    monkeypatch.delenv("TPULBM_TORCH_BUILD_DIR", raising=False)
    # a source checkout: build/tpulbm_torch/ at its root
    assert cuda_build.build_dir() == REPO / "build" / "tpulbm_torch"
    # an installed package: the user cache, never beside the package
    monkeypatch.setattr(cuda_build, "_PKG", tmp_path / "site" / "tpulbm_torch")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert cuda_build.build_dir() == tmp_path / "cache" / "tpulbm_torch"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert cuda_build.build_dir() == \
        tmp_path / "home" / ".cache" / "tpulbm_torch"
    # the override wins everywhere
    monkeypatch.setenv("TPULBM_TORCH_BUILD_DIR", str(tmp_path / "mine"))
    assert cuda_build.build_dir() == tmp_path / "mine"


def test_native_writer_without_its_source_is_none(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_SOURCE", tmp_path / "fastio.cpp")
    monkeypatch.setenv("TPULBM_TORCH_BUILD_DIR", str(tmp_path / "bld"))
    monkeypatch.delenv("TPULBM_NO_NATIVE", raising=False)
    native._load.cache_clear()
    try:
        assert native.get_native_io() is None
    finally:
        native._load.cache_clear()
    assert not (tmp_path / "bld").exists()


def test_kernel_build_without_its_source_raises(monkeypatch, tmp_path):
    # no fallback: a missing kernel source raises before nvcc is looked for
    monkeypatch.setenv("TPULBM_TORCH_BUILD_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        cuda_build.load("step_missing.cu")
    assert not list(tmp_path.iterdir())
