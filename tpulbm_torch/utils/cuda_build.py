"""Build and load the port's CUDA kernels at first use.

Each kernel source under tpulbm_torch/csrc/ is compiled by nvcc into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded with ctypes; a source may be built several times
with different defines (the D2Q9 kernels, once per collision mode).
Libraries land in build_dir(), named by the source, its defines and a hash
of the source, the shared headers (csrc/*.cuh) and the flags, so an edited
source or header rebuilds and an unchanged one is reused. In a
source checkout that is build/tpulbm_torch/ at its root (clear it with
`rm -rf build/tpulbm_torch`).

Nothing is built when a module is imported; a missing nvcc or a failed
build raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE_DIR = _PKG / "csrc"

# -fmad=false keeps each multiply and add rounded on its own, as in the
# plain PyTorch version the kernels are compared with.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an existing build was reused
    log: str               # nvcc's output, including ptxas's register report


def build_dir() -> Path:
    """Where built libraries go: TPULBM_TORCH_BUILD_DIR if it is set; else
    build/tpulbm_torch/ at the root of a source checkout (the package's
    parent holds pyproject.toml; git ignores build/); else, for an installed
    package, the user cache ($XDG_CACHE_HOME/tpulbm_torch or
    ~/.cache/tpulbm_torch), never beside the package."""
    env = os.environ.get("TPULBM_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    if (_PKG.parent / "pyproject.toml").is_file():
        return _PKG.parent / "build" / "tpulbm_torch"
    cache = (os.environ.get("XDG_CACHE_HOME")
             or os.path.join(os.path.expanduser("~"), ".cache"))
    return Path(cache) / "tpulbm_torch"


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built at first use")
    return nvcc


@functools.cache
def load(source: str, defines: tuple[str, ...] = ()) -> Library:
    """Build (if needed) and load csrc/<source> as a shared library, with
    nvcc's `defines` (e.g. ("-DTPULBM_COLLISION=4",))."""
    src = SOURCE_DIR / source
    flags = NVCC_FLAGS + tuple(defines)
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    tag = "".join("_" + d.rsplit("=", 1)[-1] for d in defines)
    out = build_dir() / f"{src.stem}{tag}_{digest}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        seconds = compile_library(src, out, defines)
    log = log_path.read_text() if log_path.exists() else ""
    return Library(ctypes.CDLL(str(out)), out, seconds, log)


def compile_library(src: Path, out: Path,
                    defines: tuple[str, ...] = ()) -> float:
    """nvcc src (its #includes found beside it or in csrc/) with `defines`
    into the shared library `out`, with nvcc's output in
    out.with_suffix(".log"); returns the seconds it took. Raises if nvcc is
    missing or fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *defines, "-I", str(SOURCE_DIR), "-o",
           str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} (exit "
                           f"{proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic publish: concurrent builders race safely
    return seconds
