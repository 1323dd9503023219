"""ctypes loader (and builder at first use) for the native ASCII writer.

csrc/fastio.cpp (the port's copy of tpulbm's native/fastio.cpp) formats
VTK frames, velocity_field.csv and temperature_field.csv. It is built
with g++ into cuda_build.build_dir(), next to the kernels, named by a
hash of the source. Without g++, without the source or a writable build
directory, or with TPULBM_NO_NATIVE=1, the writers in utils/io.py take
their NumPy path, which writes the same bytes.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from .cuda_build import SOURCE_DIR, build_dir

_SOURCE = SOURCE_DIR / "fastio.cpp"
_GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


class NativeIO:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.fastio_write_vtk.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, dptr, dptr, dptr, ctypes.c_int64]
        lib.fastio_write_vtk.restype = ctypes.c_int
        lib.fastio_write_vtk3.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, dptr, dptr, dptr, dptr,
            ctypes.c_int64]
        lib.fastio_write_vtk3.restype = ctypes.c_int
        lib.fastio_write_velocity_field.argtypes = [
            ctypes.c_char_p, dptr, dptr, dptr, ctypes.c_int64, ctypes.c_int64]
        lib.fastio_write_velocity_field.restype = ctypes.c_int
        lib.fastio_write_temperature_field.argtypes = [
            ctypes.c_char_p, dptr, ctypes.c_int64, ctypes.c_int64]
        lib.fastio_write_temperature_field.restype = ctypes.c_int

    def write_vtk(self, path: str, header: str, ux, uy, rho) -> None:
        rc = self._lib.fastio_write_vtk(
            path.encode(), header.encode(), ux, uy, rho, ux.size)
        if rc != 0:
            raise OSError(f"native VTK write failed: {path}")

    def write_vtk3(self, path: str, header: str, ux, uy, uz, rho) -> None:
        rc = self._lib.fastio_write_vtk3(
            path.encode(), header.encode(), ux, uy, uz, rho, ux.size)
        if rc != 0:
            raise OSError(f"native VTK write failed: {path}")

    def write_velocity_field(self, path: str, ux, uy, rho) -> None:
        ny, nx = ux.shape
        rc = self._lib.fastio_write_velocity_field(
            path.encode(), ux, uy, rho, ny, nx)
        if rc != 0:
            raise OSError(f"native CSV write failed: {path}")

    def write_temperature_field(self, path: str, temp) -> None:
        ny, nx = temp.shape
        rc = self._lib.fastio_write_temperature_field(path.encode(), temp,
                                                      ny, nx)
        if rc != 0:
            raise OSError(f"native CSV write failed: {path}")


@functools.cache
def _load() -> NativeIO | None:
    try:
        source = _SOURCE.read_bytes()
    except OSError:
        return None
    digest = hashlib.sha256(source
                            + " ".join(_GXX_FLAGS).encode()).hexdigest()[:16]
    so = build_dir() / f"fastio_{digest}.so"
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            so.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run(["g++", *_GXX_FLAGS, str(_SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            # atomic publish: concurrent builders race safely
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
    try:
        return NativeIO(ctypes.CDLL(str(so)))
    except OSError:
        return None


def get_native_io() -> NativeIO | None:
    """The native writer, built at first use; None without g++, without
    its source, or with TPULBM_NO_NATIVE set (the callers then write the
    same bytes in NumPy)."""
    if os.environ.get("TPULBM_NO_NATIVE"):
        return None
    return _load()
