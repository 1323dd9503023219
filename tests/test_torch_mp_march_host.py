"""The Shan-Chen step's row march (csrc/step_multiphase.cu) built for the
host with g++ against the fake CUDA runtime (tests/test_torch_mesh_thermal
.py: FAKE_RUNTIME, each CUDA thread a fiber, NaN-filled shared memory;
cp.async a copy at its issue), one launch against the plain step
(ops/step_multiphase.py) at the one-step tolerance, rtol 5e-6 / atol
1e-7, from a seeded ±10% perturbed state: the droplet at 100 x 70, the
band at 64 x 32 with a wetting wall (wall rho 1.6), and 7 x 3 (narrower
than a strip: x wraps more than once); under the march's knobs as -D
defines (a widened row of 9 columns, strips of 5, with 1-row batches,
segments of 4 rows and the copies 3 batches ahead; 2-row batches over a
widened row of 12 with segments of 5 rows) each also bitwise the default
build (64 columns, 2-row batches). The ring
builds against one device are tests/test_torch_mesh_multiphase.py's
test_host_ring_build_equals_the_one_device_build, under the same knobs.
"""
import ctypes

import pytest
import torch

from tpulbm_torch.ops import step_multiphase, step_multiphase_cuda
from test_torch_compat import port_problem
from test_torch_mesh import perturbed
from test_torch_mesh_multiphase import params
from test_torch_mesh_thermal import host_cuda  # noqa: F401

KNOBS = {
    "default": (),
    "narrow": ("-DTPULBM_WIDTH=9", "-DTPULBM_ROWS=1", "-DTPULBM_SEGMENT=4",
               "-DTPULBM_AHEAD=3"),
    "rows2": ("-DTPULBM_WIDTH=12", "-DTPULBM_ROWS=2", "-DTPULBM_SEGMENT=5"),
}
# (widened row, rows a batch, threads: a warp's whole multiple of three
# stages' columns and rows)
SHAPES = {"default": (64, 2, 384), "narrow": (9, 1, 32),
          "rows2": (12, 2, 96)}
GRIDS = {"droplet_100x70": ("droplet", 100, 70, {}),
         "band_64x32": ("band", 64, 32, dict(mp_wall_rho=1.6)),
         "droplet_7x3": ("droplet", 7, 3, {})}
CASES = [(g, k) for g in GRIDS for k in KNOBS]
_P, _I = ctypes.c_void_p, ctypes.c_int


def _problem(grid):
    case, nx, ny, kw = GRIDS[grid]
    return port_problem(params(case, precision="f32", nx=nx, ny=ny, **kw))


def _step(build, problem, f, knobs):
    """One launch of the host-built one-device kernel under `knobs`, and
    its library."""
    consts = step_multiphase_cuda.MultiphaseConstants.of(problem)
    lib = step_multiphase_cuda._bind_march(
        build("step_multiphase.cu", KNOBS[knobs]))
    fn = lib.tpulbm_multiphase_step
    fn.argtypes = [_P] * 2 + [_I] * 2 + [_P] * 2 + [_I, _P]
    out = torch.empty_like(f)
    ny, nx = f.shape[1:]
    assert fn(f.data_ptr(), out.data_ptr(), nx, ny, *consts.arrays, 0,
              None) == 0
    return out, lib


@pytest.mark.parametrize("grid,knobs", CASES,
                         ids=[f"{g}-{k}" for g, k in CASES])
def test_mp_march_is_the_plain_step(host_cuda, grid, knobs):
    problem = _problem(grid)
    f = torch.from_numpy(perturbed(problem))
    got, lib = _step(host_cuda, problem, f, knobs)
    assert (lib.tpulbm_multiphase_width(), lib.tpulbm_multiphase_rows(),
            lib.tpulbm_multiphase_threads()) == SHAPES[knobs]
    want = step_multiphase.make_step_multiphase(problem, "cpu")(f)
    torch.testing.assert_close(got, want, rtol=5e-6, atol=1e-7)
    if knobs != "default":
        assert torch.equal(got, _step(host_cuda, problem, f, "default")[0])


def test_mp_segments_fill_the_card(host_cuda):
    # the fake runtime: 2 SMs of one resident block each; the grid as
    # strips * 65536 + segments, segments of at least 4 rows
    lib = step_multiphase_cuda._bind_march(host_cuda("step_multiphase.cu"))
    assert lib.tpulbm_multiphase_grid(100, 70, 0) == 2 * 65536 + 1
    assert lib.tpulbm_multiphase_grid(50, 70, 0) == 65536 + 2
    assert lib.tpulbm_multiphase_grid(7, 3, 0) == 65536 + 1
    # 2-row batches: populations of batches m-5 .. m+2, ψ of m-3 .. m
    assert lib.tpulbm_multiphase_smem_bytes() == 4 * (9 * 16 + 8) * 64
    lib = step_multiphase_cuda._bind_march(
        host_cuda("step_multiphase.cu", KNOBS["narrow"]))
    assert lib.tpulbm_multiphase_grid(100, 70, 0) == 20 * 65536 + 18
    # the rings: batches m-5 .. m+3 of populations and m-3 .. m of ψ, each
    # a power of two rows
    assert lib.tpulbm_multiphase_smem_bytes() == 4 * (9 * 16 + 4) * 9
