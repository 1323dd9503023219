"""The D3Q19 phase lab (tpulbm_torch/utils/kernel_lab.py) against tpulbm's
(scripts/kernel_lab.py), on the CPU.

* the plain lab against tpulbm's make_lab_kernel(interpret=True) at size
  16 (two 8-row tiles), every variant, over the rows it writes [H, H +
  ny): the copies, the stream and the strip ops bit for bit, the
  collision at rtol 5e-6 / atol 1e-7 (the Pallas collision multiplies by
  1/rho where the plain one divides); the lab's pad rows are its input's;
* the lab's CUDA source built for the host with g++ (the fake runtime of
  tests/test_torch_slab.py) against the plain lab, every variant for 1 and
  3 chained iterations on ragged shapes, at the same tolerance;
* the CLI with --cpu: one JSON line per variant with tpulbm's keys.
"""
import json
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulbm_torch.utils import kernel_lab as lab
from test_torch_slab import host_build  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import kernel_lab as jax_lab  # noqa: E402

SIZE = 16
TILE = 8


@pytest.fixture(scope="module")
def lab_input():
    rng = np.random.default_rng(0)
    return rng.uniform(0.02, 0.08, (19, SIZE, SIZE + 2 * lab.H,
                                    SIZE)).astype(np.float32)


@pytest.mark.parametrize("variant", list(lab.VARIANTS))
def test_plain_lab_matches_tpulbm(lab_input, variant):
    assert jax_lab.VARIANTS[variant] == lab.VARIANTS[variant]
    assert (jax_lab.H, lab.H) == (8, 8)
    call, q, wy = jax_lab.make_lab_kernel(SIZE, SIZE, SIZE, TILE,
                                          interpret=True,
                                          **jax_lab.VARIANTS[variant])
    want = np.asarray(call(jnp.asarray(lab_input)))
    got = lab.plain_lab(torch.from_numpy(lab_input), variant).numpy()
    rows = slice(lab.H, lab.H + SIZE)
    if lab.VARIANTS[variant]["do_collide"]:
        np.testing.assert_allclose(got[:, :, rows], want[:, :, rows],
                                   rtol=5e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got[:, :, rows], want[:, :, rows])
    pads = np.r_[0:lab.H, lab.H + SIZE:SIZE + 2 * lab.H]
    np.testing.assert_array_equal(got[:, :, pads], lab_input[:, :, pads])


def test_lab_step_on_the_cpu_is_the_plain_lab_and_uncounted(lab_input):
    f = torch.from_numpy(lab_input)
    before = dict(lab.lab_step.launches)
    out = lab.lab_step(f, f.clone(), "full")
    assert torch.equal(out, lab.plain_lab(f, "full"))
    assert lab.lab_step.launches == before
    with pytest.raises(ValueError):
        lab.lab_step(f, f, "full")                   # out aliases f
    with pytest.raises(ValueError):
        lab.lab_step(f[:18].clone(), f[:18].clone(), "full")


@pytest.fixture
def host_lab(host_build, monkeypatch):
    """kernel_lab's launch path run on CPU tensors against the host build
    of csrc/kernel_lab_d3q19.cu."""
    lab._library.cache_clear()
    monkeypatch.setattr(lab.cuda_build, "load",
                        lambda source, defines=(): types.SimpleNamespace(
                            lib=host_build(source, defines)))
    lib = lab._library()
    w = (lab.ctypes.c_float * 19)(*lab.lat_mod.D3Q19.w.astype(np.float32))
    eq = (lab.ctypes.c_float * 19)(*lab.eq_in())

    def step(f, out, variant):
        q, nz, rows, nx = f.shape
        assert lib.tpulbm_kernel_lab_d3q19(
            f.data_ptr(), out.data_ptr(), nx, rows - 2 * lab.H, nz,
            list(lab.VARIANTS).index(variant), 1.0 / lab.TAU, eq, w, 0,
            None) == 0
        return out

    yield step
    lab._library.cache_clear()


@pytest.mark.parametrize("shape", [(40, 13, 70), (5, 3, 2)],
                         ids=["ragged", "small"])
@pytest.mark.parametrize("variant", list(lab.VARIANTS))
def test_host_kernel_matches_plain_lab(host_lab, shape, variant):
    nx, ny, nz = shape
    gen = torch.Generator().manual_seed(1)
    f = torch.rand((19, nz, ny + 2 * lab.H, nx), generator=gen) * 0.06 + 0.02
    a, b, want = f.clone(), f.clone(), f.clone()
    for k in range(3):
        a, b = host_lab(a, b, variant), a
        want = lab.plain_lab(want, variant)
        torch.testing.assert_close(a, want, **lab.TOL, msg=f"iteration {k}")


def test_cli_on_the_cpu_prints_tpulbm_keys():
    out = subprocess.run(
        [sys.executable, "-m", "tpulbm_torch.utils.kernel_lab", "--size",
         "8", "--iters", "1", "--repeats", "1", "--cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert [r["variant"] for r in rows] == list(lab.VARIANTS)
    keys = {"variant", "size", "ty", "iters", "mlups_effective", "raw_gpops",
            "dma_gbs_min", "best_s"}
    for r in rows:
        assert keys <= set(r)
        assert (r["size"], r["ty"], r["iters"], r["device"]) == (
            8, lab.TILE_Y, 1, "cpu")
        assert "bound_share" not in r          # no device number from a CPU
