"""The kernel module (its CPU path) against tpulbm's Pallas kernels in
interpret mode, from a ±10% perturbed state, f32 at rtol 5e-6 / atol 1e-7,
one tiny case per depth:

* the solid-slab channel under the Bouzidi rule, rows 1-2: the 1-step
  kernel (make_local_step_pallas), the N-step cascade at N = 2 and at the
  one-device depth N = 4 (make_local_step_pallasN; TPULBM_PALLAS_TY=4, so
  that 24 rows hold the N + 1 slabs it needs);
* the D3Q27 Bouzidi sphere, rows 6-7: tpulbm's plan [3, 2] on one device
  (make_local_step_pallas3d_tiled at n_sub 3 and 2) and depth 1 on an
  x-cut mesh (its x_halo build).

The N = 4 slab and the [3, 2] sphere take 30-80 s each in interpret mode
here and are marked slow; the fast lane holds the same kernel module to
tpulbm's jax tier at those depths (tests/test_torch_slab.py,
tests/test_torch_bouzidi_d3q27.py).
"""
import jax
import numpy as np
import pytest
import torch

from tpulbm.parallel.mesh import make_mesh as jax_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state as jax_shard_state
from tpulbm_torch import convert
from tpulbm_torch.parallel import sharded_step
from tpulbm_torch.stepper import make_chunk_fn
from test_torch_bouzidi import _noisy
from test_torch_bouzidi_d3q27 import pair
from test_torch_mesh import cpu_mesh, perturbed
from test_torch_slab import F32_TOL, slab

_SWITCHES = ("TPULBM_SUBSTEPS", "TPULBM_NO_FUSED2", "TPULBM_HALO_OVERLAP",
             "TPULBM_FORCE_TILED", "TPULBM_FORCE_XHALO", "TPULBM_PALLAS_TY")


def _tpulbm_pallas(ref, shape, chunk_len, f0):
    mesh = jax_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
    chunk = jax_chunk_fn(ref, mesh, chunk_len, backend="pallas")
    s, solid = jax_shard_state(mesh, f0, ref.solid)
    return np.asarray(jax.device_get(chunk(s, solid))), chunk


def _slab_case(monkeypatch, n_sub):
    for k in _SWITCHES:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TPULBM_PALLAS_TY", "4")
    if n_sub != 4:
        monkeypatch.setenv("TPULBM_SUBSTEPS", str(n_sub))
    mine, ref = slab("bouzidi", "f32")
    f0 = _noisy(ref)
    want, chunk = _tpulbm_pallas(ref, (1, 1), n_sub, f0)
    assert chunk.pallas_substeps == n_sub
    port = make_chunk_fn(mine, "cpu", n_sub)
    assert port.plan == [(n_sub, 1)]
    got = port(torch.from_numpy(f0))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("n_sub", [1, 2], ids=["row1", "row2-n2"])
def test_slab_matches_pallas_rows_1_2(monkeypatch, n_sub):
    _slab_case(monkeypatch, n_sub)


@pytest.mark.slow
def test_slab_matches_pallas_row_2_at_n4(monkeypatch):
    _slab_case(monkeypatch, 4)


def test_d3q27_sphere_x_cut_matches_pallas_depth_1(monkeypatch):
    # (1,2): tpulbm's x_halo build declines Bouzidi above n_sub 1
    for k in _SWITCHES:
        monkeypatch.delenv(k, raising=False)
    mine, ref = pair("bgk", "f32", nx=16, ny=8, nz=4)
    f0 = perturbed(ref, 12)
    want, chunk = _tpulbm_pallas(ref, (1, 2), 2, f0)
    assert chunk.pallas3d_depths == [1]
    port = sharded_step.make_chunk_fn(mine, cpu_mesh((1, 2)), 2)
    assert port.pallas3d_depths == [1]
    got = convert.gather_state(port(convert.split_state(
        f0, mine, cpu_mesh((1, 2)))))
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.slow
def test_d3q27_sphere_matches_pallas_cascade_3_2(monkeypatch):
    # the smallest grid on which tpulbm's plan is [3, 2] (nz >= 4 and its
    # tile conditions at ny = 16)
    for k in _SWITCHES:
        monkeypatch.delenv(k, raising=False)
    mine, ref = pair("bgk", "f32", nx=16, ny=16, nz=4)
    f0 = perturbed(ref, 13)
    want, chunk = _tpulbm_pallas(ref, (1, 1), 5, f0)
    assert chunk.pallas3d_depths == [3, 2]
    port = make_chunk_fn(mine, "cpu", 5)
    assert port.pallas3d_depths == [3, 2]
    got = port(torch.from_numpy(f0))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
