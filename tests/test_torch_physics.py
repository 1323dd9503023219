"""tpulbm_torch.physics against tpulbm.physics on the same random positive
populations (made with NumPy from a seed).

f64 agrees to round-off (rtol 1e-12). f32 is held at rtol 5e-6 / atol
1e-7, the tolerance tpulbm's own pallas-vs-jax gates use: the two
frameworks may sum the nine planes in another order, and the CUDA kernel
these functions stand in for multiplies by 1/rho where physics divides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulbm import physics as jphys
from tpulbm.lattice import D2Q9
from tpulbm_torch import physics as tphys
from tpulbm_torch.lattice import lattice_tensors

TOL = {np.float64: dict(rtol=1e-12, atol=0.0),
       np.float32: dict(rtol=5e-6, atol=1e-7)}


def _populations(dtype, shape=(9, 24, 40), seed=0):
    rng = np.random.default_rng(seed)
    u = (0.05, 0.01)
    base = tphys.uniform_equilibrium(D2Q9, 1.0, u)[:, None, None]
    noise = rng.uniform(-0.2, 0.2, size=shape)
    return (base * (1.0 + noise)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_moments_equilibrium_collide_match_jax(dtype):
    f = _populations(dtype)
    ft = torch.from_numpy(f)
    rho_j, u_j = jphys.moments(D2Q9, jnp.asarray(f))
    rho_t, u_t = tphys.moments(D2Q9, ft)
    tol = TOL[dtype]
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j), **tol)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), **tol)

    feq_j = jphys.equilibrium(D2Q9, rho_j, u_j)
    feq_t = tphys.equilibrium(D2Q9, rho_t, u_t)
    assert feq_t.dtype == ft.dtype
    np.testing.assert_allclose(feq_t.numpy(), np.asarray(feq_j), **tol)

    inv_tau = 1.0 / 0.5384
    post_j = jphys.collide(D2Q9, jnp.asarray(f), inv_tau)
    post_t = tphys.collide(D2Q9, ft, inv_tau)
    np.testing.assert_allclose(post_t.numpy(), np.asarray(post_j), **tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stability_and_max_velocity_match_jax(dtype):
    f = _populations(dtype, seed=1)
    solid = np.zeros(f.shape[1:], bool)
    solid[10:14, 8:12] = True
    got = tphys.max_velocity(D2Q9, torch.from_numpy(f),
                             torch.from_numpy(solid))
    want = jphys.max_velocity(D2Q9, jnp.asarray(f), jnp.asarray(solid))
    np.testing.assert_allclose(float(got), float(want), **TOL[dtype])
    assert bool(tphys.is_stable(torch.from_numpy(f)))
    f[3, 5, 7] = np.nan
    assert not bool(tphys.is_stable(torch.from_numpy(f)))
    assert bool(jphys.is_stable(jnp.asarray(f))) is False


def test_host_equilibria_match_jax():
    for u in ((0.0, 0.0), (0.05, 0.0), (0.01333, -0.02)):
        np.testing.assert_array_equal(
            tphys.uniform_equilibrium(D2Q9, 1.0, u, np.float32),
            jphys.uniform_equilibrium(D2Q9, 1.0, u, np.float32))
    np.testing.assert_array_equal(tphys.rest_equilibrium(D2Q9, np.float32),
                                  jphys.rest_equilibrium(D2Q9, np.float32))


def test_lattice_tensors():
    c, w, opp = lattice_tensors(D2Q9, "cpu", torch.float64)
    assert c.dtype == opp.dtype == torch.int64 and w.dtype == torch.float64
    np.testing.assert_array_equal(c.numpy(), D2Q9.c)
    np.testing.assert_array_equal(w.numpy(), D2Q9.w)
    np.testing.assert_array_equal(opp.numpy(), [0, 3, 4, 1, 2, 7, 8, 5, 6])
    assert torch.equal(c[opp], -c)
