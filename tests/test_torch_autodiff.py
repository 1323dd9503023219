"""Reverse-mode autodiff through the port's plain tier, tpulbm's
tests/test_autodiff.py gates on ops/step_torch.make_step_rolled: the
solver is an out-of-place function of its state, so torch.autograd
differentiates a flow functional through the unrolled time loop.

* the gradient of a 50-step f64 Taylor-Green functional against central
  finite differences along a numpy-seeded direction (plain, and with
  torch.utils.checkpoint around each step);
* torch.utils.checkpoint (rematerialization) equal to the plain adjoint
  (rtol 1e-12);
* a gradient through Kolmogorov's in-step force;
* the port's gradient equal to tpulbm's jax.grad from the same
  numpy-seeded state (rtol 1e-10).

The scope is tpulbm's own: the plain tier. The CUDA kernels, as tpulbm's
Pallas kernels, have no backward.
"""
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from tpulbm_torch import physics
from tpulbm_torch.config import SimulationParams
from tpulbm_torch.models import make_problem
from tpulbm_torch.ops.step_torch import make_step_rolled

TG = dict(nx=32, ny=32, tau=0.8, problem="taylor-green", inlet_velocity=0.04,
          periodic_x=True, cylinder_radius=0.0, precision="f64")
KOLMOGOROV = dict(nx=32, ny=32, tau=0.8, problem="kolmogorov",
                  kolmogorov_n=2, inlet_velocity=0.01, periodic_x=True,
                  cylinder_radius=0.0, precision="f64")


def _problem(**kw):
    return make_problem(SimulationParams(**kw))


def _loss_fn(pr, steps, remat=False):
    step = make_step_rolled(pr, "cpu")

    def loss(f):
        for _ in range(steps):
            f = checkpoint(step, f, use_reentrant=False) if remat else step(f)
        rho, u = physics.moments(pr.lattice, f)
        return torch.sum(rho * (u[0] ** 2 + u[1] ** 2))

    return loss


def _grad(loss, f0: np.ndarray) -> torch.Tensor:
    f = torch.from_numpy(f0.copy()).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(f), f)
    return g


def _direction(shape, seed: int) -> np.ndarray:
    d = np.random.default_rng(seed).standard_normal(shape)
    return d / np.linalg.norm(d.ravel())


def _central(loss, f0: np.ndarray, d: np.ndarray, eps: float = 1e-6):
    with torch.no_grad():
        return (float(loss(torch.from_numpy(f0 + eps * d)))
                - float(loss(torch.from_numpy(f0 - eps * d)))) / (2 * eps)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_grad_matches_finite_difference(remat):
    pr = _problem(**TG)
    loss = _loss_fn(pr, steps=50, remat=remat)
    f0 = pr.initial_state()
    g = _grad(loss, f0)
    assert torch.isfinite(g).all()
    d = _direction(f0.shape, 7)
    ad = float(torch.sum(g * torch.from_numpy(d)))
    np.testing.assert_allclose(ad, _central(loss, f0, d), rtol=1e-6,
                               atol=1e-12)


def test_remat_gradient_identical_to_plain():
    pr = _problem(**TG)
    f0 = pr.initial_state()
    g1 = _grad(_loss_fn(pr, 30, remat=False), f0)
    g2 = _grad(_loss_fn(pr, 30, remat=True), f0)
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=1e-12,
                               atol=1e-15)


def test_gradient_flows_through_kolmogorov_forcing():
    pr = _problem(**KOLMOGOROV)
    step = make_step_rolled(pr, "cpu")
    kappa = 2.0 * np.pi * 2 / 32.0
    cosy = torch.from_numpy(np.cos(kappa * np.arange(32))[:, None]
                            * np.ones((1, 32)))

    def loss(f):
        for _ in range(40):
            f = step(f)
        _, u = physics.moments(pr.lattice, f)
        return torch.mean(u[0] * cosy)

    f0 = pr.initial_state()
    g = _grad(loss, f0)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    d = _direction(f0.shape, 3)
    np.testing.assert_allclose(float(torch.sum(g * torch.from_numpy(d))),
                               _central(loss, f0, d), rtol=1e-5, atol=1e-14)


@pytest.mark.parametrize("case", ["taylor-green", "kolmogorov"])
def test_gradient_matches_tpulbm_jax_grad(case):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from test_torch_compat import port_params
    from tpulbm import physics as jphysics
    from tpulbm.config import SimulationParams as JaxParams
    from tpulbm.lattice import D2Q9
    from tpulbm.models import make_problem as jax_problem
    from tpulbm.ops.step_jax import make_step_rolled as jax_step_rolled

    jparams = JaxParams(**(TG if case == "taylor-green" else KOLMOGOROV))
    jpr, pr = jax_problem(jparams), make_problem(port_params(jparams))
    f0 = jpr.initial_state()
    f0 = f0 * (1 + 0.01 * np.random.default_rng(11).uniform(-1, 1, f0.shape))
    jstep = jax_step_rolled(jpr)

    def jloss(f):
        f, _ = lax.scan(lambda g, _: (jstep(g), None), f, None, length=20)
        rho, u = jphysics.moments(D2Q9, f)
        return jnp.sum(rho * (u[0] ** 2 + u[1] ** 2))

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(f0)))
    got = _grad(_loss_fn(pr, 20), f0).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())
