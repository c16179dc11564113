"""The port's SO(3) tables and QHNet's radial basis against the JAX package.

* `real_cg` equals the JAX tables exactly (both float64 numpy, one formula);
* `real_sph_harm` (torch), its numpy twin and `wigner_d` within 1e-6
  relative of the JAX functions on the same unit vectors / rotations;
* `smooth_transition_cutoff` within 1e-6 relative of JAX's;
* `ExpBernsteinRBF` (values, and the gradient of a probe sum in the
  trainable `gamma`) within 3e-6 relative of the same basis evaluated in
  float64 (float32 rounding of log-space exponents of up to ~30), and within
  3e-5 relative of JAX's: JAX's float32 `gammaln` of
  the log-binomials is off by up to 1.5e-5 (an absolute error in the
  exponent, ~2e-5 relative in the basis), which the port avoids by taking
  the log-binomials in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.ops import radial as jradial
from nabladft_tpu.ops import so3 as jso3
from nabladft_tpu_torch.ops import radial, so3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REL = 1e-6
TRIPLES = [(l1, l2, l3) for l1 in range(5) for l2 in range(5)
           for l3 in range(abs(l1 - l2), min(l1 + l2, 4) + 1)]


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def _units(n=64, seed=0):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_real_cg_equals_jax_tables():
    for t in TRIPLES:
        np.testing.assert_array_equal(so3.real_cg(*t), jso3.real_cg(*t))


@pytest.mark.parametrize("normalized", [True, False])
def test_real_sph_harm_matches_jax(normalized):
    u = _units()
    want = np.asarray(jso3.real_sph_harm(jnp.asarray(u), 4, normalized=normalized))
    _close(so3.real_sph_harm(torch.from_numpy(u), 4, normalized=normalized).numpy(), want)
    _close(so3.real_sph_harm_np(u, 4, normalized), jso3.real_sph_harm_np(u, 4, normalized))


def test_wigner_d_matches_jax():
    q, _ = np.linalg.qr(np.random.default_rng(1).normal(size=(3, 3, 3)))
    rot = np.asarray(q * np.sign(np.linalg.det(q))[:, None, None], np.float32)
    for got, want in zip(so3.wigner_d(torch.from_numpy(rot), 4),
                         jso3.wigner_d(jnp.asarray(rot), 4)):
        _close(got.numpy(), np.asarray(want))


def test_sph_harm_rotates_by_wigner_d():
    """Y(R u) = D(R) Y(u), the identity the covariance tests rest on."""
    u = torch.from_numpy(_units(16, 2)).double()
    q, _ = np.linalg.qr(np.random.default_rng(3).normal(size=(3, 3)))
    rot = torch.from_numpy(q * np.sign(np.linalg.det(q)))
    ds = so3.wigner_d(rot, 4)
    y, y_rot = so3.real_sph_harm(u, 4), so3.real_sph_harm(u @ rot.T, 4)
    for l, d in enumerate(ds):
        sl = slice(l * l, (l + 1) * (l + 1))
        torch.testing.assert_close(y_rot[:, sl], y[:, sl] @ d.T, rtol=0, atol=1e-10)


def test_smooth_transition_cutoff_matches_jax():
    d = np.linspace(0.0, 14.0, 301).astype(np.float32)
    _close(radial.smooth_transition_cutoff(torch.from_numpy(d), 12.0).numpy(),
           np.asarray(jradial.smooth_transition_cutoff(jnp.asarray(d), 12.0)))


def _bernstein_f64(d, gamma_p, k=32, cutoff=12.0):
    """The basis in float64 (torch), differentiable in gamma_p."""
    from math import lgamma

    n = k - 1
    kk = torch.arange(k, dtype=torch.float64)
    lb = torch.tensor([lgamma(n + 1) - lgamma(i + 1) - lgamma(n - i + 1) for i in range(k)],
                      dtype=torch.float64)
    x = -torch.nn.functional.softplus(gamma_p) * d[..., None]
    basis = torch.exp(lb + kk * x + (n - kk) * torch.log(-torch.expm1(torch.clamp(x, max=-1e-8))))
    return basis * radial.smooth_transition_cutoff(d, cutoff)[..., None]


def test_exp_bernstein_rbf_and_gamma_gradient():
    d = np.random.default_rng(4).uniform(0.0, 13.0, size=(5, 7)).astype(np.float32)
    probe = np.random.default_rng(5).normal(size=(5, 7, 32)).astype(np.float32)
    jm = jradial.ExpBernsteinRBF(32, 12.0)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(d))
    want = np.asarray(jm.apply(params, jnp.asarray(d)))
    want_g = jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(d)) * probe))(params)

    tm = radial.ExpBernsteinRBF(32, 12.0)
    assert float(tm.gamma.detach()) == pytest.approx(float(params["params"]["gamma"]), rel=1e-7)
    got = tm(torch.from_numpy(d))
    (got * torch.from_numpy(probe)).sum().backward()
    g64 = tm.gamma.detach().double().requires_grad_(True)
    ref = _bernstein_f64(torch.from_numpy(d).double(), g64)
    (ref * torch.from_numpy(probe).double()).sum().backward()
    _close(got.detach().numpy(), ref.detach().numpy(), rel=3e-6)
    _close(tm.gamma.grad.numpy(), g64.grad.numpy(), rel=3e-6)
    _close(got.detach().numpy(), want, rel=3e-5)
    _close(tm.gamma.grad.numpy(), np.asarray(want_g["params"]["gamma"]), rel=3e-5)
