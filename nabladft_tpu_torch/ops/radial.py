"""Radial basis expansions and cutoff envelopes (torch).

The bases of ``nabladft_tpu/ops/radial.py`` that PaiNN, SchNet, QHNet and
eSCN use (QHNet's exponential Bernstein basis is a module: its γ trains). All
functions are pure, operate on arbitrarily shaped distance tensors and
broadcast a trailing basis axis; padded distances may be 0 or huge, callers
multiply by their own edge masks.

Each `*_jvp(d, td, ...)` returns the tangent of its function at d along td
in closed form, with the order of operations of `jax.jvp` on the JAX
functions (the fused PaiNN kernels take ∂(basis·envelope)/∂dist as data;
near the cutoff the envelope's terms cancel, so the rounding order shows).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def cosine_cutoff(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    """SchNet-style smooth cosine cutoff: 0.5*(cos(pi d/rc)+1), 0 beyond rc."""
    x = 0.5 * (torch.cos(math.pi * d / cutoff) + 1.0)
    return torch.where(d < cutoff, x, torch.zeros_like(x))


def polynomial_envelope(d_scaled: torch.Tensor, p: int = 5) -> torch.Tensor:
    """DimeNet/GemNet polynomial envelope u(x) on x = d/cutoff in [0,1].

    u(x) = 1 - (p+1)(p+2)/2 x^p + p(p+2) x^(p+1) - p(p+1)/2 x^(p+2),
    zero outside [0, 1). Smooth to order p-1 at the cutoff.
    """
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    x = d_scaled
    u = 1.0 + a * _ipow(x, p) + b * _ipow(x, p + 1) + c * _ipow(x, p + 2)
    return torch.where(d_scaled < 1.0, u, torch.zeros_like(u))


def polynomial_envelope_jvp(x: torch.Tensor, tx: torch.Tensor, p: int = 5) -> torch.Tensor:
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    t = (a * (tx * (p * _ipow(x, p - 1)))
         + b * (tx * ((p + 1) * _ipow(x, p)))
         + c * (tx * ((p + 2) * _ipow(x, p + 1))))
    return torch.where(x < 1.0, t, torch.zeros_like(t))


def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n by binary exponentiation, the multiplication order XLA uses for
    integer powers: the envelope cancels to ~0 near the cutoff, where the
    rounding of each power shows."""
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def cosine_cutoff_jvp(d: torch.Tensor, td: torch.Tensor, cutoff: float) -> torch.Tensor:
    t = 0.5 * -(math.pi * td / cutoff * torch.sin(math.pi * d / cutoff))
    return torch.where(d < cutoff, t, torch.zeros_like(t))


def _centers(d: torch.Tensor, num_basis: int, cutoff: float, start: float):
    centers = torch.linspace(start, cutoff, num_basis, dtype=d.dtype, device=d.device)
    width = (centers[1] - centers[0]) if num_basis > 1 else torch.tensor(
        cutoff, dtype=d.dtype, device=d.device)
    return centers, -0.5 / width**2


def gaussian_rbf(
    d: torch.Tensor, num_basis: int, cutoff: float, start: float = 0.0
) -> torch.Tensor:
    """Gaussian RBF with evenly spaced centres on [start, cutoff] (SchNet):
    width = centre spacing. Returns [..., num_basis]."""
    centers, coeff = _centers(d, num_basis, cutoff, start)
    diff = d[..., None] - centers
    return torch.exp(coeff * (diff * diff))


def gaussian_rbf_jvp(d: torch.Tensor, td: torch.Tensor, num_basis: int, cutoff: float,
                     start: float = 0.0) -> torch.Tensor:
    centers, coeff = _centers(d, num_basis, cutoff, start)
    diff = d[..., None] - centers
    return (coeff * (td[..., None] * (2.0 * diff))) * torch.exp(coeff * (diff * diff))


def gaussian_smearing(d: torch.Tensor, num_basis: int, start: float, stop: float,
                      basis_width_scalar: float = 1.0) -> torch.Tensor:
    """Gaussian smearing on [start, stop] (eSCN's distance expansion):
    width = basis_width_scalar × centre spacing. Returns [..., num_basis]."""
    # jnp.linspace's rounding: start + i · ((stop - start) / (n - 1)) in d's dtype
    step = torch.tensor(stop - start, dtype=d.dtype, device=d.device) / (num_basis - 1)
    centers = start + torch.arange(num_basis, dtype=d.dtype, device=d.device) * step
    width = basis_width_scalar * (centers[1] - centers[0])
    diff = d[..., None] - centers
    return torch.exp(-0.5 / width**2 * diff**2)


def bessel_rbf(d: torch.Tensor, num_basis: int, cutoff: float) -> torch.Tensor:
    """Zeroth-order spherical Bessel basis sqrt(2/rc) sin(n pi d/rc)/d.

    Safe at d=0 (the d→0 limit n·pi/rc·sqrt(2/rc)). Returns [..., num_basis].
    """
    n = torch.arange(1, num_basis + 1, dtype=d.dtype, device=d.device)
    d_safe = torch.where(d > 1e-8, d, torch.ones_like(d))
    norm = math.sqrt(2.0 / cutoff)
    out = norm * torch.sin(n * math.pi * d_safe[..., None] / cutoff) / d_safe[..., None]
    limit = norm * n * math.pi / cutoff
    return torch.where((d > 1e-8)[..., None], out, limit.expand_as(out))


def smooth_transition_cutoff(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    """PhiSNet-style infinitely differentiable bump cutoff:
    exp(-x² / ((rc-x)(rc+x))) for x < rc, else 0."""
    x = torch.clamp(d, 0.0, cutoff * (1.0 - 1e-6))
    z = x**2 / ((cutoff - x) * (cutoff + x))
    e = torch.exp(-z)
    return torch.where(d < cutoff, e, torch.zeros_like(e))


class ExpBernsteinRBF(nn.Module):
    """Exponential Bernstein polynomial basis (QHNet): b_k(d) =
    B_{k,K}(exp(-γ d)) · smooth_transition_cutoff(d), evaluated in log
    space, with a trainable γ = softplus(`gamma`) (the flax module's param,
    initialised so that γ = gamma_init)."""

    def __init__(self, num_basis: int, cutoff: float, gamma_init: float = 0.5):
        super().__init__()
        self.num_basis, self.cutoff = num_basis, cutoff
        self.gamma = nn.Parameter(torch.tensor(math.log(math.expm1(gamma_init)),
                                               dtype=torch.float32))

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        n = self.num_basis - 1
        k = torch.arange(self.num_basis, dtype=torch.float32, device=d.device)
        # log C(n, k) in float64, rounded once (JAX's float32 gammaln is off
        # by up to ~1.5e-5 here, which the basis' exp turns into ~2e-5 relative)
        log_binom = torch.tensor([math.lgamma(n + 1) - math.lgamma(i + 1) - math.lgamma(n - i + 1)
                                  for i in range(self.num_basis)], dtype=torch.float32,
                                 device=d.device)
        x = -F.softplus(self.gamma) * d[..., None]  # log(exp(-γ d))
        log1m = torch.log(-torch.expm1(torch.clamp(x, max=-1e-8)))
        basis = torch.exp(log_binom + k * x + (n - k) * log1m)
        return basis * smooth_transition_cutoff(d, self.cutoff)[..., None]


def bessel_rbf_jvp(d: torch.Tensor, td: torch.Tensor, num_basis: int,
                   cutoff: float) -> torch.Tensor:
    n = torch.arange(1, num_basis + 1, dtype=d.dtype, device=d.device)
    d_safe = torch.where(d > 1e-8, d, torch.ones_like(d))[..., None]
    k = n * math.pi / cutoff
    norm = math.sqrt(2.0 / cutoff)
    t = norm * (k * torch.cos(k * d_safe) / d_safe - torch.sin(k * d_safe) / (d_safe * d_safe))
    return torch.where((d > 1e-8)[..., None], t * td[..., None], torch.zeros_like(t))
