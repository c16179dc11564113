"""Spherical / angular bases: Legendre polynomials, spherical Bessel functions.

The port of ``nabladft_tpu/ops/spherical.py``: stable recurrences evaluated
on tensors, with the Bessel zeros found on the host in numpy and cached.
DimeNet++ takes its radial and spherical bases from here (torch_geometric's
SphericalBasisLayer semantics, constants included), GemNet-OC will take
`legendre_polynomials`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from nabladft_tpu_torch.ops.radial import bessel_rbf, polynomial_envelope


def legendre_polynomials(x: torch.Tensor, l_max: int) -> torch.Tensor:
    """P_0..P_{l_max} by the three-term recurrence. [..., L+1]."""
    outs = [torch.ones_like(x)]
    if l_max >= 1:
        outs.append(x)
    for l in range(2, l_max + 1):
        outs.append(((2 * l - 1) * x * outs[l - 1] - (l - 1) * outs[l - 2]) / l)
    return torch.stack(outs, dim=-1)


def _jl_series(x: torch.Tensor, l: int, n_terms: int = 24) -> torch.Tensor:
    """Power series j_l(x) = x^l/(2l+1)!! · Σ_k t_k with the term ratio
    t_{k+1}/t_k = (-x²/2)/((k+1)(2l+2k+3)); accurate for x ≲ l+2 in fp32."""
    dfact = 1.0
    for i in range(1, 2 * l + 2, 2):
        dfact *= i
    t = torch.ones_like(x)
    s = t
    h = -(x * x) / 2.0
    for k in range(n_terms):
        t = t * h / ((k + 1) * (2 * l + 2 * k + 3))
        s = s + t
    return (x**l / dfact) * s


def _jl_upward(xs: torch.Tensor, l: int) -> torch.Tensor:
    """j_l by the upward recurrence (stable for x > l), xs > 0."""
    j = [torch.sin(xs) / xs]
    if l >= 1:
        j.append(torch.sin(xs) / xs**2 - torch.cos(xs) / xs)
    for ll in range(2, l + 1):
        j.append((2 * ll - 1) / xs * j[ll - 1] - j[ll - 2])
    return j[l]


def _jl(x: torch.Tensor, l: int) -> torch.Tensor:
    """j_l(x): the recurrence above l+1, the series below."""
    xs = torch.clamp(x, min=1e-6)
    up = _jl_upward(xs, l)
    if l < 2:
        return up
    return torch.where(xs > l + 1.0, up, _jl_series(xs, l))


def spherical_bessel_jl(x: torch.Tensor, l_max: int) -> torch.Tensor:
    """j_0..j_{l_max}(x), stable in fp32 over the basis range: the upward
    recurrence loses all accuracy for x < l, so below l+1 the power series
    is taken instead. [..., L+1]."""
    return torch.stack([_jl(x, l) for l in range(l_max + 1)], dim=-1)


def _np_jl(x: np.ndarray, l: int) -> np.ndarray:
    x = np.maximum(np.asarray(x, np.float64), 1e-12)
    j = [np.sin(x) / x, np.sin(x) / x**2 - np.cos(x) / x]
    for ll in range(2, l + 1):
        j.append((2 * ll - 1) / x * j[ll - 1] - j[ll - 2])
    return j[l]


@lru_cache(maxsize=None)
def spherical_bessel_zeros(l_max: int, n_zeros: int) -> Tuple[Tuple[float, ...], ...]:
    """The first n zeros of j_l for l = 0..l_max (host bisection, cached)."""

    def jl(x: np.ndarray, l: int) -> np.ndarray:
        # the upward recurrence oscillates around the exponentially small
        # j_l below x = l and crosses zero there: the series instead
        x = np.maximum(np.asarray(x, np.float64), 1e-12)
        j = [np.sin(x) / x, np.sin(x) / x**2 - np.cos(x) / x]
        for ll in range(2, l + 1):
            j.append((2 * ll - 1) / x * j[ll - 1] - j[ll - 2])
        if l < 2:
            return j[l]
        dfact = 1.0
        for i in range(1, 2 * l + 2, 2):
            dfact *= i
        t = np.ones_like(x)
        s = t.copy()
        for k in range(30):
            t = t * (-x * x / 2.0) / ((k + 1) * (2 * l + 2 * k + 3))
            s = s + t
        series = (x**l / dfact) * s
        return np.where(x > l + 1.0, j[l], series)

    out = []
    for l in range(l_max + 1):
        # above the trivial root at 0: the first zero of j_l exceeds l + 1/2
        lo0 = max(1e-3, l * 0.5)
        xs = np.linspace(lo0, (n_zeros + l + 2) * np.pi, 200000)
        sign = np.signbit(jl(xs, l))
        crossings = np.nonzero(sign[1:] != sign[:-1])[0]
        zeros = []
        for c in crossings[:n_zeros]:
            lo, hi = xs[c], xs[c + 1]
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                if np.signbit(jl(np.asarray([mid]), l))[0] == np.signbit(
                        jl(np.asarray([lo]), l))[0]:
                    lo = mid
                else:
                    hi = mid
            zeros.append(0.5 * (lo + hi))
        out.append(tuple(zeros))
    return tuple(out)


@lru_cache(maxsize=None)
def _radial_tables(num_spherical: int, num_radial: int, dtype: torch.dtype,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z_ln, torch_geometric's normalisation √2/|j_{l+1}(z_ln)|), [L+1, R]
    each, on `device` once."""
    l_max = num_spherical - 1
    zeros = np.asarray(spherical_bessel_zeros(l_max, num_radial))
    norm = np.sqrt(2.0) / np.abs(np.stack([_np_jl(zeros[l], l + 1) for l in range(l_max + 1)]))
    return (torch.tensor(zeros, dtype=dtype, device=device),
            torch.tensor(norm, dtype=dtype, device=device))


def _radial_ln(d: torch.Tensor, num_spherical: int, num_radial: int, cutoff: float,
               envelope_exponent: int, prefac=None) -> torch.Tensor:
    """[N, (L+1)·R], index l·R + n: prefac_l · u(x)/x · √2/|j_{l+1}(z_ln)| ·
    j_l(z_ln·x) on x = d/c flattened, torch_geometric's bessel_basis with its
    envelope; one j_l evaluation per l over all n (prefac_l [N] or None)."""
    zeros, norm = _radial_tables(num_spherical, num_radial, d.dtype, d.device)
    df = d.reshape(-1) / cutoff
    x_safe = torch.where(df > 1e-8, df, torch.ones_like(df))
    env = polynomial_envelope(df, envelope_exponent) / x_safe  # the tg Envelope keeps 1/x
    outs = []
    for l in range(num_spherical):
        pre = env if prefac is None else env * prefac[l]
        outs.append(pre[:, None] * (norm[l] * _jl(df[:, None] * zeros[l], l)))
    return torch.cat(outs, dim=-1)


def dimenet_spherical_basis(d: torch.Tensor, cos_angle: torch.Tensor, num_spherical: int,
                            num_radial: int, cutoff: float,
                            envelope_exponent: int = 5) -> torch.Tensor:
    """DimeNet's a_SBF(d, α), torch_geometric's SphericalBasisLayer:
    √2/|j_{l+1}(z_ln)| · j_l(z_ln·x) with x = d/c, times u(x)/x, times the
    real Y_l0(α). d is the k→j distance, cos_angle the k→j→i angle.
    Returns [..., num_spherical · num_radial], the radial index fastest."""
    pls = legendre_polynomials(cos_angle.reshape(-1), num_spherical - 1)
    prefac = [float(np.sqrt((2 * l + 1) / (4 * np.pi))) * pls[:, l] for l in range(num_spherical)]
    out = _radial_ln(d, num_spherical, num_radial, cutoff, envelope_exponent, prefac)
    return out.reshape(*d.shape, num_spherical * num_radial)


def dimenet_radial_part(d: torch.Tensor, num_spherical: int, num_radial: int, cutoff: float,
                        envelope_exponent: int = 5) -> torch.Tensor:
    """The radial factor of `dimenet_spherical_basis` without the Legendre
    term, R̃_ln(x) = √2/|j_{l+1}(z_ln)| · j_l(z_ln·x) · u(x)/x: the addition
    theorem then gives the triplet basis from pair-shaped factors
    (models/dimenetpp.py). Returns [..., (L+1)·R], index l·R + n."""
    out = _radial_ln(d, num_spherical, num_radial, cutoff, envelope_exponent)
    return out.reshape(*d.shape, num_spherical * num_radial)


def bessel_radial_basis_with_envelope(d: torch.Tensor, num_radial: int, cutoff: float,
                                      envelope_exponent: int = 5) -> torch.Tensor:
    """DimeNet's e_RBF: the zeroth-order Bessel basis times the polynomial
    envelope. [..., R]."""
    return bessel_rbf(d, num_radial, cutoff) * polynomial_envelope(
        d / cutoff, envelope_exponent)[..., None]
