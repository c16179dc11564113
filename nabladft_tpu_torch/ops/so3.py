"""SO(3) algebra: real Clebsch-Gordan tables, spherical harmonics, Wigner-D.

The port's copy of the first part of ``nabladft_tpu/ops/so3.py``. Everything
derives from one source, the complex CG coefficients of the Racah formula,
so spherical harmonics, rotations and tensor products agree by
construction:

  * real CG tables: the unitary real↔complex change of basis applied to the
    Racah coefficients, de-phased to real (host-side float64, cached);
  * real spherical harmonics Y^l(u) by the CG recursion
    Y^l ∝ Pᵀ (Y^{l-1} ⊗ Y^1), Y^1 ∝ (y, z, x);
  * Wigner D^l(R) by the same recursion on D^1 = perm(R);
  * eSCN's edge alignment (`rot_to_z`) and its m-major truncated layout:
    the compact per-edge Wigner values the fused message kernel reads.

Basis ordering: m = -l..l flat-packed per l at offset l² (total (L+1)²).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch


def _f(n: int) -> int:
    return math.factorial(n)


def _cg_coeff(l1: int, m1: int, l2: int, m2: int, l3: int, m3: int) -> float:
    """⟨l1 m1 l2 m2 | l3 m3⟩ (Condon-Shortley), the Racah sum."""
    if m3 != m1 + m2:
        return 0.0
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return 0.0
    pref = (
        (2 * l3 + 1)
        * _f(l3 + l1 - l2)
        * _f(l3 - l1 + l2)
        * _f(l1 + l2 - l3)
        / _f(l1 + l2 + l3 + 1)
    )
    pref *= (
        _f(l3 + m3)
        * _f(l3 - m3)
        * _f(l1 - m1)
        * _f(l1 + m1)
        * _f(l2 - m2)
        * _f(l2 + m2)
    )
    s = 0.0
    for k in range(0, l1 + l2 - l3 + 1):
        denoms = (
            k,
            l1 + l2 - l3 - k,
            l1 - m1 - k,
            l2 + m2 - k,
            l3 - l2 + m1 + k,
            l3 - l1 - m2 + k,
        )
        if any(d < 0 for d in denoms):
            continue
        term = 1.0
        for d in denoms:
            term *= _f(d)
        s += (-1.0) ** k / term
    return math.sqrt(pref) * s


@lru_cache(maxsize=None)
def complex_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """[2l1+1, 2l2+1, 2l3+1] complex-basis CG (float64)."""
    out = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if -l3 <= m3 <= l3:
                out[m1 + l1, m2 + l2, m3 + l3] = _cg_coeff(l1, m1, l2, m2, l3, m3)
    return out


@lru_cache(maxsize=None)
def real_to_complex_matrix(l: int) -> np.ndarray:
    """U[m_complex, m_real] with Y_complex = U @ Y_real."""
    n = 2 * l + 1
    u = np.zeros((n, n), complex)
    s2 = 1.0 / math.sqrt(2.0)
    u[l, l] = 1.0
    for m in range(1, l + 1):
        u[l + m, l + m] = (-1) ** m * s2
        u[l + m, l - m] = 1j * (-1) ** m * s2
        u[l - m, l + m] = s2
        u[l - m, l - m] = -1j * s2
    return u


@lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG [2l1+1, 2l2+1, 2l3+1] (float64), de-phased to real:
    parity-odd paths come out purely imaginary and are rotated onto the
    real axis (a per-path constant that learned weights absorb)."""
    c = complex_cg(l1, l2, l3)
    u1 = real_to_complex_matrix(l1)
    u2 = real_to_complex_matrix(l2)
    u3 = real_to_complex_matrix(l3)
    cr = np.einsum("abc,ax,by,cz->xyz", c, u1, u2, np.conj(u3))
    re, im = np.real(cr), np.imag(cr)
    if np.abs(im).max() > 1e-9 and np.abs(re).max() > 1e-9:
        raise AssertionError(f"real CG ({l1},{l2},{l3}) is neither real nor imaginary")
    out = re if np.abs(re).max() >= np.abs(im).max() else im
    return np.ascontiguousarray(out)


@lru_cache(maxsize=None)
def _sh_scale(l_max: int) -> Tuple[float, ...]:
    """Per-l scale making the recursion orthonormal (Y_l0(ẑ) = sqrt((2l+1)/4π))."""
    y1 = np.array([0.0, 1.0, 0.0])
    ys = {0: np.array([1.0]), 1: y1}
    scales = [math.sqrt(1.0 / (4 * math.pi))]
    if l_max >= 1:
        scales.append(math.sqrt(3.0 / (4 * math.pi)))
    for l in range(2, l_max + 1):
        raw = np.einsum("a,b,abm->m", ys[l - 1], y1, real_cg(l - 1, 1, l))
        ys[l] = raw / np.abs(raw[l])
        scales.append(math.sqrt((2 * l + 1) / (4 * math.pi)) * np.sign(raw[l]))
    return tuple(float(s) for s in scales)


@lru_cache(maxsize=None)
def _sh_recursion_consts(l_max: int) -> Tuple[float, ...]:
    """1/|raw_l(ẑ)| factors that keep the recursion normalized."""
    y1 = np.array([0.0, 1.0, 0.0])
    ys = {0: np.array([1.0]), 1: y1}
    consts = [1.0, 1.0]
    for l in range(2, l_max + 1):
        raw = np.einsum("a,b,abm->m", ys[l - 1], y1, real_cg(l - 1, 1, l))
        consts.append(1.0 / abs(raw[l]))
        ys[l] = raw / abs(raw[l])
    return tuple(float(x) for x in consts)


def real_sph_harm_np(unit: np.ndarray, l_max: int, normalized: bool = True) -> np.ndarray:
    """Host-side (numpy, float64) twin of :func:`real_sph_harm`."""
    unit = np.asarray(unit, np.float64)
    x, y, z = unit[..., 0], unit[..., 1], unit[..., 2]
    ys: List[np.ndarray] = [np.ones_like(x)[..., None]]
    if l_max >= 1:
        ys.append(np.stack([y, z, x], axis=-1))
    consts = _sh_recursion_consts(l_max)
    for l in range(2, l_max + 1):
        raw = np.einsum("...a,...b,abm->...m", ys[l - 1], ys[1], real_cg(l - 1, 1, l))
        ys.append(raw * consts[l])
    if normalized:
        ys = [y_l * s for y_l, s in zip(ys, _sh_scale(l_max))]
    return np.concatenate(ys, axis=-1)


def real_sph_harm(unit: torch.Tensor, l_max: int, normalized: bool = True) -> torch.Tensor:
    """Real spherical harmonics of unit vectors [..., 3] -> [..., (L+1)²].

    `normalized=True` gives the orthonormal convention (∫ Y² dΩ = 1);
    `False` the "component" normalization Y_l(ẑ)_0 = 1.
    """
    x, y, z = unit[..., 0], unit[..., 1], unit[..., 2]
    ys: List[torch.Tensor] = [torch.ones_like(x)[..., None]]
    if l_max >= 1:
        ys.append(torch.stack([y, z, x], dim=-1))
    consts = _sh_recursion_consts(l_max)
    for l in range(2, l_max + 1):
        c = torch.as_tensor(real_cg(l - 1, 1, l), dtype=unit.dtype, device=unit.device)
        raw = torch.einsum("...a,...b,abm->...m", ys[l - 1], ys[1], c)
        ys.append(raw * consts[l])
    if normalized:
        ys = [y_l * s for y_l, s in zip(ys, _sh_scale(l_max))]
    return torch.cat(ys, dim=-1)


_XYZ_TO_YZX = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])


def wigner_d(rot: torch.Tensor, l_max: int) -> List[torch.Tensor]:
    """D^0..D^L for batched rotation matrices rot [..., 3, 3]: D^1 = P rot Pᵀ
    in the (y,z,x) real-SH basis, then D^l = Cᵀ (D^{l-1} ⊗ D^1) C with
    C = real_cg(l-1, 1, l)."""
    p = torch.as_tensor(_XYZ_TO_YZX, dtype=rot.dtype, device=rot.device)
    d1 = torch.einsum("ia,...ab,jb->...ij", p, rot, p)
    ds: List[torch.Tensor] = [torch.ones((*rot.shape[:-2], 1, 1), dtype=rot.dtype,
                                         device=rot.device), d1]
    for l in range(2, l_max + 1):
        c = torch.as_tensor(real_cg(l - 1, 1, l), dtype=rot.dtype, device=rot.device)
        ds.append(torch.einsum("abm,...ax,...by,xyn->...mn", c, ds[l - 1], d1, c))
    return ds


def rot_to_z(unit: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rotation R with R @ unit = ẑ (Rodrigues about unit × ẑ), deterministic:
    where that axis vanishes (unit = ±ẑ, or a zero row) the axis is x̂."""
    x, y, z = unit[..., 0], unit[..., 1], unit[..., 2]
    ax = torch.stack([y, -x, torch.zeros_like(x)], dim=-1)
    s = torch.linalg.vector_norm(ax, dim=-1, keepdim=True)
    fallback = torch.zeros_like(ax)
    fallback[..., 0] = 1.0
    a = torch.where(s > eps, ax / torch.clamp(s, min=eps), fallback)
    c = z[..., None, None]  # cos θ
    sin_t = torch.clamp(s, 0.0, 1.0)[..., None]
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    zeros = torch.zeros_like(a0)
    k = torch.stack([torch.stack([zeros, -a2, a1], dim=-1),
                     torch.stack([a2, zeros, -a0], dim=-1),
                     torch.stack([-a1, a0, zeros], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=unit.dtype, device=unit.device).expand(k.shape)
    return eye + sin_t * k + (1.0 - c) * (k @ k)


def mmajor_rows(l_max: int, m_max: int) -> List[Tuple[int, int]]:
    """Row order (l, m) of the m-truncated stack, grouped by m: m=0
    (l=0..L), then the +m and -m rows (l=m..L each) for m=1..M."""
    rows = [(l, 0) for l in range(l_max + 1)]
    for m in range(1, m_max + 1):
        rows += [(l, m) for l in range(m, l_max + 1)]
        rows += [(l, -m) for l in range(m, l_max + 1)]
    return rows


def mmajor_cols(l_max: int, m_max: int) -> np.ndarray:
    """Flat (L+1)²-layout index l² + l + m of each m-major row."""
    return np.asarray([l * l + l + m for l, m in mmajor_rows(l_max, m_max)], np.int32)


def trunc_compact_layout(l_max: int, m_max: int) -> Tuple[List[int], int]:
    """Per-l offsets and total size K of the compact truncated Wigner values:
    block l stores its (2min(l,M)+1) × (2l+1) rows row-major at off[l], so
    idx(l, mrow, col) = off[l] + mrow·(2l+1) + col."""
    offs, off = [], 0
    for l in range(l_max + 1):
        offs.append(off)
        off += (2 * min(l, m_max) + 1) * (2 * l + 1)
    return offs, off


def wigner_trunc_compact_from_rot(rot: torch.Tensor, l_max: int, m_max: int) -> torch.Tensor:
    """Compact truncated Wigner values [..., K] of rotations [..., 3, 3]:
    D^l's rows m = -min(l,M)..min(l,M), row-major per l (`trunc_compact_layout`).
    The JAX function pads K to a multiple of 128 for the TPU's lanes; this
    one does not."""
    ds = wigner_d(rot, l_max)
    parts = []
    for l in range(l_max + 1):
        mc = min(l, m_max)
        parts.append(ds[l][..., l - mc:l + mc + 1, :].reshape(*rot.shape[:-2], -1))
    return torch.cat(parts, dim=-1)
