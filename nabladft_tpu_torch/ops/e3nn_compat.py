"""e3nn numeric conventions, reconstructed for checkpoint conversion
(QHNet family); a copy of ``nabladft_tpu/ops/e3nn_compat.py`` over the
port's numpy `so3` tables.

The package does not depend on e3nn, so the QHNet converter
(models/pretrained.convert_qhnet) and its golden test reconstruct the
e3nn quantities the reference model (qhnet/qhnet.py, qhnet/layers.py)
consumes:

  * `e3nn_w3j(l1,l2,l3)`: o3.wigner_3j — the real-basis 3j intertwiner,
    built exactly as e3nn's `_so3_clebsch_gordan`: the complex
    Clebsch-Gordan table transported by e3nn's
    `change_basis_real_to_complex` matrices (the (-1j)^l-phased unitary
    below), Frobenius-normalized to 1. Empirically pinned against real
    e3nn data: contracted with two Jd.pt-derived e3nn spherical
    harmonics it reproduces the third (sign included), and its
    (l,l,0) diagonal is positive, which is what makes o3.Norm/
    InnerProduct outputs positive (tests/models/test_pretrained_qhnet.py).

  * the CENTRAL identity this file rests on (measured to 1e-15,
    test_pretrained_qhnet.test_basis_identity): our recursion real SH
    equal e3nn's evaluated at the cyclically permuted argument —
    Y_e3nn(v[[1,2,0]]) == Y_ours(v) for every l — and reference QHNet
    feeds exactly that permutation to o3.spherical_harmonics
    (qhnet.py:267: `edge_vec[:, [1, 2, 0]]`). So reference QHNet
    features live in OUR basis verbatim: no transport anywhere, and
    every e3nn wigner-3j is elementwise proportional to our
    `so3.real_cg` (`w3j_cg_ratio` below gives the per-path ratio
    μ = ±1/sqrt(2·l3+1)).

  * `TPSpec`: e3nn TensorProduct bookkeeping for the three instruction
    sets QHNet builds via `get_feasible_irrep` (layers.py:44-84): the
    parity-filtered uvu conv set, the 0e-input layer-0 set, and the
    all-even uuu self/pair set — with each instruction's effective
    scale = e3nn normalization coefficient (irrep_normalization=
    "component", path_normalization="element") times the reference's
    explicit path weight sqrt(dim_l3 / n_instructions).

  * `ssp_norm_const()`: e3nn.math.normalize2mom for ShiftedSoftPlus —
    FullyConnectedNet multiplies hidden activations by this constant.

Reconstruction caveat (documented, unverifiable offline): e3nn's
wigner_3j Frobenius scale (taken = 1) and the FullyConnectedNet layer
scaling (taken = W/sqrt(fan_in) per layer, no biases) follow e3nn
0.5.x source; they are shared by the converter and the golden test, so
the test pins the converter mapping, not these two constants.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, NamedTuple, Tuple

import numpy as np

from nabladft_tpu_torch.ops import so3


@lru_cache(maxsize=None)
def e3nn_change_basis_real_to_complex(l: int) -> np.ndarray:
    """e3nn _wigner.change_basis_real_to_complex: q[m_complex, m_real]."""
    q = np.zeros((2 * l + 1, 2 * l + 1), complex)
    for m in range(-l, 0):
        q[l + m, l + abs(m)] = 1 / math.sqrt(2)
        q[l + m, l - abs(m)] = -1j / math.sqrt(2)
    q[l, l] = 1.0
    for m in range(1, l + 1):
        q[l + m, l + abs(m)] = (-1) ** m / math.sqrt(2)
        q[l + m, l - abs(m)] = 1j * (-1) ** m / math.sqrt(2)
    return (-1j) ** l * q


@lru_cache(maxsize=None)
def e3nn_w3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """o3.wigner_3j(l1, l2, l3): real, Frobenius norm 1."""
    c = so3.complex_cg(l1, l2, l3).astype(complex)
    q1 = e3nn_change_basis_real_to_complex(l1)
    q2 = e3nn_change_basis_real_to_complex(l2)
    q3 = e3nn_change_basis_real_to_complex(l3)
    w = np.einsum("im,kn,jo,ikj->mno", q1, q2, np.conj(q3), c)
    assert np.abs(w.imag).max() < 1e-10, (l1, l2, l3)
    w = np.ascontiguousarray(w.real)
    return w / np.linalg.norm(w)


@lru_cache(maxsize=None)
def w3j_cg_ratio(l1: int, l2: int, l3: int) -> float:
    """μ with e3nn_w3j == μ · so3.real_cg, elementwise (μ = ±1/sqrt(2l3+1);
    both are intertwiners of the same real irreps, so the ratio is exact)."""
    w = e3nn_w3j(l1, l2, l3)
    cg = so3.real_cg(l1, l2, l3)
    nz = np.abs(cg) > 1e-12
    r = w[nz] / cg[nz]
    mu = float(r.mean())
    if np.abs(r - mu).max() > 1e-9 or (np.abs(w[~nz]).max() if (~nz).any() else 0) > 1e-12:
        raise AssertionError(f"w3j not proportional to real_cg at {(l1, l2, l3)}")
    return mu


@lru_cache(maxsize=None)
def cg_swap_sign(l1: int, l2: int, l3: int) -> float:
    """σ with real_cg(l2,l1,l3)[b,a,m] == σ · real_cg(l1,l2,l3)[a,b,m]
    (= (-1)^(l1+l2+l3); measured, not assumed)."""
    a = so3.real_cg(l1, l2, l3)
    b = np.transpose(so3.real_cg(l2, l1, l3), (1, 0, 2))
    nz = np.abs(a) > 1e-12
    r = b[nz] / a[nz]
    s = float(r.mean())
    assert np.abs(r - s).max() < 1e-9, (l1, l2, l3)
    return s


class TPSpec(NamedTuple):
    """One e3nn TensorProduct built by the reference's get_feasible_irrep.

    paths:  [(l1, l2, l3)] in instruction order (= our `_tp_paths` order
            restricted to this set).
    coeff:  per-instruction effective scale the e3nn TP multiplies into
            w ⊙ (x1 ⊗_w3j x2): sqrt(component_alpha / element_fan ·
            reference_path_weight).
    """

    paths: Tuple[Tuple[int, int, int], ...]
    coeff: Tuple[float, ...]


def _coeffs(paths: List[Tuple[int, int, int]]) -> List[float]:
    # e3nn TensorProduct normalization (irrep_normalization="component",
    # path_normalization="element"; num_elements("uvu"|"uuu") = 1 here
    # since the sh multiplicity is 1 / uuu is per-channel) times the
    # reference's explicit path weight sqrt(dim_l3/n_total)
    # (layers.py:59-77).
    n_total = len(paths)
    out = []
    for (_, _, l3) in paths:
        dim = 2 * l3 + 1
        n_same = sum(1 for p in paths if p[2] == l3)
        pw = math.sqrt(dim / n_total)
        out.append(math.sqrt(dim / n_same * pw))
    return out


@lru_cache(maxsize=None)
def qhnet_conv_tp(l_max: int = 4, layer0: bool = False) -> TPSpec:
    """ConvLayer tp_node (layers.py:185-195): uvu over (features ⊗ sh) with
    the alternating-parity hidden irreps — only l1+l2+l3-even paths
    survive the `ir_out in cutoff_irrep_out` filter. Layer 0's input is
    128x0e only (qhnet.py:75), so just the (0, l, l) column."""
    paths = []
    for l1 in range(l_max + 1):
        if layer0 and l1 != 0:
            continue
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                if (l1 + l2 + l3) % 2 == 0:
                    paths.append((l1, l2, l3))
    return TPSpec(tuple(paths), tuple(_coeffs(paths)))


@lru_cache(maxsize=None)
def qhnet_uuu_tp(l_max: int = 4) -> TPSpec:
    """SelfNetLayer.tp / PairNetLayer.tp_node_pair: uuu over the all-even
    (`hidden_irrep_base`) irreps — every (l1,l2,l3≤l_max) path survives
    (parities all +), matching our full `_tp_paths` set."""
    paths = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                paths.append((l1, l2, l3))
    return TPSpec(tuple(paths), tuple(_coeffs(paths)))


@lru_cache(maxsize=None)
def ssp_norm_const() -> float:
    """e3nn.math.normalize2mom constant for ShiftedSoftPlus: c with
    E[(c·ssp(x))²] = 1 under x ~ N(0,1) (Gauss-Hermite quadrature)."""
    x, w = np.polynomial.hermite_e.hermegauss(201)
    ssp = np.logaddexp(0.0, x) - math.log(2.0)
    m2 = (w * ssp**2).sum() / math.sqrt(2 * math.pi)
    return float(1.0 / math.sqrt(m2))


def expansion_instructions(mults: Tuple[int, int, int], cb: int,
                           l_in_max: int = 4):
    """Reference Expansion.get_expansion_path order (layers.py:648-655):
    l_in outer, then (lo1, lo2); yields (l_in, lo1, lo2, mul1, mul2,
    w_offset, b_offset) with flat offsets into the reference's
    fc_ii/fc_ij weight (and bias) vectors."""
    out = []
    w_off, b_off = 0, 0
    for l_in in range(l_in_max + 1):
        for lo1, mul1 in enumerate(mults):
            for lo2, mul2 in enumerate(mults):
                if abs(lo1 - lo2) <= l_in <= lo1 + lo2:
                    out.append((l_in, lo1, lo2, mul1, mul2, w_off, b_off))
                    w_off += cb * mul1 * mul2
                    if l_in == 0:
                        b_off += mul1 * mul2
    return out, w_off, b_off
