"""Fused QHNet tensor products: CUDA kernels I (conv forward), J (conv
backward), K (pair forward) and L (pair backward).

The port of ``nabladft_tpu/ops/pallas/qhnet_tp.py``: `conv_tp` (a
`jax.custom_vjp` over `_conv_fwd_kernel` / `_conv_bwd_kernel`) and `pair_tp`
(over `_pair_fwd_kernel` / `_pair_bwd_kernel`). Per molecule b and receiver i
the ops form the path weights of the gate MLPs' second Dense,

  u_r = h_r @ W2r + b2r      u_s = h_s @ W2s + b2s      w = u_r ⊙ u_s   [A, P·C]

and contract it with the tensor products:

  conv: agg[i, l3²+m, c] = Σ_j Σ_p Σ_a cgsh[i, j, off_p + a·(2l3+1) + m]
                                       · x[l1²+a, j, c] · w[j, p·C + c]
  pair: fij[i, l3²+m, j, c] = Σ_p w_p[j, c] · maskf[i, j]
                               · Σ_b zi[i, off_p + b·(2l3+1) + m, c] · x[l2²+b, j, c]

over the P = 65 paths (l1, l2, l3) of `tp_paths` (LMAX = 4). `cgsh` is the
radius-graph-masked table sh_adj @ `cgsh_matrix()` and `zi` = node @
`cgz_matrix()` the receiver-side contraction, both formed outside.

Layouts (as the JAX op): x [B,S,A,C] (S = (L+1)², the flat SH index l²+m);
cgsh [B,A,A,K]; zi [B,A,Kz,C]; maskf [B,A,A,1]; h_r [B,A,A,H1], h_s
[B,A,A,H2]; W2r [H1,P·C], W2s [H2,P·C], b2r, b2s [P·C]; conv out [B,A,S,C];
pair out [B,A,S,A,C]. All float32.

The VJPs keep the JAX contracts: `cgsh` and `maskf` get no cotangent (QHNet
never differentiates positions); `pair_tp` returns both gx and gzi, so the
caller's autograd adds the receiver-side node gradient through zi. Each
kernel has a plain PyTorch version here that takes `lmax`; a wrapper takes
it only for CPU tensors, and a CUDA tensor launches the kernel (sources in
``csrc/qhnet_tp.cu``) or raises.

All four kernels run over the live pairs only (cgsh row, or maskf, not
zero) and put the gate's dense products on the tensor cores through the
SO(2) product engine (3xTF32, fp32-accurate): I and K form w = u_r ⊙ u_s
of the live pairs in one array (u_r, then u_s multiplied into it in place),
which their tensor-product stage reads; J and L form u and, after their
stage, gh = gu @ W2ᵀ and [gW2; gb2] = [h, 1]ᵀ gu. `conv_fwd_staged` /
`pair_fwd_staged` and `conv_bwd_staged` / `pair_bwd_staged` are those
decompositions on plain tensors, held against the JAX ops and VJPs in the
CPU tests. The wrappers pad H1, H2 and P·C with zeros to multiples of 8.
"""

from __future__ import annotations

import ctypes
import functools
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch

from nabladft_tpu_torch.ops import _kernels, so3

LMAX = 4
S = (LMAX + 1) ** 2  # 25

# launches of each CUDA kernel wrapper since the last reset
LAUNCHES: Dict[str, int] = {"qhnet_conv_fwd": 0, "qhnet_conv_bwd": 0, "qhnet_pair_fwd": 0,
                            "qhnet_pair_bwd": 0}
# L's gx stage (csrc/qhnet_tp.cu `gx_chunks`): senders per thread, and the
# blocks per multiprocessor (of 132) that the receiver chunks aim at
GX_SENDERS, GX_WAVES, SMS = 8, 16, 132


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# path layouts (the JAX package's, exactly)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def tp_paths(lmax: int = LMAX) -> Tuple[Tuple[int, int, int], ...]:
    """(l1, l2, l3) triples in the order of models.qhnet._tp_paths."""
    paths = []
    for l1 in range(lmax + 1):
        for l2 in range(lmax + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, lmax) + 1):
                paths.append((l1, l2, l3))
    return tuple(paths)


@lru_cache(maxsize=None)
def _cg_layout(lmax: int = LMAX):
    """Column offsets of the cgsh table: col(p, a, m) = off[p] + a·(2l3+1) + m."""
    off, offs = 0, []
    for (l1, _, l3) in tp_paths(lmax):
        offs.append(off)
        off += (2 * l1 + 1) * (2 * l3 + 1)
    return offs, off


@lru_cache(maxsize=None)
def _zi_layout(lmax: int = LMAX):
    """Row offsets of the zi table: row(p, b, m) = off[p] + b·(2l3+1) + m."""
    off, offs = 0, []
    for (_, l2, l3) in tp_paths(lmax):
        offs.append(off)
        off += (2 * l2 + 1) * (2 * l3 + 1)
    return offs, off


@lru_cache(maxsize=None)
def cgsh_matrix(lmax: int = LMAX) -> np.ndarray:
    """CGSH [S, K_pad] (float32) with cgsh = sh @ CGSH."""
    offs, k_tot = _cg_layout(lmax)
    out = np.zeros(((lmax + 1) ** 2, _round_up(k_tot, 128)), np.float32)
    for p, (l1, l2, l3) in enumerate(tp_paths(lmax)):
        cg = so3.real_cg(l1, l2, l3)
        for a in range(2 * l1 + 1):
            for b in range(2 * l2 + 1):
                for m in range(2 * l3 + 1):
                    out[l2 * l2 + b, offs[p] + a * (2 * l3 + 1) + m] = cg[a, b, m]
    return out


@lru_cache(maxsize=None)
def cgz_matrix(lmax: int = LMAX) -> np.ndarray:
    """CGZ [S, Kz_pad] (float32) with zi[..., row(p,b,m), c] = Σ_a node[..., l1²+a, c]·CGZ[l1²+a, row]."""
    offs, k_tot = _zi_layout(lmax)
    out = np.zeros(((lmax + 1) ** 2, _round_up(k_tot, 128)), np.float32)
    for p, (l1, l2, l3) in enumerate(tp_paths(lmax)):
        cg = so3.real_cg(l1, l2, l3)
        for a in range(2 * l1 + 1):
            for b in range(2 * l2 + 1):
                for m in range(2 * l3 + 1):
                    out[l1 * l1 + a, offs[p] + b * (2 * l3 + 1) + m] = cg[a, b, m]
    return out


# ---------------------------------------------------------------------------
# the JAX package's analytic FLOP models
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _path_mults(lmax: int) -> Tuple[int, int, int]:
    """(MACS, SUM_M3, P): Σ(2l1+1)(2l3+1), Σ(2l3+1), path count."""
    paths = tp_paths(lmax)
    macs = sum((2 * l1 + 1) * (2 * l3 + 1) for l1, _, l3 in paths)
    summ3 = sum(2 * l3 + 1 for _, _, l3 in paths)
    return macs, summ3, len(paths)


def conv_fwd_flops(b, a, c, h1, h2, lmax=LMAX) -> int:
    macs, summ3, p = _path_mults(lmax)
    pc = p * c
    return int(b * a * (2 * a * pc * (h1 + h2) + 2 * a * c * (macs + 2 * summ3 + p)))


def conv_bwd_flops(b, a, c, h1, h2, lmax=LMAX) -> int:
    macs, summ3, p = _path_mults(lmax)
    pc = p * c
    per_prog = (2 * a * pc * (h1 + h2) + 2 * a * c * (2 * macs + 3 * summ3 + 3 * p)
                + 2 * a * pc * (h1 + h2) + 2 * a * pc * (h1 + h2) + 4 * a * pc)
    return int(b * a * per_prog)


def _macs_z(lmax: int) -> int:
    return sum((2 * l2 + 1) * (2 * l3 + 1) for _, l2, l3 in tp_paths(lmax))


def pair_fwd_flops(b, a, c, h1, h2, lmax=LMAX) -> int:
    _, summ3, p = _path_mults(lmax)
    pc = p * c
    return int(b * a * (2 * a * pc * (h1 + h2) + 2 * a * c * (_macs_z(lmax) + summ3 + 2 * p)))


def pair_bwd_flops(b, a, c, h1, h2, lmax=LMAX) -> int:
    _, summ3, p = _path_mults(lmax)
    pc = p * c
    per_prog = (2 * a * pc * (h1 + h2) + 2 * a * c * (3 * _macs_z(lmax) + 2 * summ3 + 3 * p)
                + 4 * a * pc * (h1 + h2) + 6 * a * pc)
    return int(b * a * per_prog)


def flops_split(kind: str, b, a, c, h1, h2, lmax=LMAX) -> Tuple[int, int]:
    """The FLOP model of kernel `kind` ("I", "J", "K" or "L") as (gate
    products, the rest): the gate's second Dense u = h @ W2 (I, K), and in
    the backward also gh = gu @ W2ᵀ and gW2 = hᵀ @ gu (J, L), each
    2·(B·A²)·P·C·(H1+H2), all on the tensor cores in I-L; the rest is the
    tensor products, the gate multiplies and the bias sums, which stay on
    the CUDA cores."""
    _, _, p = _path_mults(lmax)
    gate = 2 * b * a * a * p * c * (h1 + h2)
    n_prod = 1 if kind in "IK" else 3
    total = {"I": conv_fwd_flops, "J": conv_bwd_flops, "K": pair_fwd_flops,
             "L": pair_bwd_flops}[kind](b, a, c, h1, h2, lmax)
    return n_prod * gate, total - n_prod * gate


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _gate(hr, hs, w2r, b2r, w2s, b2s, p: int, c: int) -> torch.Tensor:
    """w_p = (h_r @ W2r + b2r)[p·C:(p+1)·C] ⊙ (h_s @ W2s + b2s)[...]: [B,A,A,C]."""
    sl = slice(p * c, (p + 1) * c)
    return (hr @ w2r[:, sl] + b2r[sl]) * (hs @ w2s[:, sl] + b2s[sl])


def conv_fwd_reference(x, cgsh, hr, hs, w2r, b2r, w2s, b2s, lmax: int = LMAX) -> torch.Tensor:
    """Plain PyTorch version of kernel I: agg [B,A,S,C]."""
    b, s, a, c = x.shape
    offs, _ = _cg_layout(lmax)
    acc: List = [None] * (lmax + 1)
    for p, (l1, _, l3) in enumerate(tp_paths(lmax)):
        n1, m3 = 2 * l1 + 1, 2 * l3 + 1
        cg = cgsh[..., offs[p]:offs[p] + n1 * m3].reshape(b, a, a, n1, m3)
        t = torch.einsum("bijam,bajc->bijmc", cg, x[:, l1 * l1:l1 * l1 + n1])
        term = torch.einsum("bijmc,bijc->bimc", t, _gate(hr, hs, w2r, b2r, w2s, b2s, p, c))
        acc[l3] = term if acc[l3] is None else acc[l3] + term
    return torch.cat(acc, dim=2)


def pair_fwd_reference(x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s,
                       lmax: int = LMAX) -> torch.Tensor:
    """Plain PyTorch version of kernel K: fij [B,A,S,A,C]."""
    b, s, a, c = x.shape
    offs, _ = _zi_layout(lmax)
    acc: List = [None] * (lmax + 1)
    for p, (_, l2, l3) in enumerate(tp_paths(lmax)):
        n2, m3 = 2 * l2 + 1, 2 * l3 + 1
        w = _gate(hr, hs, w2r, b2r, w2s, b2s, p, c) * maskf
        z = zi[:, :, offs[p]:offs[p] + n2 * m3].reshape(b, a, n2, m3, c)
        t = torch.einsum("binmc,bnjc->bimjc", z, x[:, l2 * l2:l2 * l2 + n2])
        term = t * w[:, :, None]
        acc[l3] = term if acc[l3] is None else acc[l3] + term
    return torch.cat(acc, dim=2)


def _vjp(fn, primals, diff, g, lmax):
    """Cotangents of fn(*primals, lmax) along g for the primals flagged in `diff`."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(d) for t, d in zip(primals, diff)]
        out = fn(*ins, lmax=lmax)
        grads = torch.autograd.grad(out, [t for t, d in zip(ins, diff) if d], g)
    return tuple(t.detach() for t in grads)


def conv_bwd_reference(x, cgsh, hr, hs, w2r, b2r, w2s, b2s, g, lmax: int = LMAX):
    """Plain PyTorch version of kernel J (autograd of kernel I's plain
    version): (gx, ghr, ghs, gw2r, gb2r, gw2s, gb2s); cgsh gets none."""
    return _vjp(conv_fwd_reference, (x, cgsh, hr, hs, w2r, b2r, w2s, b2s),
                (True, False, True, True, True, True, True, True), g, lmax)


def pair_bwd_reference(x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s, g, lmax: int = LMAX):
    """Plain PyTorch version of kernel L (autograd of kernel K's plain
    version): (gx, gzi, ghr, ghs, gw2r, gb2r, gw2s, gb2s); maskf gets none."""
    return _vjp(pair_fwd_reference, (x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s),
                (True, True, False, True, True, True, True, True, True), g, lmax)


def gx_chunks(b: int, a: int) -> int:
    """Receiver chunks of L's gx stage (`gx_chunks` in csrc/qhnet_tp.cu): the
    fewest receivers a chunk that still give B·chunks·⌈A/GX_SENDERS⌉ blocks
    of about GX_WAVES per SM, no chunk empty."""
    tiles = -(-a // GX_SENDERS)
    per = max(1, -(-a * b * tiles // (GX_WAVES * SMS)))
    return -(-a // per)


def _live_rows(flags: torch.Tensor) -> torch.Tensor:
    """The live pair slots b·A² + i·A + j in slot order (the card's `live_rows` list)."""
    return torch.nonzero(flags.reshape(-1)).flatten()


def _gate_weights_staged(e, hr, hs, w2r, b2r, w2s, b2s) -> torch.Tensor:
    """w = u_r ⊙ u_s over the live rows e in one array, as I and K form it:
    u_r = h_r @ W2r + b2r first, then u_s + b2s multiplied into it in place."""
    w = hr.reshape(-1, hr.shape[-1])[e] @ w2r + b2r
    w *= hs.reshape(-1, hs.shape[-1])[e] @ w2s + b2s
    return w


def _by_l3(lmax: int):
    """The paths' (index, l1, l2, l3) by l3 group, heaviest group (largest
    l3) first, in path order within a group: the order of I's and K's
    tensor-product stages."""
    paths = list(enumerate(tp_paths(lmax)))
    return [[(p, *t) for p, t in paths if t[2] == l3] for l3 in range(lmax, -1, -1)]


def conv_fwd_staged(x, cgsh, hr, hs, w2r, b2r, w2s, b2s, lmax: int = LMAX) -> torch.Tensor:
    """Kernel I's stages in the card's order, on plain tensors: the live
    pairs (cgsh row not zero); w = u_r ⊙ u_s over them in one array (the
    gate products); the tensor-product stage by l3 group, path by path:
    agg[i, l3²+m] += Σ_a cg[a, m]·(w·x_j[l1²+a]) over i's live senders j. A
    receiver with no live pair gets zeros. Returns conv_fwd_reference's agg."""
    b, s, a, c = x.shape
    offs, used = _cg_layout(lmax)
    rows = cgsh.reshape(b * a * a, -1)
    e = _live_rows((rows[:, :used] != 0).any(1))
    bi, j = e // a, e % a  # bi = b·A + i
    w = _gate_weights_staged(e, hr, hs, w2r, b2r, w2s, b2s)
    xq = x.permute(0, 2, 1, 3).reshape(b * a, s, c)[bi // a * a + j]  # the sender's features
    agg = x.new_zeros(b * a, s, c)
    for group in _by_l3(lmax):
        for p, l1, _, l3 in group:
            n1, m3, sl = 2 * l1 + 1, 2 * l3 + 1, slice(p * c, (p + 1) * c)
            cg = rows[e, offs[p]:offs[p] + n1 * m3].reshape(-1, n1, m3)
            xw = xq[:, l1 * l1:l1 * l1 + n1] * w[:, None, sl]
            agg[:, l3 * l3:l3 * l3 + m3].index_add_(0, bi, torch.einsum("eam,eac->emc", cg, xw))
    return agg.reshape(b, a, s, c)


def pair_fwd_staged(x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s, lmax: int = LMAX) -> torch.Tensor:
    """Kernel K's stages in the card's order, on plain tensors: the live
    pairs (maskf not zero); w = u_r ⊙ u_s over them in one array; the
    tensor-product stage by l3 group, path by path: fij[i, l3²+m, j] +=
    Σ_b zi[i, (b, m)]·(x_j[l2²+b]·w·maskf) over the live pairs. The dead
    pairs' slots hold zeros. Returns pair_fwd_reference's fij."""
    b, s, a, c = x.shape
    kz = zi.shape[2]
    offs, _ = _zi_layout(lmax)
    e = _live_rows(maskf != 0)
    bi, j = e // a, e % a
    wm = _gate_weights_staged(e, hr, hs, w2r, b2r, w2s, b2s) * maskf.reshape(-1)[e][:, None]
    zq = zi.reshape(b * a, kz, c)[bi]
    xq = x.permute(0, 2, 1, 3).reshape(b * a, s, c)[bi // a * a + j]
    fq = x.new_zeros(e.numel(), s, c)  # fij[b, i, :, j] of each live pair
    for group in _by_l3(lmax):
        for p, _, l2, l3 in group:
            n2, m3, sl = 2 * l2 + 1, 2 * l3 + 1, slice(p * c, (p + 1) * c)
            z = zq[:, offs[p]:offs[p] + n2 * m3].reshape(-1, n2, m3, c)
            xw = xq[:, l2 * l2:l2 * l2 + n2] * wm[:, None, sl]
            fq[:, l3 * l3:l3 * l3 + m3] += torch.einsum("enmc,enc->emc", z, xw)
    fij = x.new_zeros(b * a * a, s, c)
    fij[e] = fq
    return fij.reshape(b, a, a, s, c).permute(0, 1, 3, 2, 4).contiguous()


def _gate_grads_staged(e, hr, hs, w2r, w2s, gur, gus):
    """The gradient products of J and L over the live rows e: gh = gu @ W2ᵀ
    (zeros off the live rows) and [gW2; gb2] = [h, 1]ᵀ gu."""
    hr2, hs2 = hr.reshape(-1, hr.shape[-1]), hs.reshape(-1, hs.shape[-1])
    ghr, ghs = torch.zeros_like(hr2), torch.zeros_like(hs2)
    ghr[e], ghs[e] = gur @ w2r.T, gus @ w2s.T
    return (ghr.reshape(hr.shape), ghs.reshape(hs.shape), hr2[e].T @ gur, gur.sum(0),
            hs2[e].T @ gus, gus.sum(0))


def conv_bwd_staged(x, cgsh, hr, hs, w2r, b2r, w2s, b2s, g, lmax: int = LMAX):
    """Kernel J's stages in the card's order, on plain tensors: the live
    pairs (cgsh row not zero); u = h @ W2 + b2 over them (the gate
    products); the tensor-product stage, per sender j: gx, and gu_r = gw·u_s,
    gu_s = gw·u_r in place of u; then the gradient products. Returns
    conv_bwd_reference's tuple."""
    b, s, a, c = x.shape
    offs, used = _cg_layout(lmax)
    rows = cgsh.reshape(b * a * a, -1)
    e = _live_rows((rows[:, :used] != 0).any(1))
    bi, j = e // a, e % a  # bi = b·A + i
    sender = bi // a * a + j
    ur = hr.reshape(b * a * a, -1)[e] @ w2r + b2r
    us = hs.reshape(b * a * a, -1)[e] @ w2s + b2s
    gq = g.reshape(b * a, s, c)[bi]  # the receiver's cotangent, per live pair
    xq = x.permute(0, 2, 1, 3).reshape(b * a, s, c)[sender]  # the sender's features
    gxj = x.new_zeros(b * a, s, c)
    for p, (l1, _, l3) in enumerate(tp_paths(lmax)):
        n1, m3, sl = 2 * l1 + 1, 2 * l3 + 1, slice(p * c, (p + 1) * c)
        cg = rows[e, offs[p]:offs[p] + n1 * m3].reshape(-1, n1, m3)
        gm = gq[:, l3 * l3:l3 * l3 + m3]
        gw = (torch.einsum("eam,eac->emc", cg, xq[:, l1 * l1:l1 * l1 + n1]) * gm).sum(1)
        gxa = torch.einsum("eam,emc->eac", cg, gm) * (ur[:, sl] * us[:, sl])[:, None]
        gxj[:, l1 * l1:l1 * l1 + n1].index_add_(0, sender, gxa)
        ur[:, sl], us[:, sl] = gw * us[:, sl], gw * ur[:, sl]
    gx = gxj.reshape(b, a, s, c).permute(0, 2, 1, 3).contiguous()
    return (gx, *_gate_grads_staged(e, hr, hs, w2r, w2s, ur, us))


def pair_bwd_staged(x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s, g, lmax: int = LMAX,
                    chunks: int = 0):
    """Kernel L's stages in the card's order, on plain tensors: the live
    pairs (maskf not zero); u = h @ W2 + b2 over them; gx as `chunks`
    (default `gx_chunks`) partial sums over receiver chunks, added in chunk
    order; the tensor-product stage, per receiver i: gzi, and gu_r =
    gw·u_s·maskf, gu_s = gw·u_r·maskf in place of u; then the gradient
    products. Returns pair_bwd_reference's tuple."""
    b, s, a, c = x.shape
    kz = zi.shape[2]
    offs, _ = _zi_layout(lmax)
    paths = tp_paths(lmax)
    e = _live_rows(maskf != 0)
    bi, j = e // a, e % a
    i, sender = bi % a, bi // a * a + j
    mf = maskf.reshape(-1)[e][:, None]
    ur = hr.reshape(b * a * a, -1)[e] @ w2r + b2r
    us = hs.reshape(b * a * a, -1)[e] @ w2s + b2s
    zq = zi.reshape(b * a, kz, c)[bi]
    gq = g.permute(0, 1, 3, 2, 4).reshape(b * a * a, s, c)[e]  # g[b, i, :, j]
    xq = x.permute(0, 2, 1, 3).reshape(b * a, s, c)[sender]

    n_ch = chunks or gx_chunks(b, a)
    per = -(-a // n_ch)
    gx = None
    for ch in range(n_ch):
        sel = (i >= ch * per) & (i < (ch + 1) * per)
        part = x.new_zeros(b * a, s, c)
        for p, (_, l2, l3) in enumerate(paths):
            n2, m3, sl = 2 * l2 + 1, 2 * l3 + 1, slice(p * c, (p + 1) * c)
            w = ur[sel, sl] * us[sel, sl] * mf[sel]
            z = zq[sel, offs[p]:offs[p] + n2 * m3].reshape(-1, n2, m3, c)
            wg = gq[sel, l3 * l3:l3 * l3 + m3] * w[:, None]
            part[:, l2 * l2:l2 * l2 + n2].index_add_(0, sender[sel],
                                                     torch.einsum("enmc,emc->enc", z, wg))
        gx = part if gx is None else gx + part

    gzi = x.new_zeros(b * a, kz, c)
    for p, (_, l2, l3) in enumerate(paths):
        n2, m3, sl = 2 * l2 + 1, 2 * l3 + 1, slice(p * c, (p + 1) * c)
        z = zq[:, offs[p]:offs[p] + n2 * m3].reshape(-1, n2, m3, c)
        xb, gm = xq[:, l2 * l2:l2 * l2 + n2], gq[:, l3 * l3:l3 * l3 + m3]
        gw = (torch.einsum("enmc,enc->emc", z, xb) * gm).sum(1)
        gt = gm * (ur[:, sl] * us[:, sl] * mf)[:, None]
        gzi[:, offs[p]:offs[p] + n2 * m3].index_add_(
            0, bi, torch.einsum("emc,enc->enmc", gt, xb).reshape(-1, n2 * m3, c))
        ur[:, sl], us[:, sl] = gw * us[:, sl] * mf, gw * ur[:, sl] * mf
    gx = gx.reshape(b, a, s, c).permute(0, 2, 1, 3).contiguous()
    return (gx, gzi.reshape(b, a, kz, c), *_gate_grads_staged(e, hr, hs, w2r, w2s, ur, us))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load("qhnet_tp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qhnet_fwd_scratch_floats.argtypes = [i] * 6
    lib.qhnet_fwd_scratch_floats.restype = ctypes.c_longlong
    lib.qhnet_fwd_scratch_ints.argtypes = [i, i]
    lib.qhnet_fwd_scratch_ints.restype = ctypes.c_longlong
    lib.qhnet_bwd_scratch_floats.argtypes = [i] * 7
    lib.qhnet_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.qhnet_bwd_scratch_ints.argtypes = [i, i]
    lib.qhnet_bwd_scratch_ints.restype = ctypes.c_longlong
    lib.qhnet_conv_fwd.argtypes = [p] * 11 + [i] * 7 + [p]
    lib.qhnet_conv_fwd.restype = i
    lib.qhnet_conv_bwd.argtypes = [p] * 16 + [i] * 7 + [p]
    lib.qhnet_conv_bwd.restype = i
    lib.qhnet_pair_fwd.argtypes = [p] * 12 + [i] * 7 + [p]
    lib.qhnet_pair_fwd.restype = i
    lib.qhnet_pair_bwd.argtypes = [p] * 18 + [i] * 7 + [p]
    lib.qhnet_pair_bwd.restype = i
    return lib


def _launch(name: str, *args) -> None:
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_lib(), name)(*ptrs, stream)
    _kernels.raise_on_error(err, f"{name} launch")


def _dims(x, w2r, w2s, lmax):
    b, s, a, c = x.shape
    h1, pc = w2r.shape
    h2 = w2s.shape[0]
    n_paths = len(tp_paths(lmax))
    if s != (lmax + 1) ** 2 or pc != n_paths * c:
        raise ValueError(f"x {tuple(x.shape)} and W2r {tuple(w2r.shape)} do not fit lmax={lmax}")
    if lmax > LMAX:
        raise ValueError(f"the kernels take lmax <= {LMAX}, got {lmax}")
    return b, s, a, c, h1, h2, pc


def _shapes(b, s, a, c, h1, h2, pc, k=None, kz=None) -> Dict[str, tuple]:
    return dict(x=(b, s, a, c), cgsh=(b, a, a, k), zi=(b, a, kz, c), maskf=(b, a, a, 1),
                hr=(b, a, a, h1), hs=(b, a, a, h2), w2r=(h1, pc), b2r=(pc,), w2s=(h2, pc),
                b2s=(pc,), g_conv=(b, a, s, c), g_pair=(b, a, s, a, c))


def _check_table(name: str, t: torch.Tensor, used: int) -> int:
    if t.ndim != 4 or t.shape[-2 if name == "zi" else -1] < used:
        raise ValueError(f"{name} {tuple(t.shape)} lacks the {used} rows of the path layout")
    return t.shape[-2 if name == "zi" else -1]


def qhnet_conv_fwd(x, cgsh, hr, hs, w2r, b2r, w2s, b2s, lmax: int = LMAX) -> torch.Tensor:
    """Kernel I: agg [B,A,S,C]."""
    dims = _dims(x, w2r, w2s, lmax)
    k = _check_table("cgsh", cgsh, _cg_layout(lmax)[1])
    args = dict(x=x, cgsh=cgsh, hr=hr, hs=hs, w2r=w2r, b2r=b2r, w2s=w2s, b2s=b2s)
    dev = _kernels.check_inputs(args, _shapes(*dims, k=k))
    if dev.type == "cpu":
        return conv_fwd_reference(*args.values(), lmax=lmax)
    b, s, a, c, *_ = dims
    gates = _padded_gates(hr, hs, w2r, b2r, w2s, b2s)
    out = torch.empty((b, a, s, c), dtype=torch.float32, device=dev)
    _launch("qhnet_conv_fwd", x, cgsh, *gates, out, *_fwd_scratch(dev, b, a, c, gates, lmax), b,
            a, c, gates[0].shape[-1], gates[1].shape[-1], k, lmax)
    LAUNCHES["qhnet_conv_fwd"] += 1
    _kernels.count_flops(lambda: _work("I", x, cgsh, hr, hs, cgsh, lmax))
    return out


def _padded_gates(hr, hs, w2r, b2r, w2s, b2s):
    """The kernels' gate operands: H1, H2 and P·C padded by zeros to
    multiples of 8 (the tensor-core products take K a multiple of 8); the
    inputs themselves when nothing needs padding, as on QHNet's path."""
    pc = w2r.shape[1]
    pcp = _round_up(pc, 8)

    def pad(h, w2, b2):
        hp = _round_up(h.shape[-1], 8)
        if hp == h.shape[-1] and pcp == pc:
            return h, w2, b2
        f = torch.nn.functional.pad
        return (f(h, (0, hp - h.shape[-1])).contiguous(),
                f(w2, (0, pcp - pc, 0, hp - w2.shape[0])).contiguous(), f(b2, (0, pcp - pc)))

    (hr, w2r, b2r), (hs, w2s, b2s) = pad(hr, w2r, b2r), pad(hs, w2s, b2s)
    return hr, hs, w2r, b2r, w2s, b2s


def _fwd_scratch(dev, b, a, c, gates, lmax):
    """(float scratch, int scratch) of a forward launch (I, K) on padded `gates`."""
    nf = _lib().qhnet_fwd_scratch_floats(b, a, c, gates[0].shape[-1], gates[1].shape[-1], lmax)
    ni = _lib().qhnet_fwd_scratch_ints(b, a)
    return (torch.empty((nf,), dtype=torch.float32, device=dev),
            torch.empty((ni,), dtype=torch.int32, device=dev))


def _bwd_buffers(dev, pair: bool, b, a, c, gates, lmax):
    """(gh_r, gh_s zeros [B,A,A,H1p/H2p], gwb_r [H1p+1, P·Cp], gwb_s, float
    scratch, int scratch) of a backward launch on padded `gates`."""
    h1p, h2p, pcp = gates[0].shape[-1], gates[1].shape[-1], gates[2].shape[1]
    zeros = functools.partial(torch.zeros, dtype=torch.float32, device=dev)
    empty = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    nf = _lib().qhnet_bwd_scratch_floats(int(pair), b, a, c, h1p, h2p, lmax)
    ni = _lib().qhnet_bwd_scratch_ints(b, a)
    return (zeros((b, a, a, h1p)), zeros((b, a, a, h2p)), empty((h1p + 1, pcp)),
            empty((h2p + 1, pcp)), empty((nf,)), torch.empty((ni,), dtype=torch.int32, device=dev))


def _gate_cotangents(ghr, ghs, gwb_r, gwb_s, h1, h2, pc):
    """(ghr, ghs, gW2r, gb2r, gW2s, gb2s) without the padding."""
    def cut(t):
        return t if t.is_contiguous() else t.contiguous()

    return (cut(ghr[..., :h1]), cut(ghs[..., :h2]), cut(gwb_r[:h1, :pc]),
            cut(gwb_r[gwb_r.shape[0] - 1, :pc]), cut(gwb_s[:h2, :pc]),
            cut(gwb_s[gwb_s.shape[0] - 1, :pc]))


def qhnet_conv_bwd(x, cgsh, hr, hs, w2r, b2r, w2s, b2s, g, lmax: int = LMAX):
    """Kernel J: (gx, ghr, ghs, gw2r, gb2r, gw2s, gb2s)."""
    dims = _dims(x, w2r, w2s, lmax)
    k = _check_table("cgsh", cgsh, _cg_layout(lmax)[1])
    args = dict(x=x, cgsh=cgsh, hr=hr, hs=hs, w2r=w2r, b2r=b2r, w2s=w2s, b2s=b2s, g_conv=g)
    dev = _kernels.check_inputs(args, _shapes(*dims, k=k))
    if dev.type == "cpu":
        return conv_bwd_reference(*args.values(), lmax=lmax)
    b, s, a, c, h1, h2, pc = dims
    gates = _padded_gates(hr, hs, w2r, b2r, w2s, b2s)
    gx = torch.empty((b, s, a, c), dtype=torch.float32, device=dev)
    bufs = _bwd_buffers(dev, False, b, a, c, gates, lmax)
    _launch("qhnet_conv_bwd", x, cgsh, *gates, g, gx, *bufs, b, a, c, gates[0].shape[-1],
            gates[1].shape[-1], k, lmax)
    LAUNCHES["qhnet_conv_bwd"] += 1
    _kernels.count_flops(lambda: _work("J", x, cgsh, hr, hs, cgsh, lmax))
    return (gx, *_gate_cotangents(*bufs[:4], h1, h2, pc))


def qhnet_pair_fwd(x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s, lmax: int = LMAX) -> torch.Tensor:
    """Kernel K: fij [B,A,S,A,C]."""
    dims = _dims(x, w2r, w2s, lmax)
    kz = _check_table("zi", zi, _zi_layout(lmax)[1])
    args = dict(x=x, zi=zi, maskf=maskf, hr=hr, hs=hs, w2r=w2r, b2r=b2r, w2s=w2s, b2s=b2s)
    dev = _kernels.check_inputs(args, _shapes(*dims, kz=kz))
    if dev.type == "cpu":
        return pair_fwd_reference(*args.values(), lmax=lmax)
    b, s, a, c, *_ = dims
    gates = _padded_gates(hr, hs, w2r, b2r, w2s, b2s)
    out = torch.zeros((b, a, s, a, c), dtype=torch.float32, device=dev)  # dead pairs' slots
    _launch("qhnet_pair_fwd", x, zi, maskf, *gates, out, *_fwd_scratch(dev, b, a, c, gates, lmax),
            b, a, c, gates[0].shape[-1], gates[1].shape[-1], kz, lmax)
    LAUNCHES["qhnet_pair_fwd"] += 1
    _kernels.count_flops(lambda: _work("K", x, zi, hr, hs, maskf, lmax))
    return out


def qhnet_pair_bwd(x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s, g, lmax: int = LMAX):
    """Kernel L: (gx, gzi, ghr, ghs, gw2r, gb2r, gw2s, gb2s)."""
    dims = _dims(x, w2r, w2s, lmax)
    kz = _check_table("zi", zi, _zi_layout(lmax)[1])
    args = dict(x=x, zi=zi, maskf=maskf, hr=hr, hs=hs, w2r=w2r, b2r=b2r, w2s=w2s, b2s=b2s,
                g_pair=g)
    dev = _kernels.check_inputs(args, _shapes(*dims, kz=kz))
    if dev.type == "cpu":
        return pair_bwd_reference(*args.values(), lmax=lmax)
    b, s, a, c, h1, h2, pc = dims
    gates = _padded_gates(hr, hs, w2r, b2r, w2s, b2s)
    gx = torch.empty((b, s, a, c), dtype=torch.float32, device=dev)
    gzi = torch.empty((b, a, kz, c), dtype=torch.float32, device=dev)
    bufs = _bwd_buffers(dev, True, b, a, c, gates, lmax)
    _launch("qhnet_pair_bwd", x, zi, maskf, *gates, g, gx, gzi, *bufs, b, a, c,
            gates[0].shape[-1], gates[1].shape[-1], kz, lmax)
    LAUNCHES["qhnet_pair_bwd"] += 1
    _kernels.count_flops(lambda: _work("L", x, zi, hr, hs, maskf, lmax))
    return (gx, gzi, *_gate_cotangents(*bufs[:4], h1, h2, pc))


class QHNetConvFn(torch.autograd.Function):
    """`conv_tp`'s custom VJP: forward = kernel I, backward = kernel J.
    Inputs (x, cgsh, hr, hs, w2r, b2r, w2s, b2s, lmax); cgsh gets no
    gradient."""

    @staticmethod
    def forward(ctx, x, cgsh, hr, hs, w2r, b2r, w2s, b2s, lmax):
        ctx.save_for_backward(x, cgsh, hr, hs, w2r, b2r, w2s, b2s)
        ctx.lmax = lmax
        return qhnet_conv_fwd(x, cgsh, hr, hs, w2r, b2r, w2s, b2s, lmax=lmax)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        gx, ghr, ghs, gw2r, gb2r, gw2s, gb2s = qhnet_conv_bwd(
            *ctx.saved_tensors, g.contiguous(), lmax=ctx.lmax)
        return gx, None, ghr, ghs, gw2r, gb2r, gw2s, gb2s, None


class QHNetPairFn(torch.autograd.Function):
    """`pair_tp`'s custom VJP: forward = kernel K, backward = kernel L.
    Inputs (x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s, lmax); maskf gets no
    gradient, x and zi both get theirs."""

    @staticmethod
    def forward(ctx, x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s, lmax):
        ctx.save_for_backward(x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s)
        ctx.lmax = lmax
        return qhnet_pair_fwd(x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s, lmax=lmax)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        gx, gzi, ghr, ghs, gw2r, gb2r, gw2s, gb2s = qhnet_pair_bwd(
            *ctx.saved_tensors, g.contiguous(), lmax=ctx.lmax)
        return gx, gzi, None, ghr, ghs, gw2r, gb2r, gw2s, gb2s, None


def conv_tp(x, cgsh, hr, hs, w2r, b2r, w2s, b2s, lmax: int = LMAX) -> torch.Tensor:
    """Fused conv-layer tensor product: agg [B,A,S,C]."""
    return QHNetConvFn.apply(x, cgsh, hr, hs, w2r, b2r, w2s, b2s, lmax)


def pair_tp(x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s, lmax: int = LMAX) -> torch.Tensor:
    """Fused pair-layer tensor product: fij [B,A,S,A,C]."""
    return QHNetPairFn.apply(x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s, lmax)


# ---------------------------------------------------------------------------
# work the kernels need on given inputs
# ---------------------------------------------------------------------------


def live_pairs(kind: str, table: torch.Tensor, lmax: int = LMAX) -> int:
    """Pairs whose contribution is not zero: for I and J those whose cgsh row
    (its path columns) is not zero, for K and L those maskf keeps (`table`
    is cgsh or maskf)."""
    if kind in "IJ":
        return int((table[..., :_cg_layout(lmax)[1]] != 0).any(-1).sum())
    return int((table != 0).sum())


def _work(kind: str, x, table, hr, hs, live_of, lmax: int) -> int:
    """Kernel `kind`'s FLOPs on a launch's inputs (`flops_bytes`' "flops_live",
    the live pairs counted in `live_of`: cgsh for I/J, maskf for K/L)."""
    return flops_bytes(kind, x, table, hr, hs, live_pairs(kind, live_of, lmax), lmax)["flops_live"]


def flops_bytes(kind: str, x: torch.Tensor, table: torch.Tensor, hr: torch.Tensor,
                hs: torch.Tensor, live: int, lmax: int = LMAX) -> Dict[str, int]:
    """The work of kernel `kind` ("I", "J", "K" or "L") on these inputs:
    "flops" the JAX package's analytic model over all B·A² pairs,
    "flops_live" the same per pair times the `live` pairs (a dead pair adds
    exact zeros: the bound counts what the data needs), "flops_live_products"
    / "flops_live_other" its split (`flops_split`: the gate products, on the
    tensor cores in I-L, and the rest), and "bytes" with each input read
    once and each output written once (`table` is cgsh for I/J, zi for
    K/L)."""
    b, s, a, c = x.shape
    h1, h2 = hr.shape[-1], hs.shape[-1]
    pc = len(tp_paths(lmax)) * c
    weights = (h1 + h2 + 2) * pc
    conv_out, pair_out = b * a * s * c, b * a * s * a * c
    ins = x.numel() + table.numel() + hr.numel() + hs.numel() + weights
    flops = {"I": conv_fwd_flops, "J": conv_bwd_flops, "K": pair_fwd_flops,
             "L": pair_bwd_flops}[kind](b, a, c, h1, h2, lmax)
    prod, other = flops_split(kind, b, a, c, h1, h2, lmax)
    n = {
        "I": ins + conv_out,
        "J": ins + conv_out + x.numel() + hr.numel() + hs.numel() + weights,
        "K": ins + b * a * a + pair_out,
        "L": (ins + b * a * a + pair_out + x.numel() + table.numel() + hr.numel() + hs.numel()
              + weights),
    }[kind]
    share = live / max(b * a * a, 1)
    return {"flops": flops, "flops_live": int(flops * share),
            "flops_live_products": int(prod * share), "flops_live_other": int(other * share),
            "bytes": 4 * n, "live_pairs": live, "pairs": b * a * a}
