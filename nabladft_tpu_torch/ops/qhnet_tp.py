"""Fused QHNet tensor products: CUDA kernels I (conv forward), J (conv
backward), K (pair forward) and L (pair backward).

The port of ``nabladft_tpu/ops/pallas/qhnet_tp.py``: `conv_tp` (a
`jax.custom_vjp` over `_conv_fwd_kernel` / `_conv_bwd_kernel`) and `pair_tp`
(over `_pair_fwd_kernel` / `_pair_bwd_kernel`). Per molecule b and receiver i
the ops form the path weights of the gate MLPs' second Dense,

  u_r = h_r @ W2r + b2r      u_s = h_s @ W2s + b2s      w = u_r ⊙ u_s   [A, P·C]

and never write w to device memory:

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
# weight-gradient partials per molecule (GW_SPLITS in csrc/qhnet_tp.cu)
GW_SPLITS = 4


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


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load("qhnet_tp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qhnet_gw_splits.argtypes = []
    lib.qhnet_gw_splits.restype = i
    lib.qhnet_conv_fwd.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.qhnet_conv_fwd.restype = i
    lib.qhnet_conv_bwd.argtypes = [p] * 18 + [i] * 7 + [p]
    lib.qhnet_conv_bwd.restype = i
    lib.qhnet_pair_fwd.argtypes = [p] * 10 + [i] * 7 + [p]
    lib.qhnet_pair_fwd.restype = i
    lib.qhnet_pair_bwd.argtypes = [p] * 21 + [i] * 7 + [p]
    lib.qhnet_pair_bwd.restype = i
    if lib.qhnet_gw_splits() != GW_SPLITS:
        raise RuntimeError("csrc/qhnet_tp.cu and ops/qhnet_tp.py disagree on GW_SPLITS")
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
    b, s, a, c, h1, h2, _ = dims
    out = torch.empty((b, a, s, c), dtype=torch.float32, device=dev)
    _launch("qhnet_conv_fwd", *args.values(), out, b, a, c, h1, h2, k, lmax)
    LAUNCHES["qhnet_conv_fwd"] += 1
    return out


def _gw_scratch(dev, b, a, h, pc):
    """(per-pair cotangent gu [B,A,A,P·C], partials [B·splits, H+1, P·C],
    gW over gb [H+1, P·C])."""
    empty = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    return empty((b, a, a, pc)), empty((b * GW_SPLITS, h + 1, pc)), empty((h + 1, pc))


def qhnet_conv_bwd(x, cgsh, hr, hs, w2r, b2r, w2s, b2s, g, lmax: int = LMAX):
    """Kernel J: (gx, ghr, ghs, gw2r, gb2r, gw2s, gb2s)."""
    dims = _dims(x, w2r, w2s, lmax)
    k = _check_table("cgsh", cgsh, _cg_layout(lmax)[1])
    args = dict(x=x, cgsh=cgsh, hr=hr, hs=hs, w2r=w2r, b2r=b2r, w2s=w2s, b2s=b2s, g_conv=g)
    dev = _kernels.check_inputs(args, _shapes(*dims, k=k))
    if dev.type == "cpu":
        return conv_bwd_reference(*args.values(), lmax=lmax)
    b, s, a, c, h1, h2, pc = dims
    gx = torch.empty((b, s, a, c), dtype=torch.float32, device=dev)
    ghr = torch.empty((b, a, a, h1), dtype=torch.float32, device=dev)
    ghs = torch.empty((b, a, a, h2), dtype=torch.float32, device=dev)
    gu_r, part_r, gwb_r = _gw_scratch(dev, b, a, h1, pc)
    gu_s, part_s, gwb_s = _gw_scratch(dev, b, a, h2, pc)
    _launch("qhnet_conv_bwd", *args.values(), gx, ghr, ghs, gwb_r, gwb_s, gu_r, gu_s, part_r,
            part_s, b, a, c, h1, h2, k, lmax)
    LAUNCHES["qhnet_conv_bwd"] += 1
    return gx, ghr, ghs, gwb_r[:h1], gwb_r[h1], gwb_s[:h2], gwb_s[h2]


def qhnet_pair_fwd(x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s, lmax: int = LMAX) -> torch.Tensor:
    """Kernel K: fij [B,A,S,A,C]."""
    dims = _dims(x, w2r, w2s, lmax)
    kz = _check_table("zi", zi, _zi_layout(lmax)[1])
    args = dict(x=x, zi=zi, maskf=maskf, hr=hr, hs=hs, w2r=w2r, b2r=b2r, w2s=w2s, b2s=b2s)
    dev = _kernels.check_inputs(args, _shapes(*dims, kz=kz))
    if dev.type == "cpu":
        return pair_fwd_reference(*args.values(), lmax=lmax)
    b, s, a, c, h1, h2, _ = dims
    out = torch.empty((b, a, s, a, c), dtype=torch.float32, device=dev)
    _launch("qhnet_pair_fwd", *args.values(), out, b, a, c, h1, h2, kz, lmax)
    LAUNCHES["qhnet_pair_fwd"] += 1
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
    gx = torch.empty((b, s, a, c), dtype=torch.float32, device=dev)
    gzi = torch.empty((b, a, kz, c), dtype=torch.float32, device=dev)
    ghr = torch.empty((b, a, a, h1), dtype=torch.float32, device=dev)
    ghs = torch.empty((b, a, a, h2), dtype=torch.float32, device=dev)
    gu_r, part_r, gwb_r = _gw_scratch(dev, b, a, h1, pc)
    gu_s, part_s, gwb_s = _gw_scratch(dev, b, a, h2, pc)
    wm = torch.empty((b, a, a, pc), dtype=torch.float32, device=dev)
    _launch("qhnet_pair_bwd", *args.values(), gx, gzi, ghr, ghs, gwb_r, gwb_s, gu_r, gu_s, wm,
            part_r, part_s, b, a, c, h1, h2, kz, lmax)
    LAUNCHES["qhnet_pair_bwd"] += 1
    return gx, gzi, ghr, ghs, gwb_r[:h1], gwb_r[h1], gwb_s[:h2], gwb_s[h2]


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


def flops_bytes(kind: str, x: torch.Tensor, table: torch.Tensor, hr: torch.Tensor,
                hs: torch.Tensor, lmax: int = LMAX) -> Tuple[int, int]:
    """(FLOPs, bytes) of kernel `kind` ("I", "J", "K" or "L") on these
    inputs: FLOPs from the JAX package's analytic model; bytes with each
    input read once and each output written once (`table` is cgsh for I/J,
    zi for K/L)."""
    b, s, a, c = x.shape
    h1, h2 = hr.shape[-1], hs.shape[-1]
    pc = len(tp_paths(lmax)) * c
    weights = (h1 + h2 + 2) * pc
    conv_out, pair_out = b * a * s * c, b * a * s * a * c
    ins = x.numel() + table.numel() + hr.numel() + hs.numel() + weights
    flops = {"I": conv_fwd_flops, "J": conv_bwd_flops, "K": pair_fwd_flops,
             "L": pair_bwd_flops}[kind](b, a, c, h1, h2, lmax)
    n = {
        "I": ins + conv_out,
        "J": ins + conv_out + x.numel() + hr.numel() + hs.numel() + weights,
        "K": ins + b * a * a + pair_out,
        "L": (ins + b * a * a + pair_out + x.numel() + table.numel() + hr.numel() + hs.numel()
              + weights),
    }[kind]
    return flops, 4 * n
