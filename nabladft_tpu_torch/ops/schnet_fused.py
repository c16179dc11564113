"""Fused SchNet continuous-filter convolution: CUDA kernels E (forward),
F (backward), G (dual forward) and H (dual backward).

The port of ``nabladft_tpu/ops/pallas/schnet_fused.py``: the first-order op
`schnet_message` (a `jax.custom_vjp` over `_fwd_kernel` / `_bwd_kernel`) and
the dual-number op `schnet_dual` (a `jax.custom_vjp` over `_dual_fwd_kernel`
/ `_dual_bwd_kernel`) that the surrogate training pass runs. Semantics on
the dense pair lattice, per molecule:

  z1  = rbf @ W1 + b1        h = ssp(z1)          (the filter MLP)
  wmr = h @ W2 + b2          wm = wmr ⊙ envf      (cutoff and adjacency)
  msg_i = Σ_j wm[i,j] ⊙ xin_j

rbf is not masked: the mask rides in envf (and envp, envfd), which are zero
off the edges, so the filter bias b2 dies there too.

The backward folds the chain rule through the basis AND the envelope: it
takes rbfp = ∂rbf/∂dist and envp = ∂envf/∂dist and returns the scalar
g_dist [B,A,A], so no [B,A,A,R] cotangent exists. The op therefore takes
`dist` as an explicit input and gives rbf/rbfp/envf/envp no gradient: the
caller must pass them as those functions of dist, detached.

The dual op carries a tangent lane beside rbf, envf and xin (rbfd, envfd,
xind) with the weights fixed, and returns (msg, msgd). Its VJP (kernel H)
gives node and weight cotangents only, none for the pair-level inputs: it
is valid only where positions are not differentiated, as in the surrogate's
parameter pass. Neither VJP is itself differentiable.

Layouts: rbf/rbfp/rbfd [B,A,A,R]; envf/envp/envfd [B,A,A]; xin/xind [B,A,F];
W1 [R,F]; b1 [1,F]; W2 [F,F]; b2 [1,F].

Two dtypes, the JAX kernels' two modes: every pair and node input (and the
cotangents gmsg, gmsgd) float32, or every one bfloat16 (the model's
``compute_dtype="bfloat16"``); a mix is refused. The filter weights are
float32 in both (the JAX model's raw params). In bf16 the kernels read the
pair and node tensors as bf16 and compute in float32, as the TPU kernels do:
E and G return msg (and msgd) in bf16; F and H compute float32 and return
gxin (and gxind) rounded to bf16, g_dist and the weight gradients in float32,
as the JAX wrappers cast them. The plain versions do the same on bf16 inputs
(float32 arithmetic on the widened values, one rounding); the autograd
Functions round the incoming cotangents to the inputs' dtype, as the JAX
VJPs do.

Each kernel has its plain PyTorch version here with the same signature
(`schnet_message_reference`, `schnet_message_bwd_reference`,
`schnet_dual_fwd_reference`, `schnet_dual_bwd_reference`). A wrapper takes
the plain version only for CPU tensors; a CUDA tensor launches the kernel
(sources in ``csrc/schnet_fused.cu``) or raises.

Every kernel runs its filter-MLP products on the tensor cores (the SO(2)
product engine of ``csrc/so2_common.cuh``) over the live pairs only (an
envelope lane not zero), around a stage on the CUDA cores: E and G list the
pairs in receiver order and sum per receiver, F and H list them in sender
order and sum per sender. `schnet_fwd_staged`, `schnet_dual_fwd_staged`,
`schnet_bwd_staged` and `schnet_dual_bwd_staged` are those decompositions in
plain torch (for the tests).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F_

from nabladft_tpu_torch.ops import _kernels

# launches of each CUDA kernel wrapper since the last reset
# ("schnet_bwd_gw": kernel F calls that also ran the weight-gradient stage);
# the bf16 mode's launches under the same names with "_bf16" appended
_KERNELS = ("schnet_fwd", "schnet_bwd", "schnet_bwd_gw", "schnet_dual_fwd", "schnet_dual_bwd")
LAUNCHES: Dict[str, int] = dict.fromkeys(_KERNELS + tuple(k + "_bf16" for k in _KERNELS), 0)
DTYPES = (torch.float32, torch.bfloat16)
_WEIGHTS = ("w1", "b1", "w2", "b2")

_LOG2 = math.log(2.0)


def _count(name: str, dtype: torch.dtype, n: int = 1) -> None:
    LAUNCHES[name if dtype == torch.float32 else name + "_bf16"] += n


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# FLOPs per channel and live pair of each kernel body, counted from the CUDA
# code (an FMA is 2, any other add, multiply, max, divide, exp or log1p 1), as
# (the R-long products' factor, the F-long products' factor, the rest): the
# products are the filter MLP's (and the weight gradients'), which every
# kernel runs on the tensor cores; the rest is the per-pair arithmetic of
# the epilogues and stages on the CUDA cores. Per channel:
#   fwd    — z1 = rbf @ W1 (2R), + b1 (1), ssp (5); wmr = h @ W2 (2F), + b2,
#            ⊙ envf, the FMA into msg (4);
#   bwd    — z1 and rbfp @ W1 (4R), + b1, ssp and sigmoid (7), s ⊙ rpw (1);
#            gwmr (2); wmr (2F + 1), gxin (3), g_env (2 + its channel sum 1);
#            gh = gwmr @ W2ᵀ (2F), ⊙ (s ⊙ rpw) and the channel sum (2);
#   bwd_gw — gz1 = gh ⊙ s (1); gW1 and gb1 (2R + 2); gwmr again (2), gW2 and
#            gb2 (2F + 2);
#   dual_fwd — z1, z1d (4R), + b1, ssp and sigmoid (7), hd (1); wmr, wmrd
#            (4F), + b2, wm, wmd, msg, msgd (11);
#   dual_bwd — z1, z1d (4R), + b1, ssp, sigmoid, hd (9); wmr, wmrd (4F) and
#            the gxin / gxind terms (11);
#   dual_bwd_gw — cot(wmr), cot(wmrd) (8); gh, ghd (4F), gz1, gz1d (7); gW1
#            and gb1 over both lanes (4R + 2); the cotangents again (8), gW2
#            and gb2 over both lanes (4F + 2).
_FLOPS = {"fwd": (2, 2, 10), "bwd": (4, 4, 20), "bwd_gw": (2, 2, 7),
          "dual_fwd": (4, 4, 20), "dual_bwd": (4, 4, 20), "dual_bwd_gw": (4, 8, 27)}


def flops_split(kind: str, r: int, f: int) -> Tuple[int, int]:
    """FLOPs per live pair of `kind` (see `_FLOPS`) as (the filter-MLP
    products, the rest)."""
    cr, cf, rest = _FLOPS[kind]
    return (cr * r + cf * f) * f, rest * f


def pair_flops(kind: str, r: int, f: int) -> int:
    """FLOPs per live pair (a pair whose envelope lanes are not all zero):
    `flops_split`'s two parts. The JAX package's analytic model
    (`kernel_flops`) counts 2R + 2F + 6 per channel for fwd."""
    return sum(flops_split(kind, r, f))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _ssp(x: torch.Tensor) -> torch.Tensor:
    return F_.softplus(x) - _LOG2


def _filter(rbf, w1, b1, w2, b2):
    """rbf -> (s, h, wmr): the filter MLP per pair."""
    z1 = torch.einsum("bijr,rf->bijf", rbf, w1) + b1[0]
    h = _ssp(z1)
    wmr = torch.einsum("bijf,fg->bijg", h, w2) + b2[0]
    return torch.sigmoid(z1), h, wmr


def _widened(*tensors):
    """The float32 values of bf16 inputs (exact), for the plain versions'
    bf16 mode; float32 inputs go through as they are."""
    return tuple(t if t.dtype == torch.float32 else t.float() for t in tensors)


def _rounded(outs, dtype):
    return tuple(None if t is None else t.to(dtype) for t in outs)


def schnet_message_reference(rbf, envf, xin, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of kernel E: msg [B,A,F], in the inputs' dtype
    (float32 arithmetic, one rounding on bf16 inputs: JAX's
    `schnet_message_reference`).

    Also the `use_pallas="off"` model path, differentiable by autograd.
    """
    dt = rbf.dtype
    rbf, envf, xin = _widened(rbf, envf, xin)
    z1 = torch.einsum("bijr,rf->bijf", rbf, w1) + b1[0]
    wmr = torch.einsum("bijf,fg->bijg", _ssp(z1), w2) + b2[0]
    wm = wmr * envf[..., None]
    return (wm * xin[:, None]).sum(dim=2).to(dt)


def schnet_message_bwd_reference(rbf, rbfp, envf, envp, xin, w1, b1, w2, b2, gmsg,
                                 need_gw: bool = True):
    """Plain PyTorch version of kernel F: the VJP of kernel E.

    Returns (g_dist [B,A,A], gxin [B,A,F], gw1, gb1, gw2, gb2), the four
    weight cotangents None without `need_gw`; g_dist = Σ_f gz1 ⊙ (rbfp @ W1)
    + g_env ⊙ envp. Float32 arithmetic; on bf16 inputs gxin rounded to bf16,
    g_dist and the weight cotangents float32.
    """
    dt = rbf.dtype
    out = _message_bwd(*_widened(rbf, rbfp, envf, envp, xin), w1, b1, w2, b2,
                       *_widened(gmsg), need_gw=need_gw)
    return (out[0], out[1].to(dt)) + out[2:]


def _message_bwd(rbf, rbfp, envf, envp, xin, w1, b1, w2, b2, gmsg, need_gw: bool = True):
    s, h, wmr = _filter(rbf, w1, b1, w2, b2)
    wm = wmr * envf[..., None]
    gwm = gmsg[:, :, None, :] * xin[:, None]          # [B,A(i),A(j),F]
    gxin = (wm * gmsg[:, :, None, :]).sum(dim=1)
    g_env = (gwm * wmr).sum(dim=-1)
    gwmr = gwm * envf[..., None]
    gz1 = torch.einsum("bijg,fg->bijf", gwmr, w2) * s
    rpw = torch.einsum("bijr,rf->bijf", rbfp, w1)
    g_dist = (gz1 * rpw).sum(dim=-1) + g_env * envp
    if not need_gw:
        return g_dist, gxin, None, None, None, None
    gw1 = torch.einsum("bijr,bijf->rf", rbf, gz1)
    gw2 = torch.einsum("bijf,bijg->fg", h, gwmr)
    return (g_dist, gxin, gw1, gz1.sum(dim=(0, 1, 2))[None], gw2,
            gwmr.sum(dim=(0, 1, 2))[None])


def _dual_filter(rbf, rbfd, envf, envfd, w1, b1, w2, b2):
    """(s, z1d, h, hd, wm, wmd) of the dual filter, weights fixed."""
    s, h, wmr = _filter(rbf, w1, b1, w2, b2)
    z1d = torch.einsum("bijr,rf->bijf", rbfd, w1)
    hd = s * z1d
    wmrd = torch.einsum("bijf,fg->bijg", hd, w2)
    e, ed = envf[..., None], envfd[..., None]
    return s, z1d, h, hd, wmr * e, wmrd * e + wmr * ed


def schnet_dual_fwd_reference(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2):
    """Plain PyTorch version of kernel G: kernel E and its directional
    derivative along (rbfd, envfd, xind), weights fixed. Returns (msg, msgd)
    in the inputs' dtype (float32 arithmetic, one rounding on bf16 inputs)."""
    dt = rbf.dtype
    rbf, rbfd, envf, envfd, xin, xind = _widened(rbf, rbfd, envf, envfd, xin, xind)
    _, _, _, _, wm, wmd = _dual_filter(rbf, rbfd, envf, envfd, w1, b1, w2, b2)
    msg = (wm * xin[:, None]).sum(dim=2)
    msgd = (wmd * xin[:, None]).sum(dim=2) + (wm * xind[:, None]).sum(dim=2)
    return _rounded((msg, msgd), dt)


def schnet_dual_bwd_reference(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2,
                              gmsg, gmsgd, need_gw: bool = True):
    """Plain PyTorch version of kernel H: the VJP of kernel G for the node
    inputs and the weights (the pair-level inputs get none).

    Returns (gxin, gxind [B,A,F], gw1, gb1, gw2, gb2), the four weight
    cotangents None without `need_gw`. Float32 arithmetic; on bf16 inputs
    gxin and gxind rounded to bf16, the weight cotangents float32.
    """
    dt = rbf.dtype
    out = _dual_bwd(*_widened(rbf, rbfd, envf, envfd, xin, xind), w1, b1, w2, b2,
                    *_widened(gmsg, gmsgd), need_gw=need_gw)
    return _rounded(out[:2], dt) + out[2:]


def _dual_bwd(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2, gmsg, gmsgd,
              need_gw: bool = True):
    s, z1d, h, hd, wm, wmd = _dual_filter(rbf, rbfd, envf, envfd, w1, b1, w2, b2)
    g, gd = gmsg[:, :, None, :], gmsgd[:, :, None, :]   # [B,A(i),1,F]
    gxin = (wm * g + wmd * gd).sum(dim=1)
    gxind = (wm * gd).sum(dim=1)
    if not need_gw:
        return gxin, gxind, None, None, None, None
    gwm = g * xin[:, None] + gd * xind[:, None]
    gwmd = gd * xin[:, None]
    e, ed = envf[..., None], envfd[..., None]
    cot_wmr = gwm * e + gwmd * ed
    cot_wmrd = gwmd * e
    gh = torch.einsum("bijg,fg->bijf", cot_wmr, w2)
    ghd = torch.einsum("bijg,fg->bijf", cot_wmrd, w2)
    # hd = s(z1)·z1d ⇒ ∂hd/∂z1 = s'(z1)·z1d with s' = s(1-s)
    gz1 = gh * s + ghd * (s * (1.0 - s) * z1d)
    gz1d = ghd * s
    gw1 = torch.einsum("bijr,bijf->rf", rbf, gz1) + torch.einsum("bijr,bijf->rf", rbfd, gz1d)
    gw2 = torch.einsum("bijf,bijg->fg", h, cot_wmr) + torch.einsum("bijf,bijg->fg", hd, cot_wmrd)
    return (gxin, gxind, gw1, gz1.sum(dim=(0, 1, 2))[None], gw2,
            cot_wmr.sum(dim=(0, 1, 2))[None])


def schnet_live_pairs(envf, env2):
    """Kernels F's and H's live-pair list: the slots (b, j, i) whose envf[b,i,j]
    or env2[b,i,j] (envp in F, envfd in H) is not zero, in sender order.
    Returns (slots, rows, starts): `rows` the pair rows (b·A + i)·A + j of the
    slots, `starts[b·A + j]` the first list index of sender j (`starts[B·A]`
    the count)."""
    b, a = envf.shape[:2]
    live = (envf != 0) | (env2 != 0)  # [B, A(i), A(j)]
    slots = live.transpose(1, 2).reshape(-1).nonzero().squeeze(1)
    bj, i = slots // a, slots % a
    rows = (bj // a * a + i) * a + bj % a
    counts = torch.bincount(bj, minlength=b * a)
    starts = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return slots, rows, starts


def schnet_live_rows(envf, env2=None):
    """Kernels E's and G's live-pair list: the pair rows (b·A + i)·A + j
    whose envf, or env2 where given (G's envfd), is not zero, in receiver
    order. Returns (rows, starts): `starts[b·A + i]` the first list index of
    receiver i (`starts[B·A]` the count)."""
    b, a = envf.shape[:2]
    live = envf != 0
    if env2 is not None:
        live = live | (env2 != 0)
    rows = live.reshape(-1).nonzero().squeeze(1)
    counts = torch.bincount(rows // a, minlength=b * a)
    return rows, torch.cat([counts.new_zeros(1), counts.cumsum(0)])


def _receiver_pairs(envf, env2, b, a):
    """(rows, receiver b·A + i, sender b·A + j) of each live pair in
    receiver order, and the sums over each receiver's pairs in list
    order."""
    rows, _ = schnet_live_rows(envf, env2)
    recv = rows // a
    sums = lambda x: x.new_zeros(b * a, x.shape[1]).index_add_(0, recv, x)  # noqa: E731
    return rows, recv // a * a + rows % a, sums


def schnet_fwd_staged(rbf, envf, xin, w1, b1, w2, b2):
    """Kernel E's stages in the card's order, on plain tensors: the live
    pairs in receiver order (`schnet_live_rows` of envf); h = ssp(rbf @ W1 +
    b1) over them and wmr = h @ W2 + b2 (the products and the ssp step); the
    per-receiver stage, per receiver i over its live senders j: msg_i = Σ_j
    wmr envf xin_j, zero for a receiver with no live sender. Returns
    schnet_message_reference's msg."""
    b, a, _, r = rbf.shape
    f = w1.shape[1]
    rows, sender, sums = _receiver_pairs(envf, None, b, a)
    wmr = _ssp(rbf.reshape(-1, r)[rows] @ w1 + b1[0]) @ w2 + b2[0]
    wm = wmr * envf.reshape(-1)[rows][:, None]
    return sums(wm * xin.reshape(b * a, f)[sender]).reshape(b, a, f)


def schnet_dual_fwd_staged(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2):
    """Kernel G's stages in the card's order, on plain tensors: the live
    pairs in receiver order (envf or envfd not zero); z1 = rbf @ W1 + b1 and
    z1d = rbfd @ W1 over them, h = ssp(z1) and hd = sigmoid(z1) z1d, wmr = h
    @ W2 + b2 and wmrd = hd @ W2; the per-receiver stage: msg_i = Σ_j wm
    xin_j and msgd_i = Σ_j wmd xin_j + wm xind_j with wm = wmr e, wmd = wmrd
    e + wmr ed. Returns schnet_dual_fwd_reference's tuple."""
    b, a, _, r = rbf.shape
    f = w1.shape[1]
    rows, sender, sums = _receiver_pairs(envf, envfd, b, a)
    z1 = rbf.reshape(-1, r)[rows] @ w1 + b1[0]
    hd = torch.sigmoid(z1) * (rbfd.reshape(-1, r)[rows] @ w1)
    wmr, wmrd = _ssp(z1) @ w2 + b2[0], hd @ w2
    e, ed = envf.reshape(-1)[rows][:, None], envfd.reshape(-1)[rows][:, None]
    wm, wmd = wmr * e, wmrd * e + wmr * ed
    xj, xdj = xin.reshape(b * a, f)[sender], xind.reshape(b * a, f)[sender]
    return sums(wm * xj).reshape(b, a, f), sums(wmd * xj + wm * xdj).reshape(b, a, f)


def _staged_pairs(envf, env2, b, a):
    """(rows, sender b·A + j, receiver b·A + i) of each live pair, in the
    card's order."""
    slots, rows, _ = schnet_live_pairs(envf, env2)
    sender = slots // a
    return rows, sender, sender // a * a + slots % a


def _node_sums(x, sender, n):
    return x.new_zeros(n, x.shape[1]).index_add_(0, sender, x)


def schnet_bwd_staged(rbf, rbfp, envf, envp, xin, w1, b1, w2, b2, gmsg, need_gw: bool = True):
    """Kernel F's stages in the card's order, on plain tensors: the live
    pairs in sender order (`schnet_live_pairs` of envf, envp); z1 = rbf @ W1
    + b1 and rpw = rbfp @ W1 over them, s and h = ssp(z1), wmr = h @ W2 + b2
    (the products and the ssp step); the per-sender stage: gxin, g_env and
    gwmr = gmsg_i xin_j envf; gz1 = (gwmr @ W2ᵀ) ⊙ s; g_dist = Σ_f gz1 rpw +
    g_env envp in the live slots (zeros in the dead ones); then gW1 | gb1 =
    rbf_liveᵀ gz1 and gW2 | gb2 = hᵀ gwmr. Returns
    schnet_message_bwd_reference's tuple."""
    b, a, _, r = rbf.shape
    f = w1.shape[1]
    rows, sender, recv = _staged_pairs(envf, envp, b, a)
    rbf_l = rbf.reshape(-1, r)[rows]
    z1 = rbf_l @ w1 + b1[0]
    rpw = rbfp.reshape(-1, r)[rows] @ w1
    s, h = torch.sigmoid(z1), _ssp(z1)
    wmr = h @ w2 + b2[0]

    # the stage: per live pair, the receiver's gmsg and the sender's xin
    ef = envf.reshape(-1)[rows][:, None]
    gm, xj = gmsg.reshape(b * a, f)[recv], xin.reshape(b * a, f)[sender]
    gwm = gm * xj
    g_env = (gwm * wmr).sum(-1)
    gxin = _node_sums(wmr * ef * gm, sender, b * a)
    gwmr = gwm * ef
    gz1 = (gwmr @ w2.T) * s
    g_dist = rbf.new_zeros(b * a * a)
    g_dist[rows] = (gz1 * rpw).sum(-1) + g_env * envp.reshape(-1)[rows]
    out = (g_dist.reshape(b, a, a), gxin.reshape(b, a, f))
    if not need_gw:
        return out + (None,) * 4
    return out + (rbf_l.T @ gz1, gz1.sum(0)[None], h.T @ gwmr, gwmr.sum(0)[None])


def schnet_dual_bwd_staged(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2, gmsg, gmsgd,
                           need_gw: bool = True):
    """Kernel H's stages in the card's order, on plain tensors: the live
    pairs in sender order (envf or envfd not zero); z1 = rbf @ W1 + b1 and
    z1d = rbfd @ W1 over them, s, h and hd = s z1d, wmr = h @ W2 + b2 and
    wmrd = hd @ W2; the per-sender stage: gxin, gxind and the cotangents of
    wmr and wmrd; gW2 | gb2 = hᵀ cot(wmr) + hdᵀ cot(wmrd); gh and ghd (the
    cotangents @ W2ᵀ), gz1 = gh s + ghd (1 - s) hd and gz1d = ghd s; then
    gW1 | gb1 = rbf_liveᵀ gz1 + rbfd_liveᵀ gz1d. Returns
    schnet_dual_bwd_reference's tuple."""
    b, a, _, r = rbf.shape
    f = w1.shape[1]
    rows, sender, recv = _staged_pairs(envf, envfd, b, a)
    rbf_l, rbfd_l = rbf.reshape(-1, r)[rows], rbfd.reshape(-1, r)[rows]
    z1 = rbf_l @ w1 + b1[0]
    s, h = torch.sigmoid(z1), _ssp(z1)
    hd = s * (rbfd_l @ w1)
    wmr, wmrd = h @ w2 + b2[0], hd @ w2

    e, ed = envf.reshape(-1)[rows][:, None], envfd.reshape(-1)[rows][:, None]
    gm, gmd = gmsg.reshape(b * a, f)[recv], gmsgd.reshape(b * a, f)[recv]
    wm, wmd = wmr * e, wmrd * e + wmr * ed
    gxin = _node_sums(wm * gm + wmd * gmd, sender, b * a).reshape(b, a, f)
    gxind = _node_sums(wm * gmd, sender, b * a).reshape(b, a, f)
    if not need_gw:
        return (gxin, gxind) + (None,) * 4
    xj, xdj = xin.reshape(b * a, f)[sender], xind.reshape(b * a, f)[sender]
    gwm, gwmd = gm * xj + gmd * xdj, gmd * xj
    cot, cotd = gwm * e + gwmd * ed, gwmd * e
    gh, ghd = cot @ w2.T, cotd @ w2.T
    gz1, gz1d = gh * s + ghd * ((1.0 - s) * hd), ghd * s
    return (gxin, gxind, rbf_l.T @ gz1 + rbfd_l.T @ gz1d, gz1.sum(0)[None],
            h.T @ cot + hd.T @ cotd, cot.sum(0)[None])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load("schnet_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.schnet_smem_bytes.argtypes = [i] * 4
    lib.schnet_smem_bytes.restype = i
    for kind in ("fwd", "bwd"):
        getattr(lib, f"schnet_{kind}_scratch_floats").argtypes = [i] * 5
        getattr(lib, f"schnet_{kind}_scratch_floats").restype = ctypes.c_longlong
        getattr(lib, f"schnet_{kind}_scratch_ints").argtypes = [i] * 2
        getattr(lib, f"schnet_{kind}_scratch_ints").restype = ctypes.c_longlong
    lib.schnet_fwd.argtypes = [p] * 10 + [i] * 4 + [p]
    lib.schnet_fwd.restype = i
    lib.schnet_bwd.argtypes = [p] * 15 + [i] * 5 + [p]
    lib.schnet_bwd.restype = i
    lib.schnet_dual_fwd.argtypes = [p] * 14 + [i] * 4 + [p]
    lib.schnet_dual_fwd.restype = i
    lib.schnet_dual_bwd.argtypes = [p] * 17 + [i] * 5 + [p]
    lib.schnet_dual_bwd.restype = i
    for name in ("schnet_fwd", "schnet_bwd", "schnet_dual_fwd", "schnet_dual_bwd"):
        bf = getattr(lib, name + "_bf16")
        bf.argtypes, bf.restype = getattr(lib, name).argtypes, i
    return lib


def smem_bytes(kernel: str, a: int, r: int, f: int) -> int:
    """Dynamic shared memory per block that the stage of kernel "E", "F",
    "G" or "H" asks for at A=a atoms, R=r, F=f (from the library's own
    layout)."""
    return _lib().schnet_smem_bytes("EFGH".index(kernel), a, r, f)


def _dims(xin, w1) -> Tuple[int, int, int, int]:
    b, a = xin.shape[0], xin.shape[1]
    r, f = w1.shape
    return b, a, r, f


def _shapes(b, a, r, f) -> Dict[str, tuple]:
    pair, env, node = (b, a, a, r), (b, a, a), (b, a, f)
    return dict(rbf=pair, rbfp=pair, rbfd=pair, envf=env, envp=env, envfd=env, xin=node,
                xind=node, w1=(r, f), b1=(1, f), w2=(f, f), b2=(1, f), gmsg=node, gmsgd=node)


def _check(args: Dict[str, torch.Tensor], shapes: Dict[str, tuple]) -> Tuple[torch.device,
                                                                             torch.dtype]:
    """A wrapper's inputs: the pair and node tensors one dtype of DTYPES, the
    filter weights float32, all on one device (see `_kernels.check_inputs`).
    Returns (device, the pair and node tensors' dtype)."""
    data = {k: t for k, t in args.items() if k not in _WEIGHTS}
    dev = _kernels.check_inputs(data, shapes, DTYPES)
    if _kernels.check_inputs({k: args[k] for k in _WEIGHTS}, shapes) != dev:
        raise ValueError(f"the filter weights are on {args['w1'].device}, the inputs on {dev}")
    return dev, next(iter(data.values())).dtype


def _launch(name: str, dtype: torch.dtype, *args) -> None:
    """Launch entry point `name` (its `_bf16` twin for bf16 inputs)."""
    ptrs = [0 if a is None else (a.data_ptr() if isinstance(a, torch.Tensor) else a)
            for a in args]
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    entry = name if dtype == torch.float32 else name + "_bf16"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_lib(), entry)(*ptrs, stream)
    _kernels.raise_on_error(err, f"{entry} launch")


def _engine_operands(args: Dict[str, torch.Tensor], r: int, f: int):
    """A kernel's inputs as it takes them: R and F rounded up to multiples
    of 4 with zeros (the pair tensors' basis axis, the node tensors'
    channels, the weights and biases), each in its own dtype; a copy only off
    those multiples (schnet.yaml's R = 100, F = 128 need none). Returns
    (args, R4, F4)."""
    r4, f4 = -(-r // 4) * 4, -(-f // 4) * 4
    pad = torch.nn.functional.pad
    out = {}
    for k, t in args.items():
        if k in ("rbf", "rbfp", "rbfd"):
            t = pad(t, (0, r4 - r)) if r4 != r else t
        elif k == "w1":
            t = pad(t, (0, f4 - f, 0, r4 - r)) if (r4, f4) != (r, f) else t
        elif k == "w2":
            t = pad(t, (0, f4 - f, 0, f4 - f)) if f4 != f else t
        elif k not in ("envf", "envp", "envfd"):
            t = pad(t, (0, f4 - f)) if f4 != f else t
        out[k] = t
    return out, r4, f4


def _fwd_buffers(kind, dev, b, a, r4, f4):
    """(float scratch, int scratch) of an E ("E") or G ("G") launch."""
    lib = _lib()
    return (torch.empty(lib.schnet_fwd_scratch_floats("EG".index(kind), b, a, r4, f4),
                        dtype=torch.float32, device=dev),
            torch.empty(lib.schnet_fwd_scratch_ints(b, a), dtype=torch.int32, device=dev))


def _bwd_buffers(kind, dev, b, a, r4, f4, need_gw):
    """(gW1 | gb1 | gW2 | gb2 [R4 + 1 + F4 + 1, F4] or None, float scratch,
    int scratch) of an F ("F") or H ("H") launch."""
    lib = _lib()
    gw = (torch.empty((r4 + f4 + 2, f4), dtype=torch.float32, device=dev) if need_gw
          else None)
    return (gw, torch.empty(lib.schnet_bwd_scratch_floats("FH".index(kind), b, a, r4, f4),
                            dtype=torch.float32, device=dev),
            torch.empty(lib.schnet_bwd_scratch_ints(b, a), dtype=torch.int32, device=dev))


def _grads(gw, r, f, r4, f4):
    """(gw1, gb1, gw2, gb2) from an F or H launch's gW buffer."""
    parts = (gw[:r, :f], gw[r4:r4 + 1, :f], gw[r4 + 1:r4 + 1 + f, :f],
             gw[r4 + 1 + f4:, :f])
    return tuple(t if f4 == f else t.contiguous() for t in parts)


def schnet_fwd(rbf, envf, xin, w1, b1, w2, b2) -> torch.Tensor:
    """Kernel E: msg [B,A,F]."""
    b, a, r, f = _dims(xin, w1)
    args = dict(rbf=rbf, envf=envf, xin=xin, w1=w1, b1=b1, w2=w2, b2=b2)
    dev, dt = _check(args, _shapes(b, a, r, f))
    if dev.type == "cpu":
        return schnet_message_reference(*args.values())
    args, r4, f4 = _engine_operands(args, r, f)
    msg = torch.empty((b, a, f4), dtype=dt, device=dev)  # every row is written
    scratch, iscratch = _fwd_buffers("E", dev, b, a, r4, f4)
    _launch("schnet_fwd", dt, *args.values(), msg, scratch, iscratch, b, a, r4, f4)
    _count("schnet_fwd", dt)
    return msg if f4 == f else msg[..., :f].contiguous()


def schnet_bwd(rbf, rbfp, envf, envp, xin, w1, b1, w2, b2, gmsg, need_gw: bool = True):
    """Kernel F: (g_dist, gxin, gw1, gb1, gw2, gb2), weights' None without
    `need_gw`; gxin in the inputs' dtype, the rest float32."""
    b, a, r, f = _dims(xin, w1)
    args = dict(rbf=rbf, rbfp=rbfp, envf=envf, envp=envp, xin=xin, w1=w1, b1=b1, w2=w2, b2=b2,
                gmsg=gmsg)
    dev, dt = _check(args, _shapes(b, a, r, f))
    if dev.type == "cpu":
        return schnet_message_bwd_reference(*args.values(), need_gw=need_gw)
    args, r4, f4 = _engine_operands(args, r, f)
    g_dist = torch.zeros((b, a, a), dtype=torch.float32, device=dev)  # the dead slots' zeros
    gxin = torch.empty((b, a, f4), dtype=torch.float32, device=dev)
    gw, scratch, iscratch = _bwd_buffers("F", dev, b, a, r4, f4, need_gw)
    _launch("schnet_bwd", dt, *args.values(), g_dist, gxin, gw, scratch, iscratch,
            int(need_gw), b, a, r4, f4)
    _count("schnet_bwd", dt)
    _count("schnet_bwd_gw", dt, int(need_gw))
    gxin = (gxin if f4 == f else gxin[..., :f]).to(dt).contiguous()
    if not need_gw:
        return g_dist, gxin, None, None, None, None
    return (g_dist, gxin, *_grads(gw, r, f, r4, f4))


def schnet_dual_fwd(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2):
    """Kernel G: (msg, msgd) [B,A,F] in the inputs' dtype."""
    b, a, r, f = _dims(xin, w1)
    args = dict(rbf=rbf, rbfd=rbfd, envf=envf, envfd=envfd, xin=xin, xind=xind, w1=w1, b1=b1,
                w2=w2, b2=b2)
    dev, dt = _check(args, _shapes(b, a, r, f))
    if dev.type == "cpu":
        return schnet_dual_fwd_reference(*args.values())
    args, r4, f4 = _engine_operands(args, r, f)
    msg = torch.empty((b, a, f4), dtype=dt, device=dev)  # every row is written
    msgd = torch.empty_like(msg)
    scratch, iscratch = _fwd_buffers("G", dev, b, a, r4, f4)
    _launch("schnet_dual_fwd", dt, *args.values(), msg, msgd, scratch, iscratch, b, a, r4, f4)
    _count("schnet_dual_fwd", dt)
    if f4 != f:
        msg, msgd = msg[..., :f].contiguous(), msgd[..., :f].contiguous()
    return msg, msgd


def schnet_dual_bwd(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2, gmsg, gmsgd,
                    need_gw: bool = True):
    """Kernel H: (gxin, gxind, gw1, gb1, gw2, gb2), weights' None without
    `need_gw`; gxin and gxind in the inputs' dtype, the rest float32."""
    b, a, r, f = _dims(xin, w1)
    args = dict(rbf=rbf, rbfd=rbfd, envf=envf, envfd=envfd, xin=xin, xind=xind, w1=w1, b1=b1,
                w2=w2, b2=b2, gmsg=gmsg, gmsgd=gmsgd)
    dev, dt = _check(args, _shapes(b, a, r, f))
    if dev.type == "cpu":
        return schnet_dual_bwd_reference(*args.values(), need_gw=need_gw)
    args, r4, f4 = _engine_operands(args, r, f)
    gxin = torch.empty((b, a, f4), dtype=torch.float32, device=dev)
    gxind = torch.empty_like(gxin)
    gw, scratch, iscratch = _bwd_buffers("H", dev, b, a, r4, f4, need_gw)
    _launch("schnet_dual_bwd", dt, *args.values(), gxin, gxind, gw, scratch, iscratch,
            int(need_gw), b, a, r4, f4)
    _count("schnet_dual_bwd", dt)
    gxin, gxind = ((t if f4 == f else t[..., :f]).to(dt).contiguous() for t in (gxin, gxind))
    if not need_gw:
        return gxin, gxind, None, None, None, None
    return (gxin, gxind, *_grads(gw, r, f, r4, f4))


class SchNetMessageFn(torch.autograd.Function):
    """`schnet_message`'s custom VJP: forward = kernel E, backward = kernel F.

    Inputs (dist, rbf, rbfp, envf, envp, xin, w1, b1, w2, b2); rbf, rbfp,
    envf and envp get no gradient, dist gets g_dist (the basis and envelope
    chains folded through rbfp and envp); the weights get theirs only when
    asked (F's weight-gradient stage). The cotangent is rounded to the
    inputs' dtype first, as the JAX VJP rounds it.
    """

    @staticmethod
    def forward(ctx, dist, rbf, rbfp, envf, envp, xin, w1, b1, w2, b2):
        ctx.save_for_backward(rbf, rbfp, envf, envp, xin, w1, b1, w2, b2)
        return schnet_fwd(rbf, envf, xin, w1, b1, w2, b2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gmsg):
        want = ctx.needs_input_grad[6:10]
        dt = ctx.saved_tensors[0].dtype
        g_dist, gxin, *gw = schnet_bwd(*ctx.saved_tensors, gmsg.to(dt).contiguous(),
                                       need_gw=any(want))
        return (g_dist, None, None, None, None, gxin,
                *(g if w else None for g, w in zip(gw, want)))


def schnet_message(dist, rbf, rbfp, envf, envp, xin, w1, b1, w2, b2) -> torch.Tensor:
    """First-order fused cfconv (inference / forces): msg [B,A,F]."""
    return SchNetMessageFn.apply(dist, rbf, rbfp, envf, envp, xin, w1, b1, w2, b2)


class SchNetDualFn(torch.autograd.Function):
    """`schnet_dual`'s custom VJP: forward = kernel G, backward = kernel H.

    Inputs (rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2); outputs
    (msg, msgd). The four pair-level inputs get no gradient; the cotangents
    are rounded to the inputs' dtype first, as the JAX VJP rounds them.
    """

    @staticmethod
    def forward(ctx, rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2):
        ctx.save_for_backward(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2)
        return schnet_dual_fwd(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gmsg, gmsgd):
        want = ctx.needs_input_grad[6:10]
        dt = ctx.saved_tensors[0].dtype
        gxin, gxind, *gw = schnet_dual_bwd(*ctx.saved_tensors, gmsg.to(dt).contiguous(),
                                           gmsgd.to(dt).contiguous(), need_gw=any(want))
        return (None, None, None, None, gxin, gxind,
                *(g if w else None for g, w in zip(gw, want)))


def schnet_dual(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2):
    """Dual-number fused cfconv: (msg, msgd), primal and tangent lanes in
    one kernel. Differentiable (once) in xin, xind and the weights only:
    for the surrogate's parameter pass."""
    return SchNetDualFn.apply(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2)


# ---------------------------------------------------------------------------
# work the kernels need on given inputs
# ---------------------------------------------------------------------------


def _live(*env) -> int:
    live = None
    for t in env:
        live = (t != 0) if live is None else live | (t != 0)
    return int(live.sum())


def _weight_bytes(r: int, f: int) -> int:
    """Bytes of W1, b1, W2, b2 (float32 in both modes)."""
    return 4 * (r * f + f + f * f + f)


def schnet_fwd_flops_bytes(rbf: torch.Tensor, envf: torch.Tensor, f: int) -> Tuple[int, int]:
    """(FLOPs, bytes) kernel E needs on these inputs: FLOPs over the pairs
    whose envf is nonzero (no other pair adds to msg), bytes with each input
    read once and each output written once, the pair and node tensors in
    their dtype (2 bytes a value in bf16), the weights float32."""
    b, a, _, r = rbf.shape
    flops = pair_flops("fwd", r, f) * _live(envf)
    nbytes = rbf.element_size() * (rbf.numel() + envf.numel() + 2 * b * a * f) + _weight_bytes(r, f)
    return flops, nbytes


def schnet_bwd_flops_bytes(rbf: torch.Tensor, envf: torch.Tensor, envp: torch.Tensor, f: int,
                           need_gw: bool = True) -> Tuple[int, int]:
    """(FLOPs, bytes) kernel F needs (see schnet_fwd_flops_bytes; live pairs
    are those with envf or envp nonzero; g_dist float32 in both modes); with
    gW, also the weight gradient."""
    b, a, _, r = rbf.shape
    live = _live(envf, envp)
    flops = pair_flops("bwd", r, f) * live
    if need_gw:
        flops += pair_flops("bwd_gw", r, f) * live
    nbytes = (rbf.element_size() * (2 * rbf.numel() + 2 * envf.numel() + 2 * b * a * f
                                     + b * a * f)         # inputs, gxin
              + 4 * envf.numel()                          # g_dist
              + _weight_bytes(r, f) * (2 if need_gw else 1))
    return flops, nbytes


def schnet_dual_fwd_flops_bytes(rbf: torch.Tensor, envf: torch.Tensor, envfd: torch.Tensor,
                                f: int) -> Tuple[int, int]:
    """(FLOPs, bytes) kernel G needs: FLOPs over the pairs whose envf or
    envfd is nonzero, bytes with each input read once and each output
    written once."""
    b, a, _, r = rbf.shape
    flops = pair_flops("dual_fwd", r, f) * _live(envf, envfd)
    nbytes = (rbf.element_size() * (2 * rbf.numel() + 2 * envf.numel() + 2 * b * a * f
                                     + 2 * b * a * f) + _weight_bytes(r, f))
    return flops, nbytes


def schnet_dual_bwd_flops_bytes(rbf: torch.Tensor, envf: torch.Tensor, envfd: torch.Tensor,
                                f: int, need_gw: bool = True) -> Tuple[int, int]:
    """(FLOPs, bytes) kernel H needs (see schnet_dual_fwd_flops_bytes); with
    gW, also the weight gradient."""
    b, a, _, r = rbf.shape
    live = _live(envf, envfd)
    flops = pair_flops("dual_bwd", r, f) * live
    if need_gw:
        flops += pair_flops("dual_bwd_gw", r, f) * live
    nbytes = (rbf.element_size() * (2 * rbf.numel() + 2 * envf.numel() + 2 * b * a * f
                                     + 2 * b * a * f + 2 * b * a * f)  # gmsg, gmsgd, gxin, gxind
              + _weight_bytes(r, f) * (2 if need_gw else 1))
    return flops, nbytes


def _work(kinds, live: int, r: int, f: int, flops: int, nbytes: int, pairs: int,
          dtype: torch.dtype) -> dict:
    """In the bf16 mode "flops_live_products_bf16_rows" are the R-long
    products, whose rows (rbf, rbfp, rbfd) are bf16 and whose other operand
    (W1, or gW's fp32 cotangents) is fp32; the F-long ones are fp32 x fp32."""
    prod = other = rows = 0
    for k in kinds:
        p, o = flops_split(k, r, f)
        prod, other, rows = prod + p * live, other + o * live, rows + _FLOPS[k][0] * r * f * live
    out = {"flops_live": flops, "flops_live_products": prod, "flops_live_other": other,
           "bytes": nbytes, "live_pairs": live, "pairs": pairs}
    if dtype == torch.bfloat16:
        out["flops_live_products_bf16_rows"] = rows
    return out


def fwd_work(kind: str, rbf: torch.Tensor, envf: torch.Tensor, envfd: torch.Tensor,
             f: int) -> Dict[str, int]:
    """The work of kernel E (`kind` "E"; envfd unused) or G ("G") on these
    inputs, as `bwd_work` gives it: the filter-MLP products (on the tensor
    cores) split from the rest."""
    b, a, _, r = rbf.shape
    if kind == "E":
        live, (flops, nbytes) = _live(envf), schnet_fwd_flops_bytes(rbf, envf, f)
    else:
        live = _live(envf, envfd)
        flops, nbytes = schnet_dual_fwd_flops_bytes(rbf, envf, envfd, f)
    return _work(("fwd",) if kind == "E" else ("dual_fwd",), live, r, f, flops, nbytes,
                 b * a * a, rbf.dtype)


def bwd_work(kind: str, rbf: torch.Tensor, envf: torch.Tensor, env2: torch.Tensor, f: int,
             need_gw: bool = True) -> Dict[str, int]:
    """The work of kernel F (`kind` "F", env2 = envp) or H ("H", env2 =
    envfd) on these inputs, over the live pairs (envf or env2 not zero):
    "flops_live" as schnet_bwd_flops_bytes / schnet_dual_bwd_flops_bytes
    count it, "flops_live_products" / "flops_live_other" its split
    (`flops_split`: the filter-MLP products, which F and H run on the tensor
    cores, and the per-pair rest), "bytes" each input read once and each
    output written once, and the live and all pairs."""
    b, a, _, r = rbf.shape
    kinds = {"F": ("bwd", "bwd_gw"), "H": ("dual_bwd", "dual_bwd_gw")}[kind]
    if kind == "F":
        flops, nbytes = schnet_bwd_flops_bytes(rbf, envf, env2, f, need_gw)
    else:
        flops, nbytes = schnet_dual_bwd_flops_bytes(rbf, envf, env2, f, need_gw)
    return _work(kinds[: 1 + int(need_gw)], _live(envf, env2), r, f, flops, nbytes, b * a * a,
                 rbf.dtype)
