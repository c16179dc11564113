"""Fused PaiNN message: CUDA kernels A (forward), B (backward), C (dual
forward) and D (dual backward).

The port of ``nabladft_tpu/ops/pallas/painn_fused.py``: the first-order op
`painn_message` (a `jax.custom_vjp` over `_fwd_kernel` / `_bwd_kernel`) and
the dual-number op `painn_dual` (a `jax.custom_vjp` over `_dual_fwd_kernel`
/ `_dual_bwd_kernel`) that the surrogate training pass runs.
Semantics, on premasked inputs (bias and mask terms stay outside, in
``models/painn.py``):

  wm  = rbf @ W                (channel k slice: wm_k = rbf @ W[:, kF:(k+1)F])
  ds_i  = Σ_j wm0[i,j] ⊙ φ0_j
  dv_ic = Σ_j wm1[i,j] ⊙ φ1_j ⊙ v_jc  +  Σ_j u_c[i,j] · wm2[i,j] ⊙ φ2_j

The backward folds the chain rule through the radial basis: it takes
rbfp = ∂(basis·envelope)/∂dist and returns the scalar g_dist [B,A,A], so the
[B,A,A,R] cotangent never exists. The op therefore takes `dist` as an
explicit input and gives rbf/rbfp no gradient: the caller must pass
rbf == f(dist), rbfp == f'(dist), detached.

The dual op carries a tangent lane beside every input but w: it returns
(ds, dv) and their directional derivatives (dsd, dvd). Its VJP (kernel D)
gives node and weight cotangents only, and none for the pair-level inputs
(rbf, rbfd, unit_t, unitd_t): it is valid only where positions are not
differentiated, as in the surrogate's parameter pass. Neither VJP is itself
differentiable: a second derivative through them raises.

Layouts: v and dv are component-major flat [B,A,3F]; unit_t is [B,A,3,A]
(u_t[b,i,c,j] = unit(j→i)_c).

Two dtypes, the JAX kernels' two modes: every input float32, or every
input bfloat16 (the model's ``compute_dtype="bfloat16"``: w is then the
bf16 cast of the filter kernel); a mix is refused. In bf16 the kernels read
the pair and node tensors as bf16 and compute in float32, as the TPU kernels
do: A and C return bf16, B and D compute float32 and return gphi, gv,
g_unit_t and gw (D: gphi, gphid, gv, gvd, gw) rounded to bf16, g_dist in
float32, as the JAX wrappers round them. The plain versions do the same on
bf16 inputs (float32 arithmetic on the widened values, one rounding);
`painn_message_dense` is the message in the inputs' own dtype, every op
rounding to it, the model's ``use_pallas="off"`` path (JAX's
`painn_message_reference`, whose wm is bf16 in bf16).

Each kernel has its plain PyTorch version here with the same signature
(`painn_message_reference`, `painn_message_bwd_reference`,
`painn_dual_fwd_reference`, `painn_dual_bwd_reference`). A wrapper
takes the plain version only for CPU tensors; a CUDA tensor launches the
kernel (sources in ``csrc/painn_fused.cu``) or raises.

Every kernel runs its radial products on the tensor cores (the SO(2)
product engine of ``csrc/so2_common.cuh``) over the live pairs only,
around a stage on the CUDA cores: A and C list the pairs in receiver order
and sum per receiver, B and D list them in sender order and sum per
sender. `painn_fwd_staged`, `painn_dual_fwd_staged`, `painn_bwd_staged` and
`painn_dual_bwd_staged` are those decompositions in plain torch (for the
tests).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from nabladft_tpu_torch.ops import _kernels

# launches of each CUDA kernel wrapper since the last reset
# ("painn_bwd_gw": kernel B calls that also ran its weight-gradient stage);
# the bf16 mode's launches under the same names with "_bf16" appended
_KERNELS = ("painn_fwd", "painn_bwd", "painn_bwd_gw", "painn_dual_fwd", "painn_dual_bwd")
LAUNCHES: Dict[str, int] = dict.fromkeys(_KERNELS + tuple(k + "_bf16" for k in _KERNELS), 0)
DTYPES = (torch.float32, torch.bfloat16)


def _count(name: str, dtype: torch.dtype, n: int = 1) -> None:
    LAUNCHES[name if dtype == torch.float32 else name + "_bf16"] += n


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pair_flops(kind: str, r: int, f: int) -> int:
    """FLOPs per live (unmasked) pair, counted from the CUDA kernel bodies
    (an FMA is 2). Per channel f:

      fwd    — wm = rbf @ W for three slices (6R), ds (2), the φ1⊙v_c and
               u_c terms of dv (7 each): 6R + 16;
      bwd    — wm and rbfp @ W for three slices (12R), the channel-0, -1 and
               -2 cotangents (5, 23, 17), the channel sums of g_dist and
               g_unit_t (4): 12R + 49;
      bwd_gw — the weight gradient's per-pair cotangent (13) and its
               product with rbf (6R): 6R + 13;
      dual_fwd    — wm and wmd = rbfd @ W for three slices (12R), channel 0
               (6), channels 1 and 2 (22 each): 12R + 50;
      dual_bwd    — wm and wmd for three slices (12R), the channel-0, -1 and
               -2 sums (6, 18, 22): 12R + 46 (the per-node epilogue, 28 per
               node and channel, is not counted);
      dual_bwd_gw — the per-pair cotangents gwm and gwmd (4, 20, 20) and
               their products with rbf and rbfd (12R): 12R + 44.

    (The JAX package's analytic model, `kernel_flops`, counts more:
    fwd 6R + 32, bwd 18R + 78 per channel and pair.)
    """
    return {"fwd": 6 * r + 16, "bwd": 12 * r + 49, "bwd_gw": 6 * r + 13,
            "dual_fwd": 12 * r + 50, "dual_bwd": 12 * r + 46,
            "dual_bwd_gw": 12 * r + 44}[kind] * f


def flops_split(kind: str, r: int, f: int) -> Tuple[int, int]:
    """`pair_flops(kind, r, f)` as (radial products, the rest): the products
    of R-long rows with W (rbf @ W, and rbfp @ W or rbfd @ W; for gW the
    products of the same rows with the per-pair cotangents), which every
    kernel runs on the tensor cores, and the per-pair arithmetic, which
    stays on the CUDA cores."""
    prod = {"fwd": 6, "bwd": 12, "bwd_gw": 6, "dual_fwd": 12, "dual_bwd": 12,
            "dual_bwd_gw": 12}[kind] * r * f
    return prod, pair_flops(kind, r, f) - prod


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _widened(fn, *tensors, **kw):
    """fn on the float32 values of bf16 inputs (exact), for the plain
    versions' bf16 mode; fp32 inputs go through as they are."""
    if tensors[0].dtype == torch.float32:
        return fn(*tensors, **kw)
    return fn(*(t.float() for t in tensors), **kw)


def _rounded(outs, dtype):
    return tuple(None if t is None else t.to(dtype) for t in outs)


def painn_message_reference(rbf, phi, v, unit_t, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel A (premasked rbf, no bias): float32
    arithmetic, the outputs in the inputs' dtype (bf16 inputs: one rounding,
    as kernel A)."""
    return _rounded(_widened(painn_message_dense, rbf, phi, v, unit_t, w), rbf.dtype)


def painn_message_dense(rbf, phi, v, unit_t, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """The message in the inputs' dtype, each op rounding to it (wm too):
    the `use_pallas="off"` model path, differentiable by autograd. In float32
    it is kernel A's plain version."""
    f = w.shape[1] // 3
    wm = torch.einsum("bijr,rk->bijk", rbf, w)
    ds = (wm[..., :f] * phi[:, None, :, :f]).sum(dim=2)
    phi1 = phi[:, :, f : 2 * f]
    dvs = [
        (wm[..., f : 2 * f] * (phi1 * v[:, :, c * f : (c + 1) * f])[:, None]).sum(dim=2)
        for c in range(3)
    ]
    m3 = wm[..., 2 * f :] * phi[:, None, :, 2 * f :]
    dvu = torch.einsum("bicj,bijf->bicf", unit_t, m3)
    dv = torch.cat(dvs, dim=-1) + dvu.reshape(*ds.shape[:2], 3 * f)
    return ds, dv


def painn_message_bwd_reference(rbf, rbfp, phi, v, unit_t, w, gds, gdv, need_gw: bool = True):
    """Plain PyTorch version of kernel B: the VJP of kernel A.

    Returns (g_dist [B,A,A], g_unit_t [B,A,3,A], gphi [B,A,3F], gv [B,A,3F],
    gw [R,3F] or None), with g_dist = Σ_f gwm ⊙ (rbfp @ W). Float32
    arithmetic; on bf16 inputs every output but g_dist rounded to bf16.
    """
    out = _widened(_message_bwd, rbf, rbfp, phi, v, unit_t, w, gds, gdv, need_gw=need_gw)
    return (out[0],) + _rounded(out[1:], rbf.dtype)


def _message_bwd(rbf, rbfp, phi, v, unit_t, w, gds, gdv, need_gw: bool = True):
    f = w.shape[1] // 3
    b_, a = phi.shape[0], phi.shape[1]
    wm = torch.einsum("bijr,rk->bijk", rbf, w)
    rpw = torch.einsum("bijr,rk->bijk", rbfp, w)
    phi0, phi1, phi2 = phi[..., :f], phi[..., f : 2 * f], phi[..., 2 * f :]
    g2c = gdv.reshape(b_, a, 3, f)
    vc = v.reshape(b_, a, 3, f)

    # channel 0
    gwm0 = gds[:, :, None, :] * phi0[:, None, :, :]
    gphi0 = (gds[:, :, None, :] * wm[..., :f]).sum(dim=1)
    # channel 1: gwm1 = φ1_j Σ_c g2_c[i] v_c[j];  s_c[j] = Σ_i g2_c[i] wm1[i,j]
    gwm1 = torch.einsum("bicf,bjcf->bijf", g2c, vc) * phi1[:, None, :, :]
    s = torch.einsum("bicf,bijf->bjcf", g2c, wm[..., f : 2 * f])
    gphi1 = (s * vc).sum(dim=2)
    gv = (s * phi1[:, :, None, :]).reshape(b_, a, 3 * f)
    # channel 2: pa[i,j] = Σ_c u_c[i,j] g2_c[i]
    pa = torch.einsum("bicj,bicf->bijf", unit_t, g2c)
    gwm2 = pa * phi2[:, None, :, :]
    m3 = wm[..., 2 * f :] * phi2[:, None, :, :]
    g_unit_t = torch.einsum("bijf,bicf->bicj", m3, g2c)
    gphi2 = (pa * wm[..., 2 * f :]).sum(dim=1)

    gwm = torch.cat([gwm0, gwm1, gwm2], dim=-1)  # [B,A,A,3F]
    g_dist = (gwm * rpw).sum(dim=-1)
    gphi = torch.cat([gphi0, gphi1, gphi2], dim=-1)
    gw = torch.einsum("bijr,bijk->rk", rbf, gwm) if need_gw else None
    return g_dist, g_unit_t, gphi, gv, gw


def _chunks(x, f):
    return x[..., :f], x[..., f : 2 * f], x[..., 2 * f :]


def painn_dual_fwd_reference(rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w):
    """Plain PyTorch version of kernel C: kernel A and its directional
    derivative along (rbfd, phid, vd, unitd_t), w held fixed.

    Returns (ds [B,A,F], dv [B,A,3F], dsd [B,A,F], dvd [B,A,3F]): float32
    arithmetic, the outputs in the inputs' dtype.
    """
    return _rounded(_widened(_dual_fwd, rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w),
                    rbf.dtype)


def _dual_fwd(rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w):
    f = w.shape[1] // 3
    b_, a = phi.shape[0], phi.shape[1]
    wm0, wm1, wm2 = _chunks(torch.einsum("bijr,rk->bijk", rbf, w), f)
    wmd0, wmd1, wmd2 = _chunks(torch.einsum("bijr,rk->bijk", rbfd, w), f)
    phi0, phi1, phi2 = (x[:, None] for x in _chunks(phi, f))
    phid0, phid1, phid2 = (x[:, None] for x in _chunks(phid, f))
    vc, vdc = v.reshape(b_, a, 3, f), vd.reshape(b_, a, 3, f)

    ds = (wm0 * phi0).sum(dim=2)
    dsd = (wmd0 * phi0 + wm0 * phid0).sum(dim=2)
    # channel 1: t = wm1 φ1, td = wmd1 φ1 + wm1 φd1; Σ_j t v_c and Σ_j td v_c + t vd_c
    t, td = wm1 * phi1, wmd1 * phi1 + wm1 * phid1
    dv1 = torch.einsum("bijf,bjcf->bicf", t, vc)
    dvd1 = torch.einsum("bijf,bjcf->bicf", td, vc) + torch.einsum("bijf,bjcf->bicf", t, vdc)
    # channel 2: m3 = wm2 φ2, m3d = wmd2 φ2 + wm2 φd2
    m3, m3d = wm2 * phi2, wmd2 * phi2 + wm2 * phid2
    dv2 = torch.einsum("bicj,bijf->bicf", unit_t, m3)
    dvd2 = (torch.einsum("bicj,bijf->bicf", unitd_t, m3)
            + torch.einsum("bicj,bijf->bicf", unit_t, m3d))
    return ds, (dv1 + dv2).reshape(b_, a, 3 * f), dsd, (dvd1 + dvd2).reshape(b_, a, 3 * f)


def painn_dual_bwd_reference(rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w,
                             gds, gdv, gdsd, gdvd, need_gw: bool = True):
    """Plain PyTorch version of kernel D: the VJP of kernel C for the node
    inputs and w (the pair-level inputs get none).

    Returns (gphi, gphid, gv, gvd [B,A,3F], gw [R,3F] or None): float32
    arithmetic, the outputs in the inputs' dtype.
    """
    return _rounded(_widened(_dual_bwd, rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w, gds,
                             gdv, gdsd, gdvd, need_gw=need_gw), rbf.dtype)


def _dual_bwd(rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w, gds, gdv, gdsd, gdvd,
              need_gw: bool = True):
    f = w.shape[1] // 3
    b_, a = phi.shape[0], phi.shape[1]
    wm0, wm1, wm2 = _chunks(torch.einsum("bijr,rk->bijk", rbf, w), f)
    wmd0, wmd1, wmd2 = _chunks(torch.einsum("bijr,rk->bijk", rbfd, w), f)
    phi0, phi1, phi2 = _chunks(phi, f)
    phid0, phid1, phid2 = _chunks(phid, f)
    vc, vdc = v.reshape(b_, a, 3, f), vd.reshape(b_, a, 3, f)
    g1, g1d = gds[:, :, None], gdsd[:, :, None]  # [B,A(i),1,F]
    g2c, g2dc = gdv.reshape(b_, a, 3, f), gdvd.reshape(b_, a, 3, f)

    # channel 0
    gphi0 = (g1 * wm0 + g1d * wmd0).sum(dim=1)
    gphid0 = (g1d * wm0).sum(dim=1)
    # channel 1: s_c[j] = Σ_i g2_c wm1 + g2d_c wmd1, sd_c[j] = Σ_i g2d_c wm1
    s = (torch.einsum("bicf,bijf->bjcf", g2c, wm1)
         + torch.einsum("bicf,bijf->bjcf", g2dc, wmd1))
    sd = torch.einsum("bicf,bijf->bjcf", g2dc, wm1)
    gphi1 = (s * vc + sd * vdc).sum(dim=2)
    gphid1 = (sd * vc).sum(dim=2)
    gv = (s * phi1[:, :, None] + sd * phid1[:, :, None]).reshape(b_, a, 3 * f)
    gvd = (sd * phi1[:, :, None]).reshape(b_, a, 3 * f)
    # channel 2: pa = Σ_c u_c g2_c + ud_c g2d_c, pb = Σ_c u_c g2d_c  ([B,A(i),A(j),F])
    pa = (torch.einsum("bicj,bicf->bijf", unit_t, g2c)
          + torch.einsum("bicj,bicf->bijf", unitd_t, g2dc))
    pb = torch.einsum("bicj,bicf->bijf", unit_t, g2dc)
    gphi2 = (pa * wm2 + pb * wmd2).sum(dim=1)
    gphid2 = (pb * wm2).sum(dim=1)

    gphi = torch.cat([gphi0, gphi1, gphi2], dim=-1)
    gphid = torch.cat([gphid0, gphid1, gphid2], dim=-1)
    gw = None
    if need_gw:
        # per-pair cotangents of wm and wmd, channel by channel
        q = phi1[:, None, :, None] * vc[:, None]  # [B,1,A(j),3,F]
        qd = phid1[:, None, :, None] * vc[:, None] + phi1[:, None, :, None] * vdc[:, None]
        gwm = torch.cat([
            g1 * phi0[:, None] + g1d * phid0[:, None],
            (g2c[:, :, None] * q + g2dc[:, :, None] * qd).sum(dim=3),
            pa * phi2[:, None] + pb * phid2[:, None],
        ], dim=-1)
        gwmd = torch.cat([
            g1d * phi0[:, None],
            (g2dc[:, :, None] * q).sum(dim=3),
            pb * phi2[:, None],
        ], dim=-1)
        gw = torch.einsum("bijr,bijk->rk", rbf, gwm) + torch.einsum("bijr,bijk->rk", rbfd, gwmd)
    return gphi, gphid, gv, gvd, gw


def painn_live_pairs(rbf, rbf2):
    """Kernels B's and D's live-pair list: the slots (b, j, i) whose row
    rbf[b,i,j] or rbf2[b,i,j] is not zero, in sender order. Returns (slots,
    rows, starts): `rows` the pair rows (b·A + i)·A + j of the slots,
    `starts[b·A + j]` the first list index of sender j (`starts[B·A]` the
    count)."""
    b, a = rbf.shape[:2]
    live = (rbf != 0).any(-1) | (rbf2 != 0).any(-1)  # [B, A(i), A(j)]
    slots = live.transpose(1, 2).reshape(-1).nonzero().squeeze(1)
    bj, i = slots // a, slots % a
    rows = (bj // a * a + i) * a + bj % a
    counts = torch.bincount(bj, minlength=b * a)
    starts = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return slots, rows, starts


def painn_live_rows(rbf, rbf2=None):
    """Kernels A's and C's live-pair list: the pair rows (b·A + i)·A + j
    whose rbf row, or rbf2 row where given, is not zero, in receiver order.
    Returns (rows, starts): `starts[b·A + i]` the first list index of
    receiver i (`starts[B·A]` the count)."""
    b, a = rbf.shape[:2]
    live = (rbf != 0).any(-1)
    if rbf2 is not None:
        live = live | (rbf2 != 0).any(-1)
    rows = live.reshape(-1).nonzero().squeeze(1)
    counts = torch.bincount(rows // a, minlength=b * a)
    return rows, torch.cat([counts.new_zeros(1), counts.cumsum(0)])


def _receiver_pairs(rows, b, a):
    """(receiver b·A + i, sender b·A + j) of the pair rows, and the sums
    over each receiver's pairs in list order."""
    recv = rows // a
    sender = recv // a * a + rows % a
    sums = lambda x: x.new_zeros(b * a, *x.shape[1:]).index_add_(0, recv, x)  # noqa: E731
    return sender, sums


def painn_fwd_staged(rbf, phi, v, unit_t, w):
    """Kernel A's stages in the card's order, on plain tensors: the live
    pairs in receiver order (`painn_live_rows` of rbf); wm = rbf @ W over
    them (the products); the per-receiver stage, per receiver i over its
    live senders j: ds and dv, zero for a receiver with no live sender.
    Returns painn_message_reference's tuple."""
    b, a, _, r = rbf.shape
    f = w.shape[1] // 3
    rows, _ = painn_live_rows(rbf)
    sender, sums = _receiver_pairs(rows, b, a)
    wm0, wm1, wm2 = _chunks(rbf.reshape(-1, r)[rows] @ w, f)
    p0, p1, p2 = _chunks(phi.reshape(b * a, 3 * f)[sender], f)
    vj = v.reshape(b * a, 3, f)[sender]
    u = unit_t.transpose(2, 3).reshape(b * a * a, 3)[rows][:, :, None]  # u[b,i,j,c]
    ds = sums(wm0 * p0)
    dv = sums((wm1 * p1)[:, None] * vj + u * (wm2 * p2)[:, None])
    return ds.reshape(b, a, f), dv.reshape(b, a, 3 * f)


def painn_dual_fwd_staged(rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w):
    """Kernel C's stages in the card's order, on plain tensors: the live
    pairs in receiver order (rbf or rbfd row not zero); wm = rbf @ W and
    wmd = rbfd @ W over them; the per-receiver stage over each receiver's
    live senders. Returns painn_dual_fwd_reference's tuple."""
    b, a, _, r = rbf.shape
    f = w.shape[1] // 3
    rows, _ = painn_live_rows(rbf, rbfd)
    sender, sums = _receiver_pairs(rows, b, a)
    wm0, wm1, wm2 = _chunks(rbf.reshape(-1, r)[rows] @ w, f)
    wmd0, wmd1, wmd2 = _chunks(rbfd.reshape(-1, r)[rows] @ w, f)
    p0, p1, p2 = _chunks(phi.reshape(b * a, 3 * f)[sender], f)
    pd0, pd1, pd2 = _chunks(phid.reshape(b * a, 3 * f)[sender], f)
    vj, vdj = v.reshape(b * a, 3, f)[sender], vd.reshape(b * a, 3, f)[sender]
    u = unit_t.transpose(2, 3).reshape(b * a * a, 3)[rows][:, :, None]
    ud = unitd_t.transpose(2, 3).reshape(b * a * a, 3)[rows][:, :, None]
    t, td = (wm1 * p1)[:, None], (wmd1 * p1 + wm1 * pd1)[:, None]
    m3, m3d = (wm2 * p2)[:, None], (wmd2 * p2 + wm2 * pd2)[:, None]
    ds, dsd = sums(wm0 * p0), sums(wmd0 * p0 + wm0 * pd0)
    dv = sums(t * vj + u * m3)
    dvd = sums(td * vj + t * vdj + ud * m3 + u * m3d)
    node, vec = (b, a, f), (b, a, 3 * f)
    return ds.reshape(node), dv.reshape(vec), dsd.reshape(node), dvd.reshape(vec)


def painn_bwd_staged(rbf, rbfp, phi, v, unit_t, w, gds, gdv, need_gw: bool = True):
    """Kernel B's stages in the card's order, on plain tensors: the live
    pairs in sender order (`painn_live_pairs` of rbf, rbfp); wm = rbf @ W
    and rp = rbfp @ W over them (the products); the per-pair stage, per
    sender j over its live receivers i: g_dist and g_unit_t of each live
    pair (zeros in the dead slots), gphi and gv, and the cotangent gwm;
    then gW = rbf_liveᵀ gwm. Returns painn_message_bwd_reference's tuple."""
    b, a, _, r = rbf.shape
    f = w.shape[1] // 3
    slots, rows, _ = painn_live_pairs(rbf, rbfp)
    sender, i = slots // a, slots % a  # sender = b·A + j
    recv = sender // a * a + i         # b·A + i
    rbf_l = rbf.reshape(-1, r)[rows]
    wm, rp = rbf_l @ w, rbfp.reshape(-1, r)[rows] @ w

    # the stage: node rows of the sender j and the receiver i, per live pair
    p0, p1, p2 = _chunks(phi.reshape(b * a, 3 * f)[sender], f)
    vj = v.reshape(b * a, 3, f)[sender]
    g1, g2 = gds.reshape(b * a, f)[recv], gdv.reshape(b * a, 3, f)[recv]
    u = unit_t.transpose(2, 3).reshape(b * a * a, 3)[rows]  # u[b,i,j,c]
    wm0, wm1, wm2 = _chunks(wm, f)
    pa = (u[:, :, None] * g2).sum(1)
    gwm = torch.cat([g1 * p0, p1 * (g2 * vj).sum(1), pa * p2], dim=-1)
    g_dist = phi.new_zeros(b * a * a)
    g_dist[rows] = (gwm * rp).sum(-1)
    g_ut = phi.new_zeros(b * a * a, 3)
    g_ut[rows] = ((wm2 * p2)[:, None] * g2).sum(-1)
    sums = lambda x: x.new_zeros(b * a, *x.shape[1:]).index_add_(0, sender, x)  # noqa: E731
    s = sums(g2 * wm1[:, None])  # s_c[j] = Σ_i g2_c[i] wm1[i,j]
    phi1 = phi.reshape(b * a, 3, f)[:, 1]
    gphi = torch.cat([sums(g1 * wm0), (s * v.reshape(b * a, 3, f)).sum(1), sums(pa * wm2)], -1)
    gv = s * phi1[:, None]
    gw = rbf_l.T @ gwm if need_gw else None
    return (g_dist.reshape(b, a, a), g_ut.reshape(b, a, a, 3).transpose(2, 3).contiguous(),
            gphi.reshape(b, a, 3 * f), gv.reshape(b, a, 3 * f), gw)


def painn_dual_bwd_staged(rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w,
                          gds, gdv, gdsd, gdvd, need_gw: bool = True):
    """Kernel D's stages in the card's order, on plain tensors: the live
    pairs in sender order (rbf or rbfd row not zero); wm = rbf @ W and
    wmd = rbfd @ W over them; the per-pair stage, per sender j over its live
    receivers: the node sums and, at the end, the sender's node factors; the
    per-pair cotangents gwm and gwmd; then gW = rbf_liveᵀ gwm +
    rbfd_liveᵀ gwmd. Returns painn_dual_bwd_reference's tuple."""
    b, a, _, r = rbf.shape
    f = w.shape[1] // 3
    slots, rows, _ = painn_live_pairs(rbf, rbfd)
    sender, i = slots // a, slots % a
    recv = sender // a * a + i
    rbf_l, rbfd_l = rbf.reshape(-1, r)[rows], rbfd.reshape(-1, r)[rows]
    wm0, wm1, wm2 = _chunks(rbf_l @ w, f)
    wmd0, wmd1, wmd2 = _chunks(rbfd_l @ w, f)

    g1, g1d = gds.reshape(b * a, f)[recv], gdsd.reshape(b * a, f)[recv]
    g2, h = gdv.reshape(b * a, 3, f)[recv], gdvd.reshape(b * a, 3, f)[recv]
    u = unit_t.transpose(2, 3).reshape(b * a * a, 3)[rows][:, :, None]
    ud = unitd_t.transpose(2, 3).reshape(b * a * a, 3)[rows][:, :, None]
    pa = (u * g2 + ud * h).sum(1)
    pb = (u * h).sum(1)
    sums = lambda x: x.new_zeros(b * a, *x.shape[1:]).index_add_(0, sender, x)  # noqa: E731
    s = sums(g2 * wm1[:, None] + h * wmd1[:, None])
    sd = sums(h * wm1[:, None])
    # the epilogue: the sender's node factors
    phi0, phi1, phi2 = _chunks(phi.reshape(b * a, 3 * f), f)
    phid0, phid1, phid2 = _chunks(phid.reshape(b * a, 3 * f), f)
    vc, vdc = v.reshape(b * a, 3, f), vd.reshape(b * a, 3, f)
    gphi = torch.cat([sums(g1 * wm0 + g1d * wmd0), (s * vc + sd * vdc).sum(1),
                      sums(pa * wm2 + pb * wmd2)], -1)
    gphid = torch.cat([sums(g1d * wm0), (sd * vc).sum(1), sums(pb * wm2)], -1)
    gv = s * phi1[:, None] + sd * phid1[:, None]
    gvd = sd * phi1[:, None]
    gw = None
    if need_gw:
        t1 = (g2 * vc[sender] + h * vdc[sender]).sum(1)
        t2 = (h * vc[sender]).sum(1)
        gwm = torch.cat([g1 * phi0[sender] + g1d * phid0[sender],
                         phi1[sender] * t1 + phid1[sender] * t2,
                         pa * phi2[sender] + pb * phid2[sender]], -1)
        gwmd = torch.cat([g1d * phi0[sender], phi1[sender] * t2, pb * phi2[sender]], -1)
        gw = rbf_l.T @ gwm + rbfd_l.T @ gwmd
    shape = (b, a, 3 * f)
    return (gphi.reshape(shape), gphid.reshape(shape), gv.reshape(shape), gvd.reshape(shape), gw)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load("painn_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.painn_fwd_scratch_floats.argtypes = [i] * 5
    lib.painn_fwd_scratch_floats.restype = ctypes.c_longlong
    lib.painn_fwd_scratch_ints.argtypes = [i] * 2
    lib.painn_fwd_scratch_ints.restype = ctypes.c_longlong
    lib.painn_fwd.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.painn_fwd.restype = i
    lib.painn_bwd_scratch_floats.argtypes = [i] * 4
    lib.painn_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.painn_bwd_scratch_ints.argtypes = [i] * 2
    lib.painn_bwd_scratch_ints.restype = ctypes.c_longlong
    lib.painn_bwd.argtypes = [p] * 15 + [i] * 6 + [p]
    lib.painn_bwd.restype = i
    lib.painn_dual_fwd.argtypes = [p] * 15 + [i] * 5 + [p]
    lib.painn_dual_fwd.restype = i
    lib.painn_dual_bwd.argtypes = [p] * 20 + [i] * 6 + [p]
    lib.painn_dual_bwd.restype = i
    for name in ("painn_fwd", "painn_bwd", "painn_dual_fwd", "painn_dual_bwd"):
        bf = getattr(lib, name + "_bf16")
        bf.argtypes, bf.restype = getattr(lib, name).argtypes, i
    return lib


def _entry(name: str, dtype: torch.dtype):
    """The entry point of kernel `name` for inputs of `dtype`."""
    return getattr(_lib(), name if dtype == torch.float32 else name + "_bf16")


def _shapes(phi, w):
    b, a = phi.shape[0], phi.shape[1]
    r, f3 = w.shape
    if f3 % 3:
        raise ValueError(f"w has {f3} columns, expected 3F")
    return b, a, r, f3 // 3


def painn_fwd(rbf, phi, v, unit_t, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A: (ds [B,A,F], dv [B,A,3F])."""
    b, a, r, f = _shapes(phi, w)
    dev = _kernels.check_inputs(
        dict(rbf=rbf, phi=phi, v=v, unit_t=unit_t, w=w),
        dict(rbf=(b, a, a, r), phi=(b, a, 3 * f), v=(b, a, 3 * f),
             unit_t=(b, a, 3, a), w=(r, 3 * f)), DTYPES,
    )
    if dev.type == "cpu":
        return painn_message_reference(rbf, phi, v, unit_t, w)
    dt = rbf.dtype
    w_e, r4, ld, (rbf_e,) = _engine_operands(w, rbf)
    ds = torch.empty((b, a, f), dtype=dt, device=dev)
    dv = torch.empty((b, a, 3 * f), dtype=dt, device=dev)
    scratch, iscratch = _fwd_buffers(dev, b, a, r4, ld, sets=1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry("painn_fwd", dt)(
            rbf_e.data_ptr(), phi.data_ptr(), v.data_ptr(), unit_t.data_ptr(), w_e.data_ptr(),
            ds.data_ptr(), dv.data_ptr(), scratch.data_ptr(), iscratch.data_ptr(),
            b, a, r4, f, ld, stream,
        )
    _kernels.raise_on_error(err, "painn_fwd launch")
    _count("painn_fwd", dt)
    return ds, dv


def _engine_operands(w, *pairs):
    """(W, R, ld, pair tensors) as the kernels take them: R a multiple of 4
    and W's rows ld = 3F rounded up to 4 floats, zero padded (a copy only off
    those multiples; painn-oc's R = 100, 3F = 384 need none). W goes in
    float32 (a bf16 W widened, exactly: a few hundred kB; the pair tensors
    stay in their dtype)."""
    w = w.float()
    r, f3 = w.shape
    r4, ld = -(-r // 4) * 4, -(-f3 // 4) * 4
    if r4 != r:
        pairs = [torch.nn.functional.pad(t, (0, r4 - r)) for t in pairs]
    if (r4, ld) != (r, f3):
        w = torch.nn.functional.pad(w, (0, ld - f3, 0, r4 - r))
    return w, r4, ld, pairs


def _fwd_buffers(dev, b, a, r4, ld, sets):
    """(float scratch, int scratch) of an A (sets 1) or C (sets 2) launch."""
    lib = _lib()
    return (torch.empty(lib.painn_fwd_scratch_floats(b, a, r4, ld, sets), dtype=torch.float32,
                        device=dev),
            torch.empty(lib.painn_fwd_scratch_ints(b, a), dtype=torch.int32, device=dev))


def _bwd_buffers(dev, b, a, r4, ld, need_gw):
    """(gW [R4, ld] or None, float scratch, int scratch) of a B or D launch."""
    lib = _lib()
    gw = torch.empty((r4, ld), dtype=torch.float32, device=dev) if need_gw else None
    return (gw, torch.empty(lib.painn_bwd_scratch_floats(b, a, r4, ld), dtype=torch.float32,
                            device=dev),
            torch.empty(lib.painn_bwd_scratch_ints(b, a), dtype=torch.int32, device=dev))


def painn_bwd(rbf, rbfp, phi, v, unit_t, w, gds, gdv, need_gw: bool = True):
    """Kernel B: (g_dist, g_unit_t, gphi, gv, gw or None)."""
    b, a, r, f = _shapes(phi, w)
    dev = _kernels.check_inputs(
        dict(rbf=rbf, rbfp=rbfp, phi=phi, v=v, unit_t=unit_t, w=w, gds=gds, gdv=gdv),
        dict(rbf=(b, a, a, r), rbfp=(b, a, a, r), phi=(b, a, 3 * f), v=(b, a, 3 * f),
             unit_t=(b, a, 3, a), w=(r, 3 * f), gds=(b, a, f), gdv=(b, a, 3 * f)), DTYPES,
    )
    if dev.type == "cpu":
        return painn_message_bwd_reference(rbf, rbfp, phi, v, unit_t, w, gds, gdv, need_gw)
    dt = rbf.dtype
    w_e, r4, ld, (rbf_e, rbfp_e) = _engine_operands(w, rbf, rbfp)
    # the dead pairs' slots keep these zeros
    g_dist = torch.zeros((b, a, a), dtype=torch.float32, device=dev)
    g_ut = torch.zeros((b, a, 3, a), dtype=torch.float32, device=dev)
    gphi, gv = (torch.empty((b, a, 3 * f), dtype=torch.float32, device=dev) for _ in range(2))
    gw, scratch, iscratch = _bwd_buffers(dev, b, a, r4, ld, need_gw)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry("painn_bwd", dt)(
            rbf_e.data_ptr(), rbfp_e.data_ptr(), phi.data_ptr(), v.data_ptr(),
            unit_t.data_ptr(), w_e.data_ptr(), gds.data_ptr(), gdv.data_ptr(),
            g_dist.data_ptr(), g_ut.data_ptr(), gphi.data_ptr(), gv.data_ptr(),
            0 if gw is None else gw.data_ptr(), scratch.data_ptr(), iscratch.data_ptr(),
            int(need_gw), b, a, r4, f, ld, stream,
        )
    _kernels.raise_on_error(err, "painn_bwd launch")
    _count("painn_bwd", dt)
    _count("painn_bwd_gw", dt, int(need_gw))
    if gw is not None and gw.shape != (r, 3 * f):
        gw = gw[:r, :3 * f].contiguous()
    return (g_dist,) + _rounded((g_ut, gphi, gv, gw), dt)


def _dual_shapes(b, a, r, f):
    node, pair, ut = (b, a, 3 * f), (b, a, a, r), (b, a, 3, a)
    return dict(rbf=pair, rbfd=pair, phi=node, phid=node, v=node, vd=node,
                unit_t=ut, unitd_t=ut, w=(r, 3 * f), gds=(b, a, f), gdv=node,
                gdsd=(b, a, f), gdvd=node)


def painn_dual_fwd(rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w):
    """Kernel C: (ds [B,A,F], dv [B,A,3F], dsd [B,A,F], dvd [B,A,3F])."""
    b, a, r, f = _shapes(phi, w)
    args = dict(rbf=rbf, rbfd=rbfd, phi=phi, phid=phid, v=v, vd=vd, unit_t=unit_t,
                unitd_t=unitd_t, w=w)
    dev = _kernels.check_inputs(args, _dual_shapes(b, a, r, f), DTYPES)
    if dev.type == "cpu":
        return painn_dual_fwd_reference(*args.values())
    dt = rbf.dtype
    args["w"], r4, ld, (args["rbf"], args["rbfd"]) = _engine_operands(w, rbf, rbfd)
    empty = lambda *shape: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    ds, dv, dsd, dvd = empty(b, a, f), empty(b, a, 3 * f), empty(b, a, f), empty(b, a, 3 * f)
    scratch, iscratch = _fwd_buffers(dev, b, a, r4, ld, sets=2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry("painn_dual_fwd", dt)(
            *(t.data_ptr() for t in args.values()),
            ds.data_ptr(), dv.data_ptr(), dsd.data_ptr(), dvd.data_ptr(), scratch.data_ptr(),
            iscratch.data_ptr(), b, a, r4, f, ld, stream,
        )
    _kernels.raise_on_error(err, "painn_dual_fwd launch")
    _count("painn_dual_fwd", dt)
    return ds, dv, dsd, dvd


def painn_dual_bwd(rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w, gds, gdv, gdsd, gdvd,
                   need_gw: bool = True):
    """Kernel D: (gphi, gphid, gv, gvd [B,A,3F], gw [R,3F] or None)."""
    b, a, r, f = _shapes(phi, w)
    args = dict(rbf=rbf, rbfd=rbfd, phi=phi, phid=phid, v=v, vd=vd, unit_t=unit_t,
                unitd_t=unitd_t, w=w, gds=gds, gdv=gdv, gdsd=gdsd, gdvd=gdvd)
    dev = _kernels.check_inputs(args, _dual_shapes(b, a, r, f), DTYPES)
    if dev.type == "cpu":
        return painn_dual_bwd_reference(*args.values(), need_gw=need_gw)
    dt = rbf.dtype
    args["w"], r4, ld, (args["rbf"], args["rbfd"]) = _engine_operands(w, rbf, rbfd)
    gphi, gphid, gv, gvd = (torch.empty((b, a, 3 * f), dtype=torch.float32, device=dev)
                            for _ in range(4))
    gw, scratch, iscratch = _bwd_buffers(dev, b, a, r4, ld, need_gw)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry("painn_dual_bwd", dt)(
            *(t.data_ptr() for t in args.values()),
            gphi.data_ptr(), gphid.data_ptr(), gv.data_ptr(), gvd.data_ptr(),
            0 if gw is None else gw.data_ptr(), scratch.data_ptr(), iscratch.data_ptr(),
            int(need_gw), b, a, r4, f, ld, stream,
        )
    _kernels.raise_on_error(err, "painn_dual_bwd launch")
    _count("painn_dual_bwd", dt)
    if gw is not None and gw.shape != (r, 3 * f):
        gw = gw[:r, :3 * f].contiguous()
    return _rounded((gphi, gphid, gv, gvd, gw), dt)


class PaiNNMessageFn(torch.autograd.Function):
    """`painn_message`'s custom VJP: forward = kernel A, backward = kernel B.

    Inputs (dist, rbf, rbfp, phi, v, unit_t, w); rbf/rbfp get no gradient,
    dist gets g_dist (the radial chain folded through rbfp).
    """

    @staticmethod
    def forward(ctx, dist, rbf, rbfp, phi, v, unit_t, w):
        ds, dv = painn_fwd(rbf, phi, v, unit_t, w)
        ctx.save_for_backward(rbf, rbfp, phi, v, unit_t, w)
        return ds, dv

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gds, gdv):
        rbf, rbfp, phi, v, unit_t, w = ctx.saved_tensors
        g_dist, g_ut, gphi, gv, gw = painn_bwd(
            rbf, rbfp, phi, v, unit_t, w, gds.contiguous(), gdv.contiguous(),
            need_gw=ctx.needs_input_grad[6],
        )
        return g_dist, None, None, gphi, gv, g_ut, gw


def painn_message(dist, rbf, rbfp, phi, v, unit_t, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-order fused PaiNN message (inference / forces). Returns
    (ds [B,A,F], dv [B,A,3F] c-major)."""
    return PaiNNMessageFn.apply(dist, rbf, rbfp, phi, v, unit_t, w)


class PaiNNDualFn(torch.autograd.Function):
    """`painn_dual`'s custom VJP: forward = kernel C, backward = kernel D.

    Inputs (rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w); outputs
    (ds, dv, dsd, dvd). The pair-level inputs get no gradient.
    """

    @staticmethod
    def forward(ctx, rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w):
        ctx.save_for_backward(rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w)
        return painn_dual_fwd(rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gds, gdv, gdsd, gdvd):
        gphi, gphid, gv, gvd, gw = painn_dual_bwd(
            *ctx.saved_tensors, gds.contiguous(), gdv.contiguous(), gdsd.contiguous(),
            gdvd.contiguous(), need_gw=ctx.needs_input_grad[8],
        )
        return None, None, gphi, gphid, gv, gvd, None, None, gw


def painn_dual(rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w):
    """Dual-number fused PaiNN message: (ds, dv, dsd, dvd), primal and
    tangent lanes in one kernel. Differentiable (once) in the node inputs
    and w only: for the surrogate's parameter pass."""
    return PaiNNDualFn.apply(rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w)


def _live_pairs(*pair_tensors) -> int:
    live = None
    for t in pair_tensors:
        nz = (t != 0).any(dim=-1)
        live = nz if live is None else live | nz
    return int(live.sum())


def painn_fwd_flops_bytes(rbf: torch.Tensor, f: int) -> Tuple[int, int]:
    """(FLOPs, bytes) kernel A needs on these inputs: FLOPs counted over the
    pairs whose rbf row is nonzero (masked pairs need no work), bytes with
    each input read once and each output written once, in the inputs' dtype
    (2 bytes a value in bf16; B's g_dist is float32 in both modes)."""
    b, a, _, r = rbf.shape
    live = _live_pairs(rbf)
    flops = pair_flops("fwd", r, f) * live
    nbytes = rbf.element_size() * (rbf.numel() + 2 * b * a * 3 * f + b * a * 3 * a + r * 3 * f
                  + b * a * f + b * a * 3 * f)
    return flops, nbytes


def painn_bwd_flops_bytes(rbf: torch.Tensor, rbfp: torch.Tensor, f: int,
                          need_gw: bool = True) -> Tuple[int, int]:
    """(FLOPs, bytes) kernel B needs on these inputs (see painn_fwd_flops_bytes;
    the live pairs are those whose rbf or rbfp row is not zero)."""
    b, a, _, r = rbf.shape
    live = _live_pairs(rbf, rbfp)
    flops = pair_flops("bwd", r, f) * live
    if need_gw:
        flops += pair_flops("bwd_gw", r, f) * live
    nbytes = rbf.element_size() * (
        2 * rbf.numel() + 2 * b * a * 3 * f + b * a * 3 * a + r * 3 * f
        + b * a * f + b * a * 3 * f                   # gds, gdv
        + b * a * 3 * a + 2 * b * a * 3 * f           # g_unit_t, gphi, gv
        + (r * 3 * f if need_gw else 0)) + 4 * b * a * a  # g_dist
    return flops, nbytes


def painn_dual_fwd_flops_bytes(rbf: torch.Tensor, rbfd: torch.Tensor, f: int) -> Tuple[int, int]:
    """(FLOPs, bytes) kernel C needs on these inputs: FLOPs over the pairs
    whose rbf or rbfd row is nonzero, bytes with each input read once and
    each output written once."""
    b, a, _, r = rbf.shape
    flops = pair_flops("dual_fwd", r, f) * _live_pairs(rbf, rbfd)
    nbytes = rbf.element_size() * (
        2 * rbf.numel() + 4 * b * a * 3 * f + 2 * b * a * 3 * a + r * 3 * f
        + 2 * (b * a * f + b * a * 3 * f))
    return flops, nbytes


def painn_dual_bwd_flops_bytes(rbf: torch.Tensor, rbfd: torch.Tensor, f: int,
                               need_gw: bool = True) -> Tuple[int, int]:
    """(FLOPs, bytes) kernel D needs on these inputs (see
    painn_dual_fwd_flops_bytes)."""
    b, a, _, r = rbf.shape
    live = _live_pairs(rbf, rbfd)
    flops = pair_flops("dual_bwd", r, f) * live
    if need_gw:
        flops += pair_flops("dual_bwd_gw", r, f) * live
    nbytes = rbf.element_size() * (
        2 * rbf.numel() + 4 * b * a * 3 * f + 2 * b * a * 3 * a + r * 3 * f
        + 2 * (b * a * f + b * a * 3 * f)  # gds, gdv, gdsd, gdvd
        + 4 * b * a * 3 * f                # gphi, gphid, gv, gvd
        + (r * 3 * f if need_gw else 0))
    return flops, nbytes


def fwd_work(kind: str, rbf: torch.Tensor, rbf2: torch.Tensor, f: int) -> Dict[str, int]:
    """The work of kernel A (`kind` "A"; rbf2 unused) or C ("C", rbf2 = rbfd)
    on these inputs, as `bwd_work` gives it: the radial products (on the
    tensor cores) split from the rest."""
    b, a, _, r = rbf.shape
    if kind == "A":
        live, (flops, nbytes) = _live_pairs(rbf), painn_fwd_flops_bytes(rbf, f)
    else:
        live, (flops, nbytes) = _live_pairs(rbf, rbf2), painn_dual_fwd_flops_bytes(rbf, rbf2, f)
    prod, other = flops_split("fwd" if kind == "A" else "dual_fwd", r, f)
    return {"flops_live": flops, "flops_live_products": prod * live,
            "flops_live_other": other * live, "bytes": nbytes, "live_pairs": live,
            "pairs": b * a * a, **_operands(rbf, prod * live, 0)}


def _operands(rbf: torch.Tensor, both: int, rows: int) -> Dict[str, int]:
    """The products' split by operand dtype in the bf16 mode: bf16 rows
    against bf16 W ("flops_live_products_bf16") and bf16 rows against the
    fp32 cotangents of gW ("flops_live_products_bf16_rows"); none in fp32."""
    if rbf.dtype != torch.bfloat16:
        return {}
    return {"flops_live_products_bf16": both, "flops_live_products_bf16_rows": rows}


def bwd_work(kind: str, rbf: torch.Tensor, rbf2: torch.Tensor, f: int,
             need_gw: bool = True) -> Dict[str, int]:
    """The work of kernel B (`kind` "B", rbf2 = rbfp) or D ("D", rbf2 = rbfd)
    on these inputs, over the live pairs (rbf or rbf2 row not zero):
    "flops_live" as painn_bwd_flops_bytes / painn_dual_bwd_flops_bytes count
    it, "flops_live_products" / "flops_live_other" its split (`flops_split`:
    the radial products, on the tensor cores, and the per-pair rest), "bytes"
    each input read once and each output written once, and the live and all
    pairs."""
    b, a, _, r = rbf.shape
    live = _live_pairs(rbf, rbf2)
    kinds = {"B": ("bwd", "bwd_gw"), "D": ("dual_bwd", "dual_bwd_gw")}[kind]
    prod = other = gw = 0
    for k in kinds[: 1 + int(need_gw)]:
        p, o = flops_split(k, r, f)
        prod, other = prod + p * live, other + o * live
        gw += p * live if k.endswith("_gw") else 0
    if kind == "B":
        flops, nbytes = painn_bwd_flops_bytes(rbf, rbf2, f, need_gw)
    else:
        flops, nbytes = painn_dual_bwd_flops_bytes(rbf, rbf2, f, need_gw)
    return {"flops_live": flops, "flops_live_products": prod, "flops_live_other": other,
            "bytes": nbytes, "live_pairs": live, "pairs": b * a * a,
            **_operands(rbf, prod - gw, gw)}
