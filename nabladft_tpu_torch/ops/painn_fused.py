"""Fused PaiNN message: CUDA kernels A (forward) and B (backward).

The port of the first-order op of ``nabladft_tpu/ops/pallas/painn_fused.py``
(`painn_message`, a `jax.custom_vjp` over `_fwd_kernel` / `_bwd_kernel`).
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

Layouts: v and dv are component-major flat [B,A,3F]; unit_t is [B,A,3,A]
(u_t[b,i,c,j] = unit(j→i)_c). All float32.

Each kernel has its plain PyTorch version here with the same signature
(`painn_message_reference`, `painn_message_bwd_reference`). A wrapper
takes the plain version only for CPU tensors; a CUDA tensor launches the
kernel (sources in ``csrc/painn_fused.cu``) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from nabladft_tpu_torch.ops import _kernels

# launches of each CUDA kernel wrapper since the last reset
LAUNCHES: Dict[str, int] = {"painn_fwd": 0, "painn_bwd": 0}


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
               product with rbf (6R): 6R + 13.

    (The JAX package's analytic model, `kernel_flops`, counts more:
    fwd 6R + 32, bwd 18R + 78 per channel and pair.)
    """
    return {"fwd": 6 * r + 16, "bwd": 12 * r + 49, "bwd_gw": 6 * r + 13}[kind] * f


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def painn_message_reference(rbf, phi, v, unit_t, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel A (premasked rbf, no bias).

    Also the `use_pallas="off"` model path, differentiable by autograd.
    """
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
    gw [R,3F] or None), with g_dist = Σ_f gwm ⊙ (rbfp @ W).
    """
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


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load("painn_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.painn_fwd.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.painn_fwd.restype = i
    lib.painn_bwd.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.painn_bwd.restype = i
    return lib


def _check(tensors: Dict[str, torch.Tensor], shapes: Dict[str, tuple]) -> torch.device:
    """Same device, float32, contiguous, expected shapes; returns the device."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}; the kernels take float32")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _shapes(phi, w):
    b, a = phi.shape[0], phi.shape[1]
    r, f3 = w.shape
    if f3 % 3:
        raise ValueError(f"w has {f3} columns, expected 3F")
    return b, a, r, f3 // 3


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with cudaError {err}")


def painn_fwd(rbf, phi, v, unit_t, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A: (ds [B,A,F], dv [B,A,3F])."""
    b, a, r, f = _shapes(phi, w)
    dev = _check(
        dict(rbf=rbf, phi=phi, v=v, unit_t=unit_t, w=w),
        dict(rbf=(b, a, a, r), phi=(b, a, 3 * f), v=(b, a, 3 * f),
             unit_t=(b, a, 3, a), w=(r, 3 * f)),
    )
    if dev.type == "cpu":
        return painn_message_reference(rbf, phi, v, unit_t, w)
    ds = torch.empty((b, a, f), dtype=torch.float32, device=dev)
    dv = torch.empty((b, a, 3 * f), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().painn_fwd(
            rbf.data_ptr(), phi.data_ptr(), v.data_ptr(), unit_t.data_ptr(), w.data_ptr(),
            ds.data_ptr(), dv.data_ptr(), b, a, r, f, stream,
        )
    _raise_on(err, "painn_fwd launch")
    LAUNCHES["painn_fwd"] += 1
    return ds, dv


def painn_bwd(rbf, rbfp, phi, v, unit_t, w, gds, gdv, need_gw: bool = True):
    """Kernel B: (g_dist, g_unit_t, gphi, gv, gw or None)."""
    b, a, r, f = _shapes(phi, w)
    dev = _check(
        dict(rbf=rbf, rbfp=rbfp, phi=phi, v=v, unit_t=unit_t, w=w, gds=gds, gdv=gdv),
        dict(rbf=(b, a, a, r), rbfp=(b, a, a, r), phi=(b, a, 3 * f), v=(b, a, 3 * f),
             unit_t=(b, a, 3, a), w=(r, 3 * f), gds=(b, a, f), gdv=(b, a, 3 * f)),
    )
    if dev.type == "cpu":
        return painn_message_bwd_reference(rbf, rbfp, phi, v, unit_t, w, gds, gdv, need_gw)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    g_dist, g_ut = empty(b, a, a), empty(b, a, 3, a)
    gphi, gv = empty(b, a, 3 * f), empty(b, a, 3 * f)
    gw = empty(r, 3 * f) if need_gw else None
    gw_part = empty(b, r, 3 * f) if need_gw else None
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().painn_bwd(
            rbf.data_ptr(), rbfp.data_ptr(), phi.data_ptr(), v.data_ptr(),
            unit_t.data_ptr(), w.data_ptr(), gds.data_ptr(), gdv.data_ptr(),
            g_dist.data_ptr(), g_ut.data_ptr(), gphi.data_ptr(), gv.data_ptr(),
            ptr(gw_part), ptr(gw), int(need_gw), b, a, r, f, stream,
        )
    _raise_on(err, "painn_bwd launch")
    LAUNCHES["painn_bwd"] += 1
    return g_dist, g_ut, gphi, gv, gw


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


def painn_fwd_flops_bytes(rbf: torch.Tensor, f: int) -> Tuple[int, int]:
    """(FLOPs, bytes) kernel A needs on these inputs: FLOPs counted over the
    pairs whose rbf row is nonzero (masked pairs need no work), bytes with
    each input read once and each output written once."""
    b, a, _, r = rbf.shape
    live = int((rbf != 0).any(dim=-1).sum())
    flops = pair_flops("fwd", r, f) * live
    nbytes = 4 * (rbf.numel() + 2 * b * a * 3 * f + b * a * 3 * a + r * 3 * f
                  + b * a * f + b * a * 3 * f)
    return flops, nbytes


def painn_bwd_flops_bytes(rbf: torch.Tensor, f: int, need_gw: bool = True) -> Tuple[int, int]:
    """(FLOPs, bytes) kernel B needs on these inputs (see painn_fwd_flops_bytes);
    with gW, also the fixed-order sum of the per-molecule [R,3F] partials."""
    b, a, _, r = rbf.shape
    live = int((rbf != 0).any(dim=-1).sum())
    flops = pair_flops("bwd", r, f) * live
    if need_gw:
        flops += pair_flops("bwd_gw", r, f) * live + (b - 1) * r * 3 * f
    nbytes = 4 * (2 * rbf.numel() + 2 * b * a * 3 * f + b * a * 3 * a + r * 3 * f
                  + b * a * f + b * a * 3 * f                   # gds, gdv
                  + b * a * a + b * a * 3 * a + 2 * b * a * 3 * f  # g_dist, g_unit_t, gphi, gv
                  + (r * 3 * f if need_gw else 0))
    return flops, nbytes
