"""Fused EquiformerV2 SO(2) graph attention: CUDA kernels O (forward) and P (backward).

The port of ``nabladft_tpu/ops/pallas/eqv2_attn.py``: `eqv2_attention_vjp` (a
`jax.custom_vjp` over `_fwd_kernel` / `_bwd_kernel`). Per live edge slot (b, i,
k) of the K-compacted neighbour list (maskf > 0.5), j = idx[b, i, k]:

  flat   = [D x_j | D x_i] ⊙ rad(l),   rad = xe w_rad + b_rad   [S_t, 2C]
  hidden, (alpha, gate) = SO2_1(flat)   (w1's extra m=0 columns: NH·VA + CO)
  acted  = silu on the truncated S2 grid (rows 1..), silu(gate) (row 0)
  values = SO2_2(acted)                                          [S_t, CO]
  logits = alpha_dot · silu(LN_head(alpha))  (eps 1e-6)           [NH]
  a      = softmax over the receiver's live edges ⊙ dropk
  agg[b, i] = Σ_k Dᵀ (values ⊙ a per head)                        [S, CO]

with each SO(2) conv: m=0 rows times w, m=1..M the packed (wr | wi) over the
+m and -m rows, recombined as (rp - im, rm + ip).

Layouts: x, xi [B,A,S,C] (the JAX op takes the gathered x S-major and xi
atom-major; both are atom-major here, and the model passes the same tensor
twice); idx [B,A,K] (int32 on the card); d [B,A,K,KW] compact masked Wigner
values (KW = 235 at L=6, M=2, not padded to the TPU's lanes); xe [B,A,K,EC];
maskf [B,A,K]; dropk [B,A,K,NH] (the pre-scaled keep mask); weights `ws` in
the order of `weight_names`: w_rad [EC,(L+1)2C], b_rad [1,(L+1)2C], w1
[(L+1)2C,(L+1)CO+NH·VA+CO], fc1_m [n_l 2C, 2 n_l CO] per m, w2
[(L+1)CO,(L+1)CO], fc2_m [n_l CO, 2 n_l CO] per m, ln_scale and ln_bias
(tiled per head) and alpha_dot [1, NH·VA]. All float32. K is min(30, A): the
TPU's padding of K to its 8-row tile is not carried over.

The VJP keeps the JAX contract: x (through the gather), xi, xe and every
weight get cotangents; idx, d, maskf and dropk none. Each kernel has a plain
PyTorch version here, written over index gathers (the JAX op gathers with a
one-hot matmul); a wrapper takes it only for CPU tensors, and a CUDA tensor
launches the kernel (``csrc/eqv2_attn.cu``, built for L=6, M=2) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from nabladft_tpu_torch.ops import _kernels, so3
from nabladft_tpu_torch.ops.escn_layer import (
    _expand_matrix, _ptrs, _rot_macs, _spans, _table, grid_act, s_trunc,
)
from nabladft_tpu_torch.ops.graph import gather_nodes

# launches of each CUDA kernel wrapper since the last reset
LAUNCHES: Dict[str, int] = {"eqv2_fwd": 0, "eqv2_bwd": 0}

LN_EPS = 1e-6


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# the JAX package's FLOP model, per live edge
# ---------------------------------------------------------------------------


def edge_fwd_flops(c2: int, co: int, ec: int, l_max: int, m_max: int, n_grid: int, nh: int,
                   va: int) -> int:
    """`attn_fwd_flops` of one edge without its one-hot gather term (the
    kernels gather by index); the backward counts 2.6 × this, as
    `attn_bwd_flops` does."""
    st, n0, rot = s_trunc(l_max, m_max), l_max + 1, _rot_macs(l_max, m_max)
    so2_1 = 2 * (n0 * c2) * (n0 * co + nh * va + co)
    so2_2 = 2 * (n0 * co) * (n0 * co)
    for m in range(1, m_max + 1):
        n_l = l_max + 1 - m
        so2_1 += 2 * 2 * (n_l * c2) * (2 * n_l * co)
        so2_2 += 2 * 2 * (n_l * co) * (2 * n_l * co)
    return (2 * rot * (c2 // 2) * 2 + 2 * ec * (n0 * c2) + so2_1 + so2_2
            + 2 * 2 * n_grid * st * co + 2 * nh * va * 6 + 2 * rot * co)


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------


def weight_names(m_max: int) -> List[str]:
    return (["w_rad", "b_rad", "w1"] + [f"fc1_m{m}" for m in range(1, m_max + 1)] + ["w2"]
            + [f"fc2_m{m}" for m in range(1, m_max + 1)] + ["ln_scale", "ln_bias", "alpha_dot"])


def weight_shapes(l_max: int, m_max: int, c: int, co: int, ec: int, nh: int,
                  va: int) -> List[tuple]:
    """The shapes of ws, in the order of `weight_names`."""
    n0, c2 = l_max + 1, 2 * c
    nls = [l_max + 1 - m for m in range(1, m_max + 1)]
    return ([(ec, n0 * c2), (1, n0 * c2), (n0 * c2, n0 * co + nh * va + co)]
            + [(n * c2, 2 * n * co) for n in nls] + [(n0 * co, n0 * co)]
            + [(n * co, 2 * n * co) for n in nls] + [(1, nh * va)] * 3)


def _dims(ws, l_max: int, m_max: int, nh: int):
    """(co, va) from the weights."""
    return ws[3 + m_max].shape[-1] // (l_max + 1), ws[-1].shape[-1] // nh


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _so2_eq(flat, c_in: int, co: int, w0, fcm, l_max: int, m_max: int):
    """An SO(2) conv on m-major flats [..., S_t·c_in]: ([..., S_t·co], the
    extra m=0 columns of w0 or None)."""
    spans = _spans(l_max, m_max)
    s0, n0 = spans[0]
    h0 = flat[..., s0 * c_in:(s0 + n0) * c_in] @ w0
    parts = [h0[..., :n0 * co]]
    extra = h0[..., n0 * co:] if h0.shape[-1] > n0 * co else None
    for m in range(1, m_max + 1):
        (sp, n_l), (sm, _) = spans[2 * m - 1], spans[2 * m]
        fp, fm = flat[..., sp * c_in:(sp + n_l) * c_in], flat[..., sm * c_in:(sm + n_l) * c_in]
        wr, wi = fcm[m - 1][:, :n_l * co], fcm[m - 1][:, n_l * co:]
        parts += [fp @ wr - fm @ wi, fm @ wr + fp @ wi]
    return torch.cat(parts, dim=-1), extra


def eqv2_fwd_reference(x, xi, idx, d, xe, maskf, dropk, *ws, l_max: int, m_max: int,
                       n_grid: int, nh: int) -> torch.Tensor:
    """Plain PyTorch version of kernel O: agg [B,A,S,CO]."""
    b, a, s, c = x.shape
    k = idx.shape[2]
    st, n0, c2 = s_trunc(l_max, m_max), l_max + 1, 2 * c
    co, va = _dims(ws, l_max, m_max, nh)
    w_rad, b_rad, w1 = ws[:3]
    fc1m, w2, fc2m = ws[3:3 + m_max], ws[3 + m_max], ws[4 + m_max:4 + 2 * m_max]
    ln_scale, ln_bias, alpha_dot = (w.reshape(nh, va) for w in ws[-3:])
    expand = torch.as_tensor(_expand_matrix(l_max, m_max), dtype=d.dtype, device=d.device)
    dt = (d @ expand).reshape(b, a, k, st, s)
    src = torch.einsum("bakrs,baksc->bakrc", dt, gather_nodes(x, idx))
    tgt = torch.einsum("bakrs,basc->bakrc", dt, xi)
    rad = (xe @ w_rad + b_rad).reshape(b, a, k, n0, c2)
    l_of_row = torch.as_tensor([l for l, _ in so3.mmajor_rows(l_max, m_max)], device=x.device)
    flat = (torch.cat([src, tgt], dim=-1) * rad[..., l_of_row, :]).reshape(b, a, k, st * c2)
    hidden, extra = _so2_eq(flat, c2, co, w1, fc1m, l_max, m_max)
    alpha_scal, gate = extra[..., :nh * va], extra[..., nh * va:]
    acted = grid_act(hidden.reshape(b, a, k, st, co), l_max, m_max, n_grid)
    acted = torch.cat([F.silu(gate)[..., None, :], acted[..., 1:, :]], dim=-2)
    values, _ = _so2_eq(acted.reshape(b, a, k, st * co), co, co, w2, fc2m, l_max, m_max)

    al = alpha_scal.reshape(b, a, k, nh, va)
    cen = al - al.mean(dim=-1, keepdim=True)
    ln = cen * torch.rsqrt((cen * cen).mean(dim=-1, keepdim=True) + LN_EPS) * ln_scale + ln_bias
    logits = (F.silu(ln) * alpha_dot).sum(dim=-1)  # [B,A,K,NH]
    live = (maskf > 0.5)[..., None]
    logits = torch.where(live, logits, torch.full_like(logits, -1e9))
    ex = torch.exp(logits - logits.amax(dim=2, keepdim=True)) * live
    alpha = ex / torch.clamp(ex.sum(dim=2, keepdim=True), min=1e-20) * dropk
    v = values.reshape(b, a, k, st, nh, co // nh) * alpha[..., None, :, None]
    return torch.einsum("bakrs,bakrc->basc", dt, v.reshape(b, a, k, st, co))


def eqv2_bwd_reference(x, xi, idx, d, xe, maskf, dropk, *ws, g, l_max: int, m_max: int,
                       n_grid: int, nh: int):
    """Plain PyTorch version of kernel P (autograd of kernel O's plain
    version): (gx, gxi, gxe, *gws) in the order of ws."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, xi, xe, *ws)]
        out = eqv2_fwd_reference(ins[0], ins[1], idx, d.detach(), ins[2], maskf, dropk, *ins[3:],
                                 l_max=l_max, m_max=m_max, n_grid=n_grid, nh=nh)
        grads = torch.autograd.grad(out, ins, g)
    return tuple(t.detach() for t in grads)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load("eqv2_attn")
    p, i, pp, ll = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong
    lib.eqv2_supported.argtypes = [i, i]
    lib.eqv2_supported.restype = i
    lib.eqv2_scratch_floats.argtypes = [i] * 11
    lib.eqv2_scratch_floats.restype = ll
    lib.eqv2_scratch_ints.argtypes = [i] * 3
    lib.eqv2_scratch_ints.restype = ll
    lib.eqv2_fwd.argtypes = [p] * 7 + [pp] + [p] * 5 + [i] * 12 + [p]
    lib.eqv2_fwd.restype = i
    lib.eqv2_bwd.argtypes = [p] * 7 + [pp] + [p] * 6 + [pp] + [p] * 2 + [i] * 12 + [p]
    lib.eqv2_bwd.restype = i
    return lib


def _check(x, xi, idx, d, xe, maskf, dropk, ws, l_max: int, m_max: int, nh: int,
           g=None) -> torch.device:
    if x.ndim != 4 or idx.ndim != 3:
        raise ValueError(f"x must be 4-d and idx 3-d, got {tuple(x.shape)}, {tuple(idx.shape)}")
    if len(ws) != 7 + 2 * m_max:
        raise ValueError(f"expected {7 + 2 * m_max} weight arrays for m_max={m_max}, got {len(ws)}")
    b, a, s, c = x.shape
    k = idx.shape[2]
    if s != (l_max + 1) ** 2:
        raise ValueError(f"x has {s} SH rows, expected {(l_max + 1) ** 2} for l_max={l_max}")
    if tuple(idx.shape[:2]) != (b, a) or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be an integer [B, A, K] over x's B, A, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if idx.device != x.device:
        raise ValueError(f"idx is on {idx.device}, expected {x.device}")
    co, va = _dims(ws, l_max, m_max, nh)
    ec, kw = xe.shape[-1], so3.trunc_compact_layout(l_max, m_max)[1]
    shapes = dict(x=(b, a, s, c), xi=(b, a, s, c), d=(b, a, k, kw), xe=(b, a, k, ec),
                  maskf=(b, a, k), dropk=(b, a, k, nh))
    tensors = dict(x=x, xi=xi, d=d, xe=xe, maskf=maskf, dropk=dropk)
    for n, (w, shp) in enumerate(zip(ws, weight_shapes(l_max, m_max, c, co, ec, nh, va))):
        tensors[f"w{n}"], shapes[f"w{n}"] = w, shp
    if g is not None:
        tensors["g"], shapes["g"] = g, (b, a, s, co)
    dev = _kernels.check_inputs(tensors, shapes)
    if dev.type == "cuda":
        if not _lib().eqv2_supported(l_max, m_max):
            raise ValueError(f"the EqV2 kernels are built for l_max=6, m_max=2, "
                             f"not {l_max}, {m_max}")
        if c % 8 or co % 8 or ec % 8 or (nh * va) % 8 or co % nh or va > 128 or a > 1024:
            raise ValueError(f"the EqV2 kernels take C, CO, EC, NH·VA multiples of 8, CO a "
                             f"multiple of NH, VA <= 128 and A <= 1024; got C {c}, CO {co}, "
                             f"EC {ec}, NH {nh}, VA {va}, A {a}")
        for n, t in tensors.items():
            if t.data_ptr() % 16:
                raise ValueError(f"{n} is not 16-byte aligned")
    return dev


def _launch(name: str, dev, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_lib(), name)(*args, stream)
    _kernels.raise_on_error(err, f"{name} launch")


def _card_args(x, idx, xe, ws, l_max, m_max, n_grid, nh, bwd: bool):
    """(idx as int32, the grid tables, scratch, the int arguments) of a launch."""
    dev = x.device
    b, a, s, c = x.shape
    k = idx.shape[2]
    co, va = _dims(ws, l_max, m_max, nh)
    ec = xe.shape[-1]
    tog = _table("to_g", l_max, m_max, n_grid, str(dev))
    fromg = _table("from_g", l_max, m_max, n_grid, str(dev))
    lib = _lib()
    fs = torch.empty(lib.eqv2_scratch_floats(int(bwd), b, a, k, c, co, ec, nh, va, l_max, m_max),
                     dtype=torch.float32, device=dev)
    iscr = torch.empty(lib.eqv2_scratch_ints(b, a, k), dtype=torch.int32, device=dev)
    ints = (b, a, k, c, co, ec, nh, va, so3.trunc_compact_layout(l_max, m_max)[1], tog.shape[0],
            l_max, m_max)
    return idx.to(torch.int32).contiguous(), tog, fromg, fs, iscr, ints


def eqv2_fwd(x, xi, idx, d, xe, maskf, dropk, *ws, l_max: int, m_max: int, n_grid: int,
             nh: int) -> torch.Tensor:
    """Kernel O: agg [B,A,S,CO]."""
    dev = _check(x, xi, idx, d, xe, maskf, dropk, ws, l_max, m_max, nh)
    kw = dict(l_max=l_max, m_max=m_max, n_grid=n_grid, nh=nh)
    if dev.type == "cpu":
        return eqv2_fwd_reference(x, xi, idx, d, xe, maskf, dropk, *ws, **kw)
    idx32, tog, fromg, fs, iscr, ints = _card_args(x, idx, xe, ws, l_max, m_max, n_grid, nh, False)
    b, a, s, _ = x.shape
    out = torch.empty((b, a, s, _dims(ws, l_max, m_max, nh)[0]), dtype=torch.float32, device=dev)
    _launch("eqv2_fwd", dev, x.data_ptr(), xi.data_ptr(), idx32.data_ptr(), d.data_ptr(),
            xe.data_ptr(), maskf.data_ptr(), dropk.data_ptr(), _ptrs(ws), tog.data_ptr(),
            fromg.data_ptr(), out.data_ptr(), fs.data_ptr(), iscr.data_ptr(), *ints)
    LAUNCHES["eqv2_fwd"] += 1
    return out


def eqv2_bwd(x, xi, idx, d, xe, maskf, dropk, *ws, g, l_max: int, m_max: int, n_grid: int,
             nh: int):
    """Kernel P: (gx, gxi, gxe, *gws) in the order of ws."""
    dev = _check(x, xi, idx, d, xe, maskf, dropk, ws, l_max, m_max, nh, g)
    kw = dict(l_max=l_max, m_max=m_max, n_grid=n_grid, nh=nh)
    if dev.type == "cpu":
        return eqv2_bwd_reference(x, xi, idx, d, xe, maskf, dropk, *ws, g=g, **kw)
    idx32, tog, fromg, fs, iscr, ints = _card_args(x, idx, xe, ws, l_max, m_max, n_grid, nh, True)
    gx, gxi = torch.empty_like(x), torch.empty_like(xi)
    gxe = torch.zeros_like(xe)  # the kernel writes the live edges' rows only
    gws = [torch.empty_like(w) for w in ws]
    _launch("eqv2_bwd", dev, x.data_ptr(), xi.data_ptr(), idx32.data_ptr(), d.data_ptr(),
            xe.data_ptr(), maskf.data_ptr(), dropk.data_ptr(), _ptrs(ws), tog.data_ptr(),
            fromg.data_ptr(), g.data_ptr(), gx.data_ptr(), gxi.data_ptr(), gxe.data_ptr(),
            _ptrs(gws), fs.data_ptr(), iscr.data_ptr(), *ints)
    LAUNCHES["eqv2_bwd"] += 1
    return (gx, gxi, gxe, *gws)


class EqV2AttentionFn(torch.autograd.Function):
    """`eqv2_attention_vjp`'s custom VJP: forward = kernel O, backward =
    kernel P. Inputs (dims, x, xi, idx, d, xe, maskf, dropk, *ws) with dims =
    (l_max, m_max, n_grid, nh); idx, d, maskf and dropk get no gradient."""

    @staticmethod
    def forward(ctx, dims, x, xi, idx, d, xe, maskf, dropk, *ws):
        ctx.save_for_backward(x, xi, idx, d, xe, maskf, dropk, *ws)
        ctx.dims = dims
        l_max, m_max, n_grid, nh = dims
        return eqv2_fwd(x, xi, idx, d, xe, maskf, dropk, *ws, l_max=l_max, m_max=m_max,
                        n_grid=n_grid, nh=nh)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, xi, idx, d, xe, maskf, dropk, *ws = ctx.saved_tensors
        l_max, m_max, n_grid, nh = ctx.dims
        gx, gxi, gxe, *gws = eqv2_bwd(x, xi, idx, d, xe, maskf, dropk, *ws, g=g.contiguous(),
                                      l_max=l_max, m_max=m_max, n_grid=n_grid, nh=nh)
        return (None, gx, gxi, None, None, gxe, None, None, *gws)


def eqv2_attention(x, xi, idx, d, xe, maskf, dropk, *ws, l_max: int, m_max: int, n_grid: int,
                   nh: int) -> torch.Tensor:
    """Fused EqV2 SO(2) graph attention: agg [B,A,S,CO]."""
    return EqV2AttentionFn.apply((l_max, m_max, n_grid, nh), x, xi, idx, d, xe, maskf, dropk,
                                 *ws)


# ---------------------------------------------------------------------------
# work the kernels need on given inputs
# ---------------------------------------------------------------------------


def live_edges(maskf: torch.Tensor) -> int:
    """Edge slots with maskf > 0.5: the rows the kernels run."""
    return int((maskf > 0.5).sum())


def flops_bytes(kind: str, x, idx, d, xe, maskf, dropk, ws: Sequence[torch.Tensor], l_max: int,
                m_max: int, n_grid: int, nh: int) -> Dict[str, int]:
    """The work of kernel `kind` ("O" or "P") on these inputs: "flops" the
    JAX package's FLOP model (without its one-hot gather) over all B·A·K
    edge slots, "flops_live" the same model per edge times the live edges
    (the kernels skip the others, and the bound counts what the data needs),
    and "bytes" with each input read once and each output written once."""
    b, a, s, c = x.shape
    k = idx.shape[2]
    co, va = _dims(ws, l_max, m_max, nh)
    per = edge_fwd_flops(2 * c, co, xe.shape[-1], l_max, m_max, n_grid, nh, va)
    if kind == "P":
        per = 2.6 * per
    n_w = sum(w.numel() for w in ws)
    ins = 2 * x.numel() + idx.numel() + d.numel() + xe.numel() + maskf.numel() + dropk.numel() + n_w
    agg = b * a * s * co
    nbytes = 4 * (ins + agg if kind == "O" else ins + agg + 2 * x.numel() + xe.numel() + n_w)
    return {"flops": int(per * b * a * k), "flops_live": int(per * live_edges(maskf)),
            "bytes": nbytes}
