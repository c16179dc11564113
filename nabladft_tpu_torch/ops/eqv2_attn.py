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

``mxu_bf16=True`` is the TPU kernels' bf16 mode (the model's
``compute_dtype="bfloat16"``): where `_attn_pipeline` and the hand-written
`_attn_pipeline_bwd` pass a value through `_mdot(., ., True)` it is rounded
to bf16, and nowhere else: both operands of the radial product, of the SO(2)
products, their transposes and every weight gradient (`escn_layer.mdot`);
the gathered sender rows x_j (the JAX gather is a one-hot product; the
receiver's own rows x_i are broadcast and stay float32); and, in the
backward, each edge's cotangent of its sender's rows before the sum over
the edges (the gather's transpose). The per-head expander products, b_rad,
the LayerNorm and alpha vectors and their gradients stay float32. The
kernels' entry points ``eqv2_fwd_bf16`` / ``eqv2_bwd_bf16`` count as
"eqv2_fwd_bf16" / "eqv2_bwd_bf16".
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from nabladft_tpu_torch.ops import _kernels, so3
from nabladft_tpu_torch.ops.escn_layer import (
    _expand_matrix, _ptrs, _rot_macs, _spans, _table, grid_act, mdot, round_bf16, s_trunc,
)
from nabladft_tpu_torch.ops.graph import gather_nodes

# launches of each CUDA kernel wrapper since the last reset
LAUNCHES: Dict[str, int] = {"eqv2_fwd": 0, "eqv2_bwd": 0, "eqv2_fwd_bf16": 0, "eqv2_bwd_bf16": 0,
                             "so2_products": 0, "so2_wgrads": 0}

LN_EPS = 1e-6


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# the JAX package's FLOP model, per live edge
# ---------------------------------------------------------------------------


def edge_fwd_flops_split(c2: int, co: int, ec: int, l_max: int, m_max: int, n_grid: int,
                         nh: int, va: int) -> Tuple[int, int]:
    """`edge_fwd_flops` as (products, other): the radial product and the two
    SO(2) convs (the product engine's work, on the tensor cores), and the
    rotations, the grid activation and the attention head."""
    st, n0, rot = s_trunc(l_max, m_max), l_max + 1, _rot_macs(l_max, m_max)
    so2_1 = 2 * (n0 * c2) * (n0 * co + nh * va + co)
    so2_2 = 2 * (n0 * co) * (n0 * co)
    for m in range(1, m_max + 1):
        n_l = l_max + 1 - m
        so2_1 += 2 * 2 * (n_l * c2) * (2 * n_l * co)
        so2_2 += 2 * 2 * (n_l * co) * (2 * n_l * co)
    products = 2 * ec * (n0 * c2) + so2_1 + so2_2
    other = 2 * rot * (c2 // 2) * 2 + 2 * 2 * n_grid * st * co + 2 * nh * va * 6 + 2 * rot * co
    return products, other


def edge_fwd_flops(c2: int, co: int, ec: int, l_max: int, m_max: int, n_grid: int, nh: int,
                   va: int) -> int:
    """`attn_fwd_flops` of one edge without its one-hot gather term (the
    kernels gather by index); the backward counts 2.6 × this, as
    `attn_bwd_flops` does."""
    return sum(edge_fwd_flops_split(c2, co, ec, l_max, m_max, n_grid, nh, va))


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


class _RoundedRows(torch.autograd.Function):
    """The bf16 mode's gathered sender rows: rounded to bf16, and their
    cotangents rounded too (the one-hot gather's transpose in
    `_attn_pipeline_bwd` is an `_mdot` of its own, summed over the edges in
    float32 by the gather's backward)."""

    @staticmethod
    def forward(ctx, t):
        return round_bf16(t)

    @staticmethod
    def backward(ctx, g):
        return round_bf16(g)


def _so2_eq(flat, c_in: int, co: int, w0, fcm, l_max: int, m_max: int, mxu_bf16: bool = False):
    """An SO(2) conv on m-major flats [..., S_t·c_in]: ([..., S_t·co], the
    extra m=0 columns of w0 or None)."""
    mm = functools.partial(mdot, mxu_bf16=mxu_bf16)
    spans = _spans(l_max, m_max)
    s0, n0 = spans[0]
    h0 = mm(flat[..., s0 * c_in:(s0 + n0) * c_in], w0)
    parts = [h0[..., :n0 * co]]
    extra = h0[..., n0 * co:] if h0.shape[-1] > n0 * co else None
    for m in range(1, m_max + 1):
        (sp, n_l), (sm, _) = spans[2 * m - 1], spans[2 * m]
        fp, fm = flat[..., sp * c_in:(sp + n_l) * c_in], flat[..., sm * c_in:(sm + n_l) * c_in]
        wr, wi = fcm[m - 1][:, :n_l * co], fcm[m - 1][:, n_l * co:]
        parts += [mm(fp, wr) - mm(fm, wi), mm(fm, wr) + mm(fp, wi)]
    return torch.cat(parts, dim=-1), extra


def eqv2_fwd_reference(x, xi, idx, d, xe, maskf, dropk, *ws, l_max: int, m_max: int,
                       n_grid: int, nh: int, mxu_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel O: agg [B,A,S,CO] (`mxu_bf16`: its
    bf16 mode's roundings)."""
    b, a, s, c = x.shape
    k = idx.shape[2]
    st, n0, c2 = s_trunc(l_max, m_max), l_max + 1, 2 * c
    co, va = _dims(ws, l_max, m_max, nh)
    w_rad, b_rad, w1 = ws[:3]
    fc1m, w2, fc2m = ws[3:3 + m_max], ws[3 + m_max], ws[4 + m_max:4 + 2 * m_max]
    ln_scale, ln_bias, alpha_dot = (w.reshape(nh, va) for w in ws[-3:])
    expand = torch.as_tensor(_expand_matrix(l_max, m_max), dtype=d.dtype, device=d.device)
    dt = (d @ expand).reshape(b, a, k, st, s)
    xj = gather_nodes(x, idx)
    src = torch.einsum("bakrs,baksc->bakrc", dt, _RoundedRows.apply(xj) if mxu_bf16 else xj)
    tgt = torch.einsum("bakrs,basc->bakrc", dt, xi)
    rad = (mdot(xe, w_rad, mxu_bf16) + b_rad).reshape(b, a, k, n0, c2)
    l_of_row = torch.as_tensor([l for l, _ in so3.mmajor_rows(l_max, m_max)], device=x.device)
    flat = (torch.cat([src, tgt], dim=-1) * rad[..., l_of_row, :]).reshape(b, a, k, st * c2)
    hidden, extra = _so2_eq(flat, c2, co, w1, fc1m, l_max, m_max, mxu_bf16)
    alpha_scal, gate = extra[..., :nh * va], extra[..., nh * va:]
    acted = grid_act(hidden.reshape(b, a, k, st, co), l_max, m_max, n_grid)
    acted = torch.cat([F.silu(gate)[..., None, :], acted[..., 1:, :]], dim=-2)
    values, _ = _so2_eq(acted.reshape(b, a, k, st * co), co, co, w2, fc2m, l_max, m_max,
                        mxu_bf16)

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
                       n_grid: int, nh: int, mxu_bf16: bool = False):
    """Plain PyTorch version of kernel P (autograd of kernel O's plain
    version; in the bf16 mode `_MDot`'s and `_RoundedRows`' backwards round
    as `_attn_pipeline_bwd` does): (gx, gxi, gxe, *gws) in the order of ws."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, xi, xe, *ws)]
        out = eqv2_fwd_reference(ins[0], ins[1], idx, d.detach(), ins[2], maskf, dropk, *ins[3:],
                                 l_max=l_max, m_max=m_max, n_grid=n_grid, nh=nh,
                                 mxu_bf16=mxu_bf16)
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
    for sfx in ("", "_bf16"):
        fwd, bwd = getattr(lib, "eqv2_fwd" + sfx), getattr(lib, "eqv2_bwd" + sfx)
        fwd.argtypes = [p] * 7 + [pp] + [p] * 5 + [i] * 12 + [p]
        fwd.restype = i
        bwd.argtypes = [p] * 7 + [pp] + [p] * 6 + [pp] + [p] * 2 + [i] * 12 + [p]
        bwd.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.so2_products_probe.argtypes = [i, ip, pp, ll, p, p, p, ll, i, p]
    lib.so2_products_probe.restype = i
    lib.so2_wgrads_part_floats.argtypes = [i, ip, ll]
    lib.so2_wgrads_part_floats.restype = ll
    lib.so2_wgrads_probe.argtypes = [i, ip, pp, ll, p, p, p, ll, p]
    lib.so2_wgrads_probe.restype = i
    lib.so2_live_rows_probe.argtypes = [p] * 5 + [ll, i, p]
    lib.so2_live_rows_probe.restype = i
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
             nh: int, mxu_bf16: bool = False) -> torch.Tensor:
    """Kernel O: agg [B,A,S,CO] (`mxu_bf16`: its bf16 mode, eqv2_fwd_bf16)."""
    dev = _check(x, xi, idx, d, xe, maskf, dropk, ws, l_max, m_max, nh)
    kw = dict(l_max=l_max, m_max=m_max, n_grid=n_grid, nh=nh, mxu_bf16=mxu_bf16)
    if dev.type == "cpu":
        return eqv2_fwd_reference(x, xi, idx, d, xe, maskf, dropk, *ws, **kw)
    idx32, tog, fromg, fs, iscr, ints = _card_args(x, idx, xe, ws, l_max, m_max, n_grid, nh, False)
    b, a, s, _ = x.shape
    out = torch.empty((b, a, s, _dims(ws, l_max, m_max, nh)[0]), dtype=torch.float32, device=dev)
    name = "eqv2_fwd_bf16" if mxu_bf16 else "eqv2_fwd"
    _launch(name, dev, x.data_ptr(), xi.data_ptr(), idx32.data_ptr(), d.data_ptr(),
            xe.data_ptr(), maskf.data_ptr(), dropk.data_ptr(), _ptrs(ws), tog.data_ptr(),
            fromg.data_ptr(), out.data_ptr(), fs.data_ptr(), iscr.data_ptr(), *ints)
    LAUNCHES[name] += 1
    return out


def eqv2_bwd(x, xi, idx, d, xe, maskf, dropk, *ws, g, l_max: int, m_max: int, n_grid: int,
             nh: int, mxu_bf16: bool = False):
    """Kernel P: (gx, gxi, gxe, *gws) in the order of ws (`mxu_bf16`: its
    bf16 mode, eqv2_bwd_bf16)."""
    dev = _check(x, xi, idx, d, xe, maskf, dropk, ws, l_max, m_max, nh, g)
    kw = dict(l_max=l_max, m_max=m_max, n_grid=n_grid, nh=nh, mxu_bf16=mxu_bf16)
    if dev.type == "cpu":
        return eqv2_bwd_reference(x, xi, idx, d, xe, maskf, dropk, *ws, g=g, **kw)
    idx32, tog, fromg, fs, iscr, ints = _card_args(x, idx, xe, ws, l_max, m_max, n_grid, nh, True)
    gx, gxi = torch.empty_like(x), torch.empty_like(xi)
    gxe = torch.zeros_like(xe)  # the kernel writes the live edges' rows only
    gws = [torch.empty_like(w) for w in ws]
    name = "eqv2_bwd_bf16" if mxu_bf16 else "eqv2_bwd"
    _launch(name, dev, x.data_ptr(), xi.data_ptr(), idx32.data_ptr(), d.data_ptr(),
            xe.data_ptr(), maskf.data_ptr(), dropk.data_ptr(), _ptrs(ws), tog.data_ptr(),
            fromg.data_ptr(), g.data_ptr(), gx.data_ptr(), gxi.data_ptr(), gxe.data_ptr(),
            _ptrs(gws), fs.data_ptr(), iscr.data_ptr(), *ints)
    LAUNCHES[name] += 1
    return (gx, gxi, gxe, *gws)


class EqV2AttentionFn(torch.autograd.Function):
    """`eqv2_attention_vjp`'s custom VJP: forward = kernel O, backward =
    kernel P, both in the mode `mxu_bf16`. Inputs (dims, x, xi, idx, d, xe,
    maskf, dropk, *ws) with dims = (l_max, m_max, n_grid, nh, mxu_bf16); idx,
    d, maskf and dropk get no gradient."""

    @staticmethod
    def forward(ctx, dims, x, xi, idx, d, xe, maskf, dropk, *ws):
        ctx.save_for_backward(x, xi, idx, d, xe, maskf, dropk, *ws)
        ctx.dims = dict(zip(("l_max", "m_max", "n_grid", "nh", "mxu_bf16"), dims))
        return eqv2_fwd(x, xi, idx, d, xe, maskf, dropk, *ws, **ctx.dims)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, xi, idx, d, xe, maskf, dropk, *ws = ctx.saved_tensors
        gx, gxi, gxe, *gws = eqv2_bwd(x, xi, idx, d, xe, maskf, dropk, *ws, g=g.contiguous(),
                                      **ctx.dims)
        return (None, gx, gxi, None, None, gxe, None, None, *gws)


def eqv2_attention(x, xi, idx, d, xe, maskf, dropk, *ws, l_max: int, m_max: int, n_grid: int,
                   nh: int, mxu_bf16: bool = False) -> torch.Tensor:
    """Fused EqV2 SO(2) graph attention: agg [B,A,S,CO]."""
    return EqV2AttentionFn.apply((l_max, m_max, n_grid, nh, mxu_bf16), x, xi, idx, d, xe, maskf,
                                 dropk, *ws)


# ---------------------------------------------------------------------------
# work the kernels need on given inputs
# ---------------------------------------------------------------------------


def live_edges(maskf: torch.Tensor) -> int:
    """Edge slots with maskf > 0.5: the rows the kernels run."""
    return int((maskf > 0.5).sum())


def flops_bytes(kind: str, x, idx, d, xe, maskf, dropk, ws: Sequence[torch.Tensor], l_max: int,
                m_max: int, n_grid: int, nh: int, mxu_bf16: bool = False) -> Dict[str, int]:
    """The work of kernel `kind` ("O" or "P") on these inputs: "flops" the
    JAX package's FLOP model (without its one-hot gather) over all B·A·K
    edge slots, "flops_live" the same model per edge times the live edges
    (the kernels skip the others, and the bound counts what the data needs),
    "flops_live_products" / "flops_live_other" its split (the product
    engine's work and the rest; `edge_fwd_flops_split`), and "bytes" with each
    input read once and each output written once (float32 in both modes).
    "products_dtype": "float32", or "bfloat16" in the bf16 mode (the bound's
    product rate, as `escn_layer.flops_bytes`)."""
    b, a, s, c = x.shape
    k = idx.shape[2]
    co, va = _dims(ws, l_max, m_max, nh)
    prod, other = edge_fwd_flops_split(2 * c, co, xe.shape[-1], l_max, m_max, n_grid, nh, va)
    per = prod + other
    scale = 2.6 if kind == "P" else 1.0
    per, prod, other = scale * per, scale * prod, scale * other
    n_w = sum(w.numel() for w in ws)
    ins = 2 * x.numel() + idx.numel() + d.numel() + xe.numel() + maskf.numel() + dropk.numel() + n_w
    agg = b * a * s * co
    nbytes = 4 * (ins + agg if kind == "O" else ins + agg + 2 * x.numel() + xe.numel() + n_w)
    live = live_edges(maskf)
    return {"flops": int(per * b * a * k), "flops_live": int(per * live),
            "flops_live_products": int(prod * live), "flops_live_other": int(other * live),
            "bytes": nbytes, "products_dtype": "bfloat16" if mxu_bf16 else "float32"}


# ---------------------------------------------------------------------------
# the SO(2) product engine of kernels M-P on one problem list
# ---------------------------------------------------------------------------

EPILOGUES = {"store": 0, "gates": 1, "gated": 2}
WGRAD_MODES = {"rows": 0, "gather": 1, "ones": 2}
MAXSEG = 4  # so2_common.cuh's segments per product


def _rows(t: torch.Tensor, rows: int = 0, cols: int = 0) -> tuple:
    """(pointer, row stride) of a float32 2-D view with unit column stride and
    at least `rows` x `cols` elements."""
    if t.ndim != 2 or t.stride(1) != 1 or t.dtype != torch.float32:
        raise ValueError(f"expected a float32 2-D view with unit column stride, got "
                         f"{t.dtype} strides {tuple(t.stride())}")
    if t.shape[0] < rows or t.shape[1] < cols:
        raise ValueError(f"a view of shape {tuple(t.shape)} is smaller than {rows} x {cols}")
    return t.data_ptr(), t.stride(0)


def _row_list(eidx, n_rows: int, dev) -> torch.Tensor:
    if eidx is None:
        return torch.zeros(1, dtype=torch.int32, device=dev)
    if eidx.dtype != torch.int32 or eidx.device != dev or eidx.ndim != 1 or eidx.numel() < n_rows:
        raise ValueError(f"eidx must be an int32 vector of >= {n_rows} rows on {dev}")
    return eidx.contiguous()


def so2_products_reference(problems: Sequence[dict], n_rows: int, eidx=None) -> None:
    """Plain version of `so2_products`: the same sums in the inputs' dtype
    (a segment's "rbf16": both operands rounded to bf16 first)."""
    rows = torch.arange(n_rows, device=problems[0]["segs"][0]["a"].device)
    live = eidx[:n_rows].long() if eidx is not None else rows
    for p in problems:
        n = p["n"]
        acc = 0
        for sg in p["segs"]:
            a = sg["a"][live if p.get("gather") else rows, :sg["k"]]
            b = sg["b"][:n, :sg["k"]].T if sg.get("btrans") else sg["b"][:sg["k"], :n]
            if sg.get("rbf16"):
                a, b = round_bf16(a), round_bf16(b)
            acc = acc + sg.get("sign", 1.0) * (a @ b)
        out = live if p.get("scatter") else rows
        epi = p.get("epi", "store")
        if epi == "gates":
            acc = acc + p["bias"][:n]
            if p.get("c") is not None:
                p["c"][out, :n] = acc
            if p.get("c2") is not None:
                p["c2"][out, :n] = F.silu(acc)
        else:
            if epi == "gated" and p.get("bias") is not None:
                acc = acc + p["bias"][:n]
            if p.get("c") is not None:
                p["c"][out, :n] = acc
            if epi == "gated" and p.get("c2") is not None:
                p["c2"][out, :n] = acc * p["gate"][rows, :n]


def so2_products(problems: Sequence[dict], n_rows: int, eidx=None,
                 persistent: bool = False) -> None:
    """C[e, n] = Σ_seg sign · A[row(e), :k] B over the rows e < n_rows, in
    place, with the engine of so2_common.cuh (3xTF32 on the tensor cores) on
    card tensors, or the plain version on CPU tensors. A problem: "segs"
    (up to 4 dicts: "a" a 2-D view with rows of K, "b" [K, N] or, with
    "btrans", [N, K], "k", "sign" ±1, "rbf16" both operands rounded to bf16,
    one TF32 pass), "n", "epi" ("store", "gates": c = acc
    + bias and c2 = silu of it, "gated": c = v and c2 = v · gate[e] with v =
    acc (+ bias where given), gate may be c2), the 2-D output views "c" /
    "c2", "bias", "gate", and "gather" (A's row eidx[e]) / "scatter" (C's
    row eidx[e]). Views have unit column stride; K and N multiples of 4,
    rows 16-byte aligned. `persistent` runs one block per SM over all the
    tiles (as kernels I and K launch their gate products)."""
    dev = problems[0]["segs"][0]["a"].device
    if dev.type == "cpu":
        so2_products_reference(problems, n_rows, eidx)
        return
    max_rows = problems[0]["segs"][0]["a"].shape[0]
    if not 0 <= n_rows <= max_rows:
        raise ValueError(f"n_rows {n_rows} outside 0..{max_rows}")
    ev = _row_list(eidx, n_rows, dev)
    ints, ptrs, prep, keep = [], [], 0, []
    for p in problems:
        segs, n = p["segs"], p["n"]
        if not 1 <= len(segs) <= MAXSEG:
            raise ValueError(f"a problem takes 1 to {MAXSEG} segments, got {len(segs)}")
        out_rows = 0 if p.get("scatter") else n_rows  # scattered rows: eidx's, the caller's
        c, ldc = _rows(p["c"], out_rows, n) if p.get("c") is not None else (0, 0)
        c2, ldc2 = _rows(p["c2"], out_rows, n) if p.get("c2") is not None else (0, 0)
        gate, ldg = _rows(p["gate"], n_rows, n) if p.get("gate") is not None else (0, 0)
        bias = 0
        if p.get("bias") is not None:
            keep.append(p["bias"].contiguous())
            bias = _rows(keep[-1][None, :], 1, n)[0]
        ints += [len(segs), int(bool(p.get("gather"))), int(bool(p.get("scatter"))),
                 EPILOGUES[p.get("epi", "store")], p["n"], ldc, ldc2, ldg]
        ptrs += [c, c2, bias, gate]
        for sg in list(segs) + [None] * (MAXSEG - len(segs)):
            if sg is None:
                ints += [0] * 6
                ptrs += [0, 0]
                continue
            k = sg["k"]
            # A's rows come by TMA over max_rows unless gathered (then eidx's, the caller's)
            a, lda = _rows(sg["a"], 0 if p.get("gather") else max_rows, k)
            b, ldb = _rows(sg["b"], *((n, k) if sg.get("btrans") else (k, n)))
            if sg["a"].device != dev or sg["b"].device != dev:
                raise ValueError(f"every tensor must be on {dev}")
            ints += [lda, ldb, k, int(bool(sg.get("btrans"))), int(sg.get("sign", 1)),
                     int(bool(sg.get("rbf16")))]
            ptrs += [a, b]
            prep += 2 * p["n"] * sg["k"]
    nr = torch.tensor([n_rows], dtype=torch.int32, device=dev)
    scratch = torch.empty(prep, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.so2_products_probe(len(problems), (ctypes.c_int * len(ints))(*ints),
                                     (ctypes.c_void_p * len(ptrs))(*ptrs), max_rows,
                                     nr.data_ptr(), ev.data_ptr(), scratch.data_ptr(), prep,
                                     int(persistent), torch.cuda.current_stream(dev).cuda_stream)
    _kernels.raise_on_error(err, "so2_products_probe")
    LAUNCHES["so2_products"] += 1


def so2_live_rows_reference(flags: torch.Tensor, seg: int):
    """Plain version of `so2_live_rows`."""
    live = flags != 0
    eidx = live.nonzero().squeeze(1).int()
    pos = torch.full_like(flags, -1)
    pos[eidx.long()] = torch.arange(len(eidx), dtype=flags.dtype, device=flags.device)
    counts = live.reshape(-1, seg).sum(1)
    rs = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()
    return eidx, pos, rs, len(eidx)


def so2_live_rows(flags: torch.Tensor, seg: int):
    """The engine's live-row list of 0/1 int32 flags [npairs] in segments of
    `seg` slots (`live_rows` in csrc/so2_common.cuh, which every kernel of
    B, D and I–P runs): (eidx: the live slots in order, pos: each slot's
    row or -1, rs: each segment's first row then the count, the count), on
    the card for a card tensor, else the plain version."""
    if flags.dtype != torch.int32 or flags.dim() != 1 or flags.numel() % seg:
        raise ValueError("flags: int32 [npairs], npairs a multiple of seg")
    if flags.device.type == "cpu":
        return so2_live_rows_reference(flags, seg)
    dev, n = flags.device, flags.numel()
    eidx, pos = (torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2))
    rs = torch.empty(n // seg + 1, dtype=torch.int32, device=dev)
    nr = torch.empty(1, dtype=torch.int32, device=dev)
    flags = flags.contiguous()
    with torch.cuda.device(dev):
        err = _lib().so2_live_rows_probe(flags.data_ptr(), eidx.data_ptr(), pos.data_ptr(),
                                         rs.data_ptr(), nr.data_ptr(), n, seg,
                                         torch.cuda.current_stream(dev).cuda_stream)
    _kernels.raise_on_error(err, "so2_live_rows_probe")
    count = int(nr)
    return eidx[:count], pos, rs, count


def so2_wgrads_reference(problems: Sequence[dict], n_rows: int, eidx=None) -> None:
    """Plain version of `so2_wgrads` (a segment's "rbf16": both operands
    rounded to bf16 first)."""
    rows = torch.arange(n_rows, device=problems[0]["out"].device)
    for p in problems:
        m, n, mode = p["m"], p["n"], p.get("amode", "rows")
        acc = 0
        for sg in p["segs"]:
            b = sg["b"][rows, :n]
            if mode == "ones":
                term = b.sum(dim=0, keepdim=True)
            else:
                a = sg["a"][eidx[:n_rows].long() if mode == "gather" else rows, :m]
                if sg.get("rbf16"):
                    a, b = round_bf16(a), round_bf16(b)
                term = a.T @ b
            acc = acc + sg.get("sign", 1.0) * term
        p["out"][:m, :n] = acc


def so2_wgrads(problems: Sequence[dict], n_rows: int, eidx=None) -> None:
    """out[m, n] = Σ_seg sign · Σ_{e < n_rows} A[row(e), m] B[e, n], in place,
    with the engine's weight-gradient path on card tensors (the same bits
    every run), or the plain version on CPU tensors. A problem: "segs" (1
    or 2 dicts: "a" and "b" 2-D views [rows, .], "sign" ±1, "rbf16" both
    operands rounded to bf16, one TF32 pass), "amode"
    ("rows", "gather": A's row eidx[e], "ones": A = 1 and m = 1), "m", "n"
    and the 2-D view "out"."""
    dev = problems[0]["out"].device
    if dev.type == "cpu":
        so2_wgrads_reference(problems, n_rows, eidx)
        return
    max_rows = problems[0]["segs"][0]["b"].shape[0]
    if not 0 <= n_rows <= max_rows:
        raise ValueError(f"n_rows {n_rows} outside 0..{max_rows}")
    ev = _row_list(eidx, n_rows, dev)
    ints, ptrs = [], []
    for p in problems:
        segs, mode = p["segs"], p.get("amode", "rows")
        if not 1 <= len(segs) <= 2:
            raise ValueError(f"a weight-gradient problem takes 1 or 2 segments, got {len(segs)}")
        out, ldo = _rows(p["out"], p["m"], p["n"])
        if p["out"].device != dev:
            raise ValueError(f"every tensor must be on {dev}")
        ints += [len(segs), WGRAD_MODES[mode], p["m"], p["n"], ldo]
        ptrs += [out]
        for sg in list(segs) + [None] * (2 - len(segs)):
            if sg is None:
                ints += [0, 0, 1, 0]
                ptrs += [0, 0]
                continue
            # B's rows (and A's unless gathered) come by TMA / cp.async over max_rows
            a, lda = (0, 0) if mode == "ones" else _rows(
                sg["a"], 0 if mode == "gather" else max_rows, p["m"])
            b, ldb = _rows(sg["b"], max_rows, p["n"])
            if sg["b"].device != dev or (mode != "ones" and sg["a"].device != dev):
                raise ValueError(f"every tensor must be on {dev}")
            ints += [lda, ldb, int(sg.get("sign", 1)), int(bool(sg.get("rbf16")))]
            ptrs += [a, b]
    lib = _lib()
    c_ints = (ctypes.c_int * len(ints))(*ints)
    part = torch.empty(lib.so2_wgrads_part_floats(len(problems), c_ints, max_rows),
                       dtype=torch.float32, device=dev)
    nr = torch.tensor([n_rows], dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.so2_wgrads_probe(len(problems), c_ints, (ctypes.c_void_p * len(ptrs))(*ptrs),
                                   max_rows, nr.data_ptr(), ev.data_ptr(), part.data_ptr(),
                                   part.numel(), torch.cuda.current_stream(dev).cuda_stream)
    _kernels.raise_on_error(err, "so2_wgrads_probe")
    LAUNCHES["so2_wgrads"] += 1
