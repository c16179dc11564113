"""Fused eSCN message layer: CUDA kernels M (forward) and N (backward).

The port of ``nabladft_tpu/ops/pallas/escn_layer.py``: `escn_message` (a
`jax.custom_vjp` over `_fwd_kernel` / `_bwd_kernel`). Per molecule b and
receiver i, over its neighbours j (pairs whose masked compact Wigner row d is
zero contribute nothing):

  src = D x_j, tgt = D x_i                 the m-major truncated stacks [S_t, C]
  msg = Σ_stream SO2(stream, silu(xe wg + bg))
  out[b, i] = Σ_j Dᵀ from_g silu(to_g msg)  [S, C]

with the SO(2) block of each stream: m=0 (f0 W1_0 ⊙ g0) W2_0; m=1..M the packed
fc1 over the +m and -m rows, the r / i halves gated and multiplied by w2r /
w2i, recombined as (rp - im, rm + ip).

Layouts: x [B,A,S,C] (one x: the JAX op takes it twice, S-major and
atom-major, and returns gx and gxi; here autograd gives their sum); d
[B,A,A,K] compact masked Wigner values (K = 235 at L=6, M=2, not padded to
the TPU's lanes); xe [B,A,A,EC]; weights as the JAX op: wg [2,EC,(2M+1)H],
bg [2,1,(2M+1)H], w1_0 [2,(L+1)C,H], w2_0 [2,H,(L+1)C], then per m fc1
[2,n_l C,2H], w2r, w2i [2,H,n_l C] (`ws`, in that order). All float32.

The VJP keeps the JAX contract: d gets no cotangent (eSCN trains direct
forces; positions are never differentiated), x, xe and every weight do. Each
kernel has a plain PyTorch version here; a wrapper takes it only for CPU
tensors, and a CUDA tensor launches the kernel (``csrc/escn_layer.cu``, built
for L=6, M=2) or raises.

``mxu_bf16=True`` is the TPU kernels' bf16 mode (the model's
``compute_dtype="bfloat16"``): every product that `_message_pipeline` and
the hand-written `_pipeline_bwd` pass through `_mdot` (the gate product, the
SO(2) products, their transposes and every weight gradient) rounds both
operands to bf16 and sums in float32 (`mdot`); everything else, inputs and
outputs included, stays float32. The kernels' entry points ``escn_fwd_bf16``
/ ``escn_bwd_bf16`` count as "escn_fwd_bf16" / "escn_bwd_bf16".

Also here: the host tables (the S2 grids and their separable factors, float64)
and the JAX package's FLOP model of the layer.
"""

from __future__ import annotations

import ctypes
import functools
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nabladft_tpu_torch.ops import _kernels, so3

# launches of each CUDA kernel wrapper since the last reset
LAUNCHES: Dict[str, int] = {"escn_fwd": 0, "escn_bwd": 0, "escn_fwd_bf16": 0, "escn_bwd_bf16": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# host tables (float64)
# ---------------------------------------------------------------------------


def fibonacci_sphere(n: int) -> np.ndarray:
    """n points [n, 3] on the unit sphere (the heads' sample points)."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], -1)


@lru_cache(maxsize=None)
def sh_on_points(l_max: int, n_points: int) -> np.ndarray:
    """Y [P, (L+1)²] (orthonormal) at the Fibonacci points."""
    return so3.real_sph_harm_np(fibonacci_sphere(n_points), l_max)


@lru_cache(maxsize=None)
def grid_mats(l_max: int, n_points: int, m_max: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """(to_grid [P, S], from_grid [S, P]) on a Gauss-Legendre × uniform-φ grid:
    n_θ = max(L+1, round(sqrt(n_points/2))) latitudes, n_φ = 2 n_θ - 1
    longitudes, capped at 2 m_max + 1 for per-edge truncated signals. With
    n_θ ≥ L+1 and n_φ ≥ 2L+1, from_grid @ to_grid = I_S to float64 round-off."""
    n_theta = max(l_max + 1, int(round((n_points / 2.0) ** 0.5)))
    n_phi = 2 * n_theta - 1
    if m_max is not None and m_max < l_max:
        n_phi = 2 * m_max + 1
    ct, wt = np.polynomial.legendre.leggauss(n_theta)
    phi = 2 * np.pi * np.arange(n_phi) / n_phi
    st = np.sqrt(1.0 - ct**2)
    pts = np.stack([np.outer(st, np.cos(phi)).ravel(), np.outer(st, np.sin(phi)).ravel(),
                    np.outer(ct, np.ones(n_phi)).ravel()], axis=-1)
    y = so3.real_sph_harm_np(pts, l_max)
    w = (np.outer(wt, np.ones(n_phi)) * (2 * np.pi / n_phi)).ravel()
    return y, (y * w[:, None]).T


def s_trunc(l_max: int, m_max: int) -> int:
    return sum(2 * min(l, m_max) + 1 for l in range(l_max + 1))


@lru_cache(maxsize=None)
def _spans(l_max: int, m_max: int) -> Tuple[Tuple[int, int], ...]:
    """(start, n_l) spans of the m-major stack: m=0, then +m / -m per m."""
    spans = [(0, l_max + 1)]
    off = l_max + 1
    for m in range(1, m_max + 1):
        n_l = l_max + 1 - m
        spans.append((off, n_l))
        spans.append((off + n_l, n_l))
        off += 2 * n_l
    return tuple(spans)


@lru_cache(maxsize=None)
def _grid_tables(l_max: int, m_max: int, n_points: int) -> Tuple[np.ndarray, np.ndarray]:
    """(to_g [P, S_t], from_g [S_t, P]) of the truncated grid, m-major columns."""
    to_g, from_g = grid_mats(l_max, n_points, m_max)
    cols = so3.mmajor_cols(l_max, m_max)
    return np.asarray(to_g[:, cols], np.float64), np.asarray(from_g[cols], np.float64)


@lru_cache(maxsize=None)
def _grid_factor_tables(l_max: int, m_max: int, n_points: int):
    """Separable (latitude × longitude) factors of the truncated grid maps:
    every m-major column is rank-1, Y_lm(θ_t, φ_f) = lat[s][t] · lon[g(s)][f],
    the longitude vector shared by the rows of one signed m. Returns (grp
    [S_t], lat_to [S_t, n_t], lon_to [G, n_p], lat_from [S_t, n_t], lon_from
    [G, n_p], n_t, n_p); asserts that the factors rebuild the tables."""
    to_g, from_g = _grid_tables(l_max, m_max, n_points)
    rows = so3.mmajor_rows(l_max, m_max)
    st = to_g.shape[1]
    n_t = max(l_max + 1, int(round((n_points / 2.0) ** 0.5)))
    n_p = to_g.shape[0] // n_t
    assert n_t * n_p == to_g.shape[0]
    keys = sorted({m for (_, m) in rows}, key=lambda m: (abs(m), -m))
    grp = np.array([keys.index(m) for (_, m) in rows], np.int64)
    g_n = len(keys)
    lon_to, lon_from = np.zeros((g_n, n_p)), np.zeros((g_n, n_p))
    lat_to, lat_from = np.zeros((st, n_t)), np.zeros((st, n_t))
    for g in range(g_n):
        s0 = int(np.argmax(grp == g))
        for col, lon in ((to_g[:, s0], lon_to), (from_g[s0, :], lon_from)):
            v = np.linalg.svd(col.reshape(n_t, n_p), full_matrices=False)[2][0]
            if v[np.argmax(np.abs(v))] < 0:
                v = -v
            lon[g] = v
    for s in range(st):
        g = int(grp[s])
        lat_to[s] = to_g[:, s].reshape(n_t, n_p) @ lon_to[g]
        lat_from[s] = from_g[s, :].reshape(n_t, n_p) @ lon_from[g]
        assert np.abs(np.outer(lat_to[s], lon_to[g]).ravel() - to_g[:, s]).max() < 1e-9
        assert np.abs(np.outer(lat_from[s], lon_from[g]).ravel() - from_g[s, :]).max() < 1e-9
    return grp, lat_to, lon_to, lat_from, lon_from, n_t, n_p


@lru_cache(maxsize=None)
def _expand_matrix(l_max: int, m_max: int) -> np.ndarray:
    """E [K, S_t·S] (0/1): d @ E is the block-diagonal truncated rotation
    [S_t, S] of the compact values d (row r = (l, m), column l² + col)."""
    offs, k = so3.trunc_compact_layout(l_max, m_max)
    s_full = (l_max + 1) ** 2
    out = np.zeros((k, s_trunc(l_max, m_max) * s_full), np.float32)
    for r, (l, m) in enumerate(so3.mmajor_rows(l_max, m_max)):
        base = offs[l] + (m + min(l, m_max)) * (2 * l + 1)
        for col in range(2 * l + 1):
            out[base + col, r * s_full + l * l + col] = 1.0
    return out


@functools.lru_cache(maxsize=None)
def _table(name: str, l_max: int, m_max: int, n_points: int, device: str,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A table of `dtype` on `device`: "to_g", "from_g" (truncated grid, m-major),
    "expand" (`_expand_matrix`), or the factored grid's "lat_to", "lon_to",
    "lat_from", "lon_from" with the latitude factors as [G, n_t, S_t]
    (zero off the rows of each longitude group)."""
    if name in ("to_g", "from_g"):
        arr = _grid_tables(l_max, m_max, n_points)[name == "from_g"]
    elif name == "expand":
        arr = _expand_matrix(l_max, m_max)
    else:
        grp, lat_to, lon_to, lat_from, lon_from, n_t, _ = _grid_factor_tables(
            l_max, m_max, n_points)
        if name.startswith("lon"):
            arr = lon_to if name == "lon_to" else lon_from
        else:
            lat = lat_to if name == "lat_to" else lat_from
            arr = np.zeros((lon_to.shape[0], n_t, len(grp)))
            for s, g in enumerate(grp):
                arr[g, :, s] = lat[s]
    return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# the JAX package's FLOP model
# ---------------------------------------------------------------------------


def _rot_macs(l_max: int, m_max: int) -> int:
    return sum((2 * min(l, m_max) + 1) * (2 * l + 1) for l in range(l_max + 1))


def _so2_matmul_flops(a: int, c: int, h: int, l_max: int, m_max: int) -> int:
    n0 = l_max + 1
    f = 2 * a * (n0 * c) * h * 2
    for m in range(1, m_max + 1):
        n_l = l_max + 1 - m
        f += 2 * (2 * a) * (n_l * c) * (2 * h)
        f += 2 * 2 * (2 * a) * h * (n_l * c)
    return f


def layer_fwd_flops_split(b, a, c, h, ec, gates, l_max, m_max, n_grid) -> Tuple[int, int]:
    """`layer_fwd_flops` as (products, other): the gate product and the SO(2)
    matmuls (the product engine's work, on the tensor cores), and the
    rotations and the grid activation."""
    st = s_trunc(l_max, m_max)
    products = 2 * a * ec * gates * 2 + 2 * _so2_matmul_flops(a, c, h, l_max, m_max)
    other = (2 * _rot_macs(l_max, m_max) * a * c * 2 + 2 * 2 * n_grid * st * a * c
             + 2 * _rot_macs(l_max, m_max) * a * c)
    return int(b * a * products), int(b * a * other)


def layer_fwd_flops(b, a, c, h, ec, gates, l_max, m_max, n_grid) -> int:
    return sum(layer_fwd_flops_split(b, a, c, h, ec, gates, l_max, m_max, n_grid))


def layer_bwd_flops(b, a, c, h, ec, gates, l_max, m_max, n_grid) -> int:
    return int(2.6 * layer_fwd_flops(b, a, c, h, ec, gates, l_max, m_max, n_grid))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (nearest-even, as astype(bfloat16)), in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


class _MDot(torch.autograd.Function):
    """The TPU kernels' `_mdot(a, b, True)`: a @ b with both operands rounded
    to bf16 and float32 sums. Its backward is the hand-written VJPs' (each
    transposed and weight-gradient product is an `_mdot` of its own): g and
    the other operand rounded, ga = g bᵀ and gb = aᵀ g (b 2-D, summed over
    a's leading axes)."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = round_bf16(a), round_bf16(b)
        ctx.save_for_backward(ar, br)
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = round_bf16(g)
        return gr @ br.T, ar.reshape(-1, ar.shape[-1]).T @ gr.reshape(-1, gr.shape[-1])


def mdot(a: torch.Tensor, b: torch.Tensor, mxu_bf16: bool = False) -> torch.Tensor:
    """a @ b (b a 2-D weight), or in the bf16 mode `_MDot`."""
    return _MDot.apply(a, b) if mxu_bf16 else a @ b


def _so2_block(flat, gates, w1_0, w2_0, mws, l_max: int, m_max: int, c: int, h: int,
               mxu_bf16: bool = False):
    """One stream's SO(2) block on m-major flats [..., S_t·C]; gates silu'd [..., (2M+1)H]."""
    mm = functools.partial(mdot, mxu_bf16=mxu_bf16)
    spans = _spans(l_max, m_max)
    s0, n0 = spans[0]
    parts = [mm(mm(flat[..., s0 * c:(s0 + n0) * c], w1_0) * gates[..., :h], w2_0)]
    for m in range(1, m_max + 1):
        (sp, n_l), (sm, _) = spans[2 * m - 1], spans[2 * m]
        fc1, w2r, w2i = mws[3 * (m - 1):3 * m]
        hp = mm(flat[..., sp * c:(sp + n_l) * c], fc1)
        hm = mm(flat[..., sm * c:(sm + n_l) * c], fc1)
        gr, gi = gates[..., (2 * m - 1) * h:2 * m * h], gates[..., 2 * m * h:(2 * m + 1) * h]
        rp, rm = mm(hp[..., :h] * gr, w2r), mm(hm[..., :h] * gr, w2r)
        ip, im = mm(hp[..., h:] * gi, w2i), mm(hm[..., h:] * gi, w2i)
        parts += [rp - im, rm + ip]
    return torch.cat(parts, dim=-1)


def grid_act(msg: torch.Tensor, l_max: int, m_max: int, n_grid: int) -> torch.Tensor:
    """silu on the truncated grid of m-major stacks [..., S_t, C], by the
    two-stage separable transform of `_grid_silu_factored`."""
    t = functools.partial(_table, l_max=l_max, m_max=m_max, n_points=n_grid,
                          device=str(msg.device), dtype=msg.dtype)
    u = torch.einsum("gts,...sc->...gtc", t("lat_to"), msg)
    grid = F.silu(torch.einsum("gf,...gtc->...tfc", t("lon_to"), u))
    v = torch.einsum("gf,...tfc->...gtc", t("lon_from"), grid)
    return torch.einsum("gts,...gtc->...sc", t("lat_from"), v)


def escn_fwd_reference(x, d, xe, *ws, l_max: int, m_max: int, n_grid: int,
                       mxu_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel M: out [B,A,S,C] (`mxu_bf16`: its
    products' operands rounded to bf16)."""
    b, a, s, c = x.shape
    st, h = s_trunc(l_max, m_max), ws[2].shape[-1]
    expand = _table("expand", l_max, m_max, n_grid, str(d.device), d.dtype)
    dt = (d @ expand).reshape(b, a, a, st, s)
    streams = (torch.einsum("bijrs,bjsc->bijrc", dt, x), torch.einsum("bijrs,bisc->bijrc", dt, x))
    wg, bg, w1_0, w2_0 = ws[:4]
    msg = None
    for k, stack in enumerate(streams):
        gates = F.silu(mdot(xe, wg[k], mxu_bf16) + bg[k])
        out = _so2_block(stack.reshape(b, a, a, st * c), gates, w1_0[k], w2_0[k],
                         [w[k] for w in ws[4:]], l_max, m_max, c, h, mxu_bf16)
        msg = out if msg is None else msg + out
    msg = grid_act(msg.reshape(b, a, a, st, c), l_max, m_max, n_grid)
    return torch.einsum("bijrs,bijrc->bisc", dt, msg)


def escn_bwd_reference(x, d, xe, *ws, g, l_max: int, m_max: int, n_grid: int,
                       mxu_bf16: bool = False):
    """Plain PyTorch version of kernel N (autograd of kernel M's plain
    version; in the bf16 mode `_MDot`'s backward rounds as `_pipeline_bwd`
    does, product by product): (gx, gxe, *gws) in the order of ws; d gets
    none."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, xe, *ws)]
        out = escn_fwd_reference(ins[0], d.detach(), *ins[1:], l_max=l_max, m_max=m_max,
                                 n_grid=n_grid, mxu_bf16=mxu_bf16)
        grads = torch.autograd.grad(out, ins, g)
    return tuple(t.detach() for t in grads)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load("escn_layer")
    p, i, pp, ll = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong
    lib.escn_supported.argtypes = [i, i]
    lib.escn_supported.restype = i
    lib.escn_scratch_floats.argtypes = [i] * 9
    lib.escn_scratch_floats.restype = ll
    lib.escn_scratch_ints.argtypes = [i, i]
    lib.escn_scratch_ints.restype = ll
    for sfx in ("", "_bf16"):
        fwd, bwd = getattr(lib, "escn_fwd" + sfx), getattr(lib, "escn_bwd" + sfx)
        fwd.argtypes = [p, p, p, pp, p, p, p, p, p] + [i] * 9 + [p]
        fwd.restype = i
        bwd.argtypes = [p, p, p, pp, p, p, p, p, p, pp, p, p] + [i] * 9 + [p]
        bwd.restype = i
    return lib


def weight_shapes(l_max: int, m_max: int, c: int, h: int, ec: int) -> List[tuple]:
    """The shapes of ws: wg, bg, w1_0, w2_0, then fc1, w2r, w2i per m."""
    g = (2 * m_max + 1) * h
    out = [(2, ec, g), (2, 1, g), (2, (l_max + 1) * c, h), (2, h, (l_max + 1) * c)]
    for m in range(1, m_max + 1):
        n_l = l_max + 1 - m
        out += [(2, n_l * c, 2 * h), (2, h, n_l * c), (2, h, n_l * c)]
    return out


def _check(x, d, xe, ws, l_max: int, m_max: int, g=None) -> torch.device:
    if x.ndim != 4 or d.ndim != 4 or xe.ndim != 4:
        raise ValueError(f"x, d, xe must be 4-d, got {tuple(x.shape)}, {tuple(d.shape)}, "
                         f"{tuple(xe.shape)}")
    b, a, s, c = x.shape
    h, ec = ws[2].shape[-1], xe.shape[-1]
    k = so3.trunc_compact_layout(l_max, m_max)[1]
    if s != (l_max + 1) ** 2:
        raise ValueError(f"x has {s} SH rows, expected {(l_max + 1) ** 2} for l_max={l_max}")
    if len(ws) != 4 + 3 * m_max:
        raise ValueError(f"expected {4 + 3 * m_max} weight arrays for m_max={m_max}, got {len(ws)}")
    shapes = dict(x=(b, a, s, c), d=(b, a, a, k), xe=(b, a, a, ec))
    tensors = dict(x=x, d=d, xe=xe)
    for n, (w, shp) in enumerate(zip(ws, weight_shapes(l_max, m_max, c, h, ec))):
        tensors[f"w{n}"], shapes[f"w{n}"] = w, shp
    if g is not None:
        tensors["g"], shapes["g"] = g, (b, a, s, c)
    dev = _kernels.check_inputs(tensors, shapes)
    if dev.type == "cuda":
        if not _lib().escn_supported(l_max, m_max):
            raise ValueError(f"the eSCN kernels are built for l_max=6, m_max=2, "
                             f"not {l_max}, {m_max}")
        if c % 8 or h % 8 or ec % 8:
            raise ValueError(f"the eSCN kernels take C, H, EC multiples of 8, got {c}, {h}, {ec}")
        for n, t in tensors.items():
            if t.data_ptr() % 16:
                raise ValueError(f"{n} is not 16-byte aligned")
    return dev


def _ptrs(ts: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _scratch(dev, bwd: bool, b, a, c, h, ec, p, l_max, m_max):
    lib = _lib()
    nf = lib.escn_scratch_floats(int(bwd), b, a, c, h, ec, p, l_max, m_max)
    ni = lib.escn_scratch_ints(b, a)
    return (torch.empty(nf, dtype=torch.float32, device=dev),
            torch.empty(ni, dtype=torch.int32, device=dev))


def _launch(name: str, dev, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_lib(), name)(*args, stream)
    _kernels.raise_on_error(err, f"{name} launch")


def escn_fwd(x, d, xe, *ws, l_max: int, m_max: int, n_grid: int,
             mxu_bf16: bool = False) -> torch.Tensor:
    """Kernel M: out [B,A,S,C] (`mxu_bf16`: its bf16 mode, escn_fwd_bf16)."""
    dev = _check(x, d, xe, ws, l_max, m_max)
    if dev.type == "cpu":
        return escn_fwd_reference(x, d, xe, *ws, l_max=l_max, m_max=m_max, n_grid=n_grid,
                                  mxu_bf16=mxu_bf16)
    b, a, s, c = x.shape
    h, ec = ws[2].shape[-1], xe.shape[-1]
    tog = _table("to_g", l_max, m_max, n_grid, str(dev))
    fromg = _table("from_g", l_max, m_max, n_grid, str(dev))
    p = tog.shape[0]
    out = torch.empty((b, a, s, c), dtype=torch.float32, device=dev)
    fs, iscr = _scratch(dev, False, b, a, c, h, ec, p, l_max, m_max)
    name = "escn_fwd_bf16" if mxu_bf16 else "escn_fwd"
    _launch(name, dev, x.data_ptr(), d.data_ptr(), xe.data_ptr(), _ptrs(ws), tog.data_ptr(),
            fromg.data_ptr(), out.data_ptr(), fs.data_ptr(), iscr.data_ptr(), b, a, c, h, ec,
            d.shape[-1], p, l_max, m_max)
    LAUNCHES[name] += 1
    _kernels.count_flops(
        lambda: flops_bytes("M", x, d, xe, ws, l_max, m_max, n_grid, mxu_bf16)["flops_live"])
    return out


def escn_bwd(x, d, xe, *ws, g, l_max: int, m_max: int, n_grid: int, mxu_bf16: bool = False):
    """Kernel N: (gx, gxe, *gws) in the order of ws (`mxu_bf16`: its bf16
    mode, escn_bwd_bf16)."""
    dev = _check(x, d, xe, ws, l_max, m_max, g)
    if dev.type == "cpu":
        return escn_bwd_reference(x, d, xe, *ws, g=g, l_max=l_max, m_max=m_max, n_grid=n_grid,
                                  mxu_bf16=mxu_bf16)
    b, a, s, c = x.shape
    h, ec = ws[2].shape[-1], xe.shape[-1]
    tog = _table("to_g", l_max, m_max, n_grid, str(dev))
    fromg = _table("from_g", l_max, m_max, n_grid, str(dev))
    p = tog.shape[0]
    gx = torch.empty_like(x)
    gxe = torch.zeros_like(xe)  # the kernel writes the live pairs' rows only
    gws = [torch.empty_like(w) for w in ws]
    fs, iscr = _scratch(dev, True, b, a, c, h, ec, p, l_max, m_max)
    name = "escn_bwd_bf16" if mxu_bf16 else "escn_bwd"
    _launch(name, dev, x.data_ptr(), d.data_ptr(), xe.data_ptr(), _ptrs(ws), tog.data_ptr(),
            fromg.data_ptr(), g.data_ptr(), gx.data_ptr(), gxe.data_ptr(), _ptrs(gws),
            fs.data_ptr(), iscr.data_ptr(), b, a, c, h, ec, d.shape[-1], p, l_max, m_max)
    LAUNCHES[name] += 1
    _kernels.count_flops(
        lambda: flops_bytes("N", x, d, xe, ws, l_max, m_max, n_grid, mxu_bf16)["flops_live"])
    return (gx, gxe, *gws)


class ESCNMessageFn(torch.autograd.Function):
    """`escn_message`'s custom VJP: forward = kernel M, backward = kernel N,
    both in the mode `mxu_bf16`. Inputs (l_max, m_max, n_grid, mxu_bf16, x,
    d, xe, *ws); d gets no gradient."""

    @staticmethod
    def forward(ctx, l_max, m_max, n_grid, mxu_bf16, x, d, xe, *ws):
        ctx.save_for_backward(x, d, xe, *ws)
        ctx.dims = dict(l_max=l_max, m_max=m_max, n_grid=n_grid, mxu_bf16=mxu_bf16)
        return escn_fwd(x, d, xe, *ws, **ctx.dims)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, d, xe, *ws = ctx.saved_tensors
        gx, gxe, *gws = escn_bwd(x, d, xe, *ws, g=g.contiguous(), **ctx.dims)
        return (None, None, None, None, gx, None, gxe, *gws)


def escn_message(x, d, xe, *ws, l_max: int, m_max: int, n_grid: int,
                 mxu_bf16: bool = False) -> torch.Tensor:
    """Fused eSCN message layer: [B,A,S,C]."""
    return ESCNMessageFn.apply(l_max, m_max, n_grid, mxu_bf16, x, d, xe, *ws)


# ---------------------------------------------------------------------------
# work the kernels need on given inputs
# ---------------------------------------------------------------------------


def live_pairs(d: torch.Tensor) -> int:
    """Pairs whose compact Wigner row is not zero: the rows the kernels run."""
    return int((d != 0).any(dim=-1).sum())


def flops_bytes(kind: str, x: torch.Tensor, d: torch.Tensor, xe: torch.Tensor, ws,
                l_max: int, m_max: int, n_grid: int, mxu_bf16: bool = False) -> Dict[str, int]:
    """The work of kernel `kind` ("M" or "N") on these inputs: "flops" the
    JAX package's FLOP model over all B·A² pairs, "flops_live" the same model
    per pair times the live pairs (the kernels skip the others, and the bound
    counts what the data needs), "flops_live_products" / "flops_live_other"
    its split (the product engine's work and the rest;
    `layer_fwd_flops_split`), and "bytes" with each input read once and each
    output written once (float32 in both modes). "products_dtype" says what
    the products' operands are: "float32" (the bound's rate 3xTF32) or, in
    the bf16 mode, "bfloat16" (the dense bf16 tensor-core rate)."""
    b, a, s, c = x.shape
    h, ec, gates = ws[2].shape[-1], xe.shape[-1], ws[0].shape[-1]
    fn = layer_fwd_flops if kind == "M" else layer_bwd_flops
    flops = fn(b, a, c, h, ec, gates, l_max, m_max, n_grid)
    prod, other = layer_fwd_flops_split(b, a, c, h, ec, gates, l_max, m_max, n_grid)
    live, slots = live_pairs(d), max(b * a * a, 1)
    scale = (1.0 if kind == "M" else 2.6) * live / slots
    n_w = sum(w.numel() for w in ws)
    ins = x.numel() + d.numel() + xe.numel() + n_w
    nbytes = 4 * (ins + x.numel() if kind == "M"
                  else ins + x.numel() + x.numel() + xe.numel() + n_w)
    return {"flops": flops, "flops_live": int(flops * live / slots),
            "flops_live_products": int(prod * scale), "flops_live_other": int(other * scale),
            "bytes": nbytes, "products_dtype": "bfloat16" if mxu_bf16 else "float32"}
