"""The precision choice of the SO(2) product engine (so2_common.cuh), emulated
on the CPU, and the split of the kernels' FLOP models into product and other
work.

3xTF32: x = hi + lo with hi = x rounded to TF32's 10 mantissa bits (nearest)
and lo = tf32(x - hi); a product is a_hi b_hi + a_hi b_lo + a_lo b_hi with
float32 sums. At kernel P's product shapes (K = 1,792 for conv 1's m=0 rows,
3,072 and 2,560 for its m=1 and m=2 blocks, N the conv's columns), with the
inputs at the scale of chip_smoke.eqv2_kernel_inputs (activations ~N(0, 0.5²),
weights a linear layer's K^-1/2), it stays within the kernels' tolerance
(2e-5 of max |C|, chip_smoke.KERNEL_RTOL) of float64, and one-pass TF32 does
not.
"""

import numpy as np
import pytest
import torch

from nabladft_tpu_torch.ops import eqv2_attn as ea
from nabladft_tpu_torch.ops import escn_layer as el

KERNEL_RTOL = 2e-5
# (K, N) of P's conv-1 products at configs/equiformer_v2.yaml's widths (2C = 256, CO = 128)
SHAPES = [(7 * 256, 7 * 128), (2 * 6 * 256, 6 * 128), (2 * 5 * 256, 5 * 128)]
ROWS = 256


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits, nearest-even (finite inputs)."""
    bits = x.view(torch.int32)
    keep = ((bits >> 13) & 1) + 0x0FFF
    return ((bits + keep) & ~0x1FFF).view(torch.float32)


def products_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return ah @ bh + (ah @ bl + al @ bh)


def _inputs(k: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy((rng.standard_normal((ROWS, k)) * 0.5).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32))
    return a, b


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref).abs().max() / ref.abs().max())


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -10), 3.0e-3])
    r = tf32(x)
    # ties to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9; exact TF32 values stay
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2.0 ** -9 and r[3] == x[3]
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
    assert float((r[4] - x[4]).abs()) <= 2.0 ** -11 * float(x[4])


@pytest.mark.parametrize("k,n", SHAPES)
def test_3xtf32_within_kernel_tolerance(k, n):
    a, b = _inputs(k, n, k + n)
    ref = a.double() @ b.double()
    assert _rel(products_3xtf32(a, b), ref) <= KERNEL_RTOL


@pytest.mark.parametrize("k,n", SHAPES)
def test_one_pass_tf32_is_not(k, n):
    a, b = _inputs(k, n, k + n)
    ref = a.double() @ b.double()
    assert _rel(tf32(a) @ tf32(b), ref) > KERNEL_RTOL


def test_engine_plain_versions_on_cpu():
    """The CPU path of the engine's wrappers (its plain versions) against
    float64 products written out by hand."""
    rng = np.random.default_rng(3)
    rows, slots, k, n = 37, 50, 24, 12
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    a, b, bt, gate, bias = mk(slots, k), mk(k, n), mk(n, k), mk(slots, n), mk(n)
    eidx = torch.from_numpy(np.sort(rng.choice(slots, rows, replace=False)).astype(np.int32))
    c, c2, cs = torch.zeros(slots, n), torch.zeros(slots, n), torch.zeros(slots, n)
    ea.so2_products([dict(segs=[dict(a=a, b=b, k=k), dict(a=a, b=bt, k=k, btrans=True, sign=-1)],
                          n=n, epi="gated", c=c, c2=c2, gate=gate),
                     dict(segs=[dict(a=a, b=b, k=k)], n=n, epi="gates", c2=cs, bias=bias,
                          gather=True, scatter=True)], rows, eidx)
    ad, e = a.double(), eidx.long()
    acc = ad[:rows] @ b.double() - ad[:rows] @ bt.double().T
    assert torch.allclose(c[:rows].double(), acc, atol=1e-5)
    assert torch.allclose(c2[:rows].double(), acc * gate[:rows].double(), atol=1e-5)
    want = torch.nn.functional.silu(ad[e] @ b.double() + bias.double())
    assert torch.allclose(cs[e].double(), want, atol=1e-5)

    out, ones = torch.zeros(k, n), torch.zeros(1, n)
    ea.so2_wgrads([dict(segs=[dict(a=a, b=gate), dict(a=a, b=gate, sign=-1)], amode="gather",
                        m=k, n=n, out=out),
                   dict(segs=[dict(a=None, b=gate, sign=-1)], amode="ones", m=1, n=n, out=ones)],
                  rows, eidx)
    assert torch.allclose(out.double(), torch.zeros(k, n, dtype=torch.float64), atol=1e-5)
    assert torch.allclose(ones.double(), -gate[:rows].double().sum(0, keepdim=True), atol=1e-5)


def _eqv2_old(c2, co, ec, l_max, m_max, n_grid, nh, va):
    """`edge_fwd_flops` as it was written before its split."""
    st, n0, rot = el.s_trunc(l_max, m_max), l_max + 1, el._rot_macs(l_max, m_max)
    so2_1 = 2 * (n0 * c2) * (n0 * co + nh * va + co)
    so2_2 = 2 * (n0 * co) * (n0 * co)
    for m in range(1, m_max + 1):
        n_l = l_max + 1 - m
        so2_1 += 2 * 2 * (n_l * c2) * (2 * n_l * co)
        so2_2 += 2 * 2 * (n_l * co) * (2 * n_l * co)
    return (2 * rot * (c2 // 2) * 2 + 2 * ec * (n0 * c2) + so2_1 + so2_2
            + 2 * 2 * n_grid * st * co + 2 * nh * va * 6 + 2 * rot * co)


def _escn_old(b, a, c, h, ec, gates, l_max, m_max, n_grid):
    """`layer_fwd_flops` as it was written before its split."""
    st = el.s_trunc(l_max, m_max)
    per = (2 * el._rot_macs(l_max, m_max) * a * c * 2 + 2 * a * ec * gates * 2
           + 2 * el._so2_matmul_flops(a, c, h, l_max, m_max) + 2 * 2 * n_grid * st * a * c
           + 2 * el._rot_macs(l_max, m_max) * a * c)
    return int(b * a * per)


@pytest.mark.parametrize("kind", ["O", "P"])
def test_eqv2_flop_split_adds_up(kind):
    """Product and other FLOPs of O and P add up to flops_live, which is the
    model as it was (full widths, 8 heads x 64 alpha channels, 72 grid points)."""
    per = ea.edge_fwd_flops(256, 128, 384, 6, 2, 72, 8, 64)
    assert per == _eqv2_old(256, 128, 384, 6, 2, 72, 8, 64)
    prod, other = ea.edge_fwd_flops_split(256, 128, 384, 6, 2, 72, 8, 64)
    assert prod + other == per and prod > 5 * other
    b, a, k, c, co, ec, nh, va = 2, 6, 5, 128, 128, 384, 8, 64
    rng = np.random.default_rng(1)
    ws = [torch.zeros(s) for s in ea.weight_shapes(6, 2, c, co, ec, nh, va)]
    maskf = torch.from_numpy((rng.random((b, a, k)) > 0.3).astype(np.float32))
    work = ea.flops_bytes(kind, torch.zeros(b, a, 49, c), torch.zeros(b, a, k, dtype=torch.int32),
                          torch.zeros(b, a, k, 1), torch.zeros(b, a, k, ec), maskf,
                          torch.zeros(b, a, k, nh), ws, l_max=6, m_max=2, n_grid=72, nh=nh)
    live = int((maskf > 0.5).sum())
    scale = 2.6 if kind == "P" else 1.0
    assert work["flops_live"] == int(scale * per * live)
    assert abs(work["flops_live_products"] + work["flops_live_other"] - work["flops_live"]) <= 2


@pytest.mark.parametrize("kind", ["M", "N"])
def test_escn_flop_split_adds_up(kind):
    b, a, c, h, ec, gates = 2, 7, 128, 256, 128, 5 * 256
    total = el.layer_fwd_flops(b, a, c, h, ec, gates, 6, 2, 128)
    assert total == _escn_old(b, a, c, h, ec, gates, 6, 2, 128)
    prod, other = el.layer_fwd_flops_split(b, a, c, h, ec, gates, 6, 2, 128)
    assert prod + other == total and prod > 5 * other
    rng = np.random.default_rng(2)
    d = torch.from_numpy((rng.random((b, a, a, 4)) > 0.5).astype(np.float32))
    ws = [torch.zeros(s) for s in el.weight_shapes(6, 2, c, h, ec)]
    work = el.flops_bytes(kind, torch.zeros(b, a, 49, c), d, torch.zeros(b, a, a, ec), ws,
                          l_max=6, m_max=2, n_grid=128)
    assert abs(work["flops_live_products"] + work["flops_live_other"] - work["flops_live"]) <= 2
