"""The plain versions of QHNet's kernels I-L and their autograd Functions
against the JAX package's `conv_tp` / `pair_tp` (Pallas in interpret mode).

As tests/ops/test_qhnet_tp.py runs them: LM=2 (14 paths), B=2, A=11, C=8,
atoms padded to a multiple of 8 on the JAX side only (the port's kernels
mask their own ragged edge). Forward values and every cotangent the
contracts define (gx, gzi, ghr, ghs, gW2r, gb2r, gW2s, gb2s) within rtol
2e-5 / atol 2e-5 (that file's tolerance for fp32 sums in another order).
The path layouts and FLOP models equal the JAX ones at LMAX=4.

The staged versions (`conv_fwd_staged`, `pair_fwd_staged`: the card's
decomposition of I and K, the live pairs only, w = u_r ⊙ u_s in one array,
the tensor-product stage by l3 group; `conv_bwd_staged`, `pair_bwd_staged`:
that of J and L, the live pairs only, gate products, the tensor-product
stage writing gu, the gradient products, L's gx as chunked partials summed
in order) are held against the same JAX ops and VJPs within 1e-5 x max
|output|, the forward also with one receiver that has no live pair.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.models import qhnet as Q
from nabladft_tpu.ops.pallas import qhnet_tp as K
from nabladft_tpu_torch.ops import qhnet_tp as qt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LM = 2
B, A, C = 2, 11, 8
S = (LM + 1) ** 2
P = len(K.tp_paths(LM))
TOL = dict(rtol=2e-5, atol=2e-5)
A_PAD = -(-A // 8) * 8


def _pad(x, axes):
    return Q._pad_atoms(x, axes, A_PAD)


@pytest.fixture(scope="module")
def conv():
    rng = np.random.default_rng(0)
    f32 = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    sh = f32(B, A, A, S)
    adj = rng.random((B, A, A)) < 0.6
    cgsh = (np.where(adj[..., None], sh, 0.0) @ K.cgsh_matrix(LM)).astype(np.float32)
    ins = dict(x=f32(B, S, A, C), hr=f32(B, A, A, 5), hs=f32(B, A, A, 7),
               w2r=f32(5, P * C, scale=0.1), b2r=f32(P * C, scale=0.1),
               w2s=f32(7, P * C, scale=0.1), b2s=f32(P * C, scale=0.1))
    g = f32(B, A, S, C)

    def f(x, hr, hs, w2r, b2r, w2s, b2s):
        return K.conv_tp(_pad(x, (2,)), _pad(jnp.asarray(cgsh), (1, 2)), _pad(hr, (1, 2)),
                         _pad(hs, (1, 2)), w2r, b2r, w2s, b2s, LM, True)[:, :A]

    out, vjp = jax.vjp(jax.jit(f), *ins.values())
    grads = dict(zip(ins, vjp(jnp.asarray(g))))
    return dict(ins=ins, cgsh=cgsh, g=g, out=np.asarray(out),
                grads={k: np.asarray(v) for k, v in grads.items()})


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(1)
    f32 = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    node = f32(B, A, S, C)
    zi = np.einsum("basc,sk->bakc", node, K.cgz_matrix(LM)).astype(np.float32)
    maskf = (rng.random((B, A, A, 1)) < 0.8).astype(np.float32)
    ins = dict(x=np.ascontiguousarray(node.transpose(0, 2, 1, 3)), zi=zi,
               hr=f32(B, A, A, 4), hs=f32(B, A, A, 6), w2r=f32(4, P * C, scale=0.1),
               b2r=f32(P * C, scale=0.1), w2s=f32(6, P * C, scale=0.1),
               b2s=f32(P * C, scale=0.1))
    g = f32(B, A, S, A, C)

    def f(x, zi, hr, hs, w2r, b2r, w2s, b2s):
        return K.pair_tp(_pad(x, (2,)), _pad(zi, (1,)), _pad(jnp.asarray(maskf), (1, 2)),
                         _pad(hr, (1, 2)), _pad(hs, (1, 2)), w2r, b2r, w2s, b2s,
                         LM, True)[:, :A, :, :A]

    out, vjp = jax.vjp(jax.jit(f), *ins.values())
    grads = dict(zip(ins, vjp(jnp.asarray(g))))
    return dict(ins=ins, maskf=maskf, g=g, out=np.asarray(out),
                grads={k: np.asarray(v) for k, v in grads.items()})


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv_args(d):
    i = d["ins"]
    return [_t(i["x"]), _t(d["cgsh"]), _t(i["hr"]), _t(i["hs"]), _t(i["w2r"]), _t(i["b2r"]),
            _t(i["w2s"]), _t(i["b2s"])]


def _pair_args(d):
    i = d["ins"]
    return [_t(i["x"]), _t(i["zi"]), _t(d["maskf"]), _t(i["hr"]), _t(i["hs"]), _t(i["w2r"]),
            _t(i["b2r"]), _t(i["w2s"]), _t(i["b2s"])]


CONV_GRADS = ("x", "hr", "hs", "w2r", "b2r", "w2s", "b2s")
PAIR_GRADS = ("x", "zi", "hr", "hs", "w2r", "b2r", "w2s", "b2s")


def test_conv_forward_matches_jax(conv):
    out = qt.qhnet_conv_fwd(*_conv_args(conv), lmax=LM)
    np.testing.assert_allclose(out.numpy(), conv["out"], **TOL)


@pytest.mark.parametrize("name", CONV_GRADS)
def test_conv_backward_matches_jax(conv, name):
    got = dict(zip(CONV_GRADS, qt.qhnet_conv_bwd(*_conv_args(conv), _t(conv["g"]), lmax=LM)))
    np.testing.assert_allclose(got[name].numpy(), conv["grads"][name], **TOL)


def test_pair_forward_matches_jax(pair):
    out = qt.qhnet_pair_fwd(*_pair_args(pair), lmax=LM)
    np.testing.assert_allclose(out.numpy(), pair["out"], **TOL)


@pytest.mark.parametrize("name", PAIR_GRADS)
def test_pair_backward_matches_jax(pair, name):
    got = dict(zip(PAIR_GRADS, qt.qhnet_pair_bwd(*_pair_args(pair), _t(pair["g"]), lmax=LM)))
    np.testing.assert_allclose(got[name].numpy(), pair["grads"][name], **TOL)


@pytest.mark.parametrize("op", ["conv", "pair"])
def test_autograd_functions_match_jax(conv, pair, op):
    d = conv if op == "conv" else pair
    args = _conv_args(d) if op == "conv" else _pair_args(d)
    names = CONV_GRADS if op == "conv" else PAIR_GRADS
    fixed = {1} if op == "conv" else {2}  # cgsh / maskf: no cotangent
    ins = [a.requires_grad_(i not in fixed) for i, a in enumerate(args)]
    fn = qt.conv_tp if op == "conv" else qt.pair_tp
    out = fn(*ins, lmax=LM)
    np.testing.assert_allclose(out.detach().numpy(), d["out"], **TOL)
    grads = torch.autograd.grad(out, [a for i, a in enumerate(ins) if i not in fixed],
                                _t(d["g"]))
    for name, gr in zip(names, grads):
        np.testing.assert_allclose(gr.numpy(), d["grads"][name], err_msg=name, **TOL)


def test_layouts_match_jax_at_full_lmax():
    assert qt.tp_paths(qt.LMAX) == K.tp_paths(Q.LMAX) == Q._tp_paths(Q.LMAX, Q.LMAX, Q.LMAX)
    assert len(qt.tp_paths()) == 65
    assert qt._cg_layout(qt.LMAX) == K._cg_layout(Q.LMAX)
    assert qt._zi_layout(qt.LMAX) == K._zi_layout(Q.LMAX)
    np.testing.assert_array_equal(qt.cgsh_matrix(qt.LMAX), K.cgsh_matrix(Q.LMAX))
    np.testing.assert_array_equal(qt.cgz_matrix(qt.LMAX), K.cgz_matrix(Q.LMAX))


@pytest.mark.parametrize("kind", ["conv_fwd", "conv_bwd", "pair_fwd", "pair_bwd"])
def test_flop_models_match_jax(kind):
    args = (8, 64, 128, 32, 32)
    assert getattr(qt, f"{kind}_flops")(*args) == getattr(K, f"{kind}_flops")(*args)


def test_wrappers_reject_bad_inputs(conv):
    args = _conv_args(conv)
    with pytest.raises(ValueError, match="lmax"):
        qt.qhnet_conv_fwd(*args, lmax=LM + 1)
    bad = list(args)
    bad[2] = bad[2].double()
    with pytest.raises(ValueError, match="float32"):
        qt.qhnet_conv_fwd(*bad, lmax=LM)


STAGED_REL = 1e-5


def _staged_close(got, want):
    err = float(np.abs(got - want).max())
    assert err <= STAGED_REL * float(np.abs(want).max()), err


@pytest.fixture(scope="module")
def staged(conv, pair):
    return {"conv": dict(zip(CONV_GRADS, qt.conv_bwd_staged(*_conv_args(conv), _t(conv["g"]),
                                                            lmax=LM))),
            "pair": dict(zip(PAIR_GRADS, qt.pair_bwd_staged(*_pair_args(pair), _t(pair["g"]),
                                                            lmax=LM))),
            "pair_3_chunks": dict(zip(PAIR_GRADS, qt.pair_bwd_staged(
                *_pair_args(pair), _t(pair["g"]), lmax=LM, chunks=3)))}


@pytest.fixture(scope="module")
def dead(conv, pair):
    """The fixtures' inputs with receiver 3 of molecule 0 left no live pair
    (its cgsh rows, or its maskf row, zero), through the JAX forward ops."""
    cgsh, maskf = conv["cgsh"].copy(), pair["maskf"].copy()
    cgsh[0, 3] = 0.0
    maskf[0, 3] = 0.0
    ci, pi = conv["ins"], pair["ins"]

    def fc(x, hr, hs, w2r, b2r, w2s, b2s):
        return K.conv_tp(_pad(x, (2,)), _pad(jnp.asarray(cgsh), (1, 2)), _pad(hr, (1, 2)),
                         _pad(hs, (1, 2)), w2r, b2r, w2s, b2s, LM, True)[:, :A]

    def fp(x, zi, hr, hs, w2r, b2r, w2s, b2s):
        return K.pair_tp(_pad(x, (2,)), _pad(zi, (1,)), _pad(jnp.asarray(maskf), (1, 2)),
                         _pad(hr, (1, 2)), _pad(hs, (1, 2)), w2r, b2r, w2s, b2s,
                         LM, True)[:, :A, :, :A]

    return {"conv": dict(conv, cgsh=cgsh, out=np.asarray(jax.jit(fc)(*ci.values()))),
            "pair": dict(pair, maskf=maskf, out=np.asarray(jax.jit(fp)(*pi.values())))}


@pytest.mark.parametrize("case", ["fixture", "dead_receiver"])
@pytest.mark.parametrize("op", ["conv", "pair"])
def test_staged_forward_matches_jax(conv, pair, dead, op, case):
    d = dead[op] if case == "dead_receiver" else {"conv": conv, "pair": pair}[op]
    if op == "conv":
        got = qt.conv_fwd_staged(*_conv_args(d), lmax=LM)
    else:
        got = qt.pair_fwd_staged(*_pair_args(d), lmax=LM)
    assert got.shape == d["out"].shape
    _staged_close(got.numpy(), d["out"])
    if case == "dead_receiver":
        assert float(got[0, 3].abs().max()) == 0.0


@pytest.mark.parametrize("name", CONV_GRADS)
def test_staged_conv_backward_matches_jax(conv, staged, name):
    _staged_close(staged["conv"][name].numpy(), conv["grads"][name])


@pytest.mark.parametrize("name", PAIR_GRADS)
@pytest.mark.parametrize("run", ["pair", "pair_3_chunks"])
def test_staged_pair_backward_matches_jax(pair, staged, run, name):
    _staged_close(staged[run][name].numpy(), pair["grads"][name])


@pytest.mark.parametrize("a", [32, 48, 64])
def test_pair_gx_stage_fills_two_waves(a):
    """L's gx stage at QHNet's buckets (B=8): at least two waves of blocks
    on the 132 SMs."""
    n = 8 * qt.gx_chunks(8, a) * -(-a // qt.GX_SENDERS)
    assert n >= 2 * qt.SMS and qt.gx_chunks(8, a) <= a


@pytest.mark.parametrize("kind", ["I", "J", "K", "L"])
def test_flops_split_adds_up(kind):
    """Gate products and the rest add up to the JAX package's model; the
    products are 1 (forward) or 3 (backward) passes of 2·B·A²·P·C·(H1+H2)."""
    b, a, c, h1, h2 = 8, 48, 128, *((32, 32) if kind in "IJ" else (8, 128))
    total = getattr(K, {"I": "conv_fwd_flops", "J": "conv_bwd_flops", "K": "pair_fwd_flops",
                        "L": "pair_bwd_flops"}[kind])(b, a, c, h1, h2)
    prod, other = qt.flops_split(kind, b, a, c, h1, h2)
    assert prod + other == total and other > 0
    assert prod == (1 if kind in "IK" else 3) * 2 * b * a * a * 65 * c * (h1 + h2)
    meta = functools.partial(torch.empty, device="meta")  # shapes only
    x, hr, hs = meta(b, 25, a, c), meta(b, a, a, h1), meta(b, a, a, h2)
    table = meta(b, a, a, 2304) if kind in "IJ" else meta(b, a, 2304, c)
    work = qt.flops_bytes(kind, x, table, hr, hs, live=b * a * a // 2)
    assert work["flops"] == total and work["flops_live"] == total // 2
    assert abs(work["flops_live_products"] + work["flops_live_other"] - work["flops_live"]) <= 1


def test_live_pairs_count_the_kernels_rows(conv, pair):
    cgsh, maskf = _t(conv["cgsh"]), _t(pair["maskf"])
    assert qt.live_pairs("J", cgsh, LM) == int((np.abs(conv["cgsh"]).sum(-1) > 0).sum())
    assert qt.live_pairs("L", maskf, LM) == int(pair["maskf"].sum())

