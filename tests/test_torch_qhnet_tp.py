"""The plain versions of QHNet's kernels I-L and their autograd Functions
against the JAX package's `conv_tp` / `pair_tp` (Pallas in interpret mode).

As tests/ops/test_qhnet_tp.py runs them: LM=2 (14 paths), B=2, A=11, C=8,
atoms padded to a multiple of 8 on the JAX side only (the port's kernels
mask their own ragged edge). Forward values and every cotangent the
contracts define (gx, gzi, ghr, ghs, gW2r, gb2r, gW2s, gb2s) within rtol
2e-5 / atol 2e-5 (that file's tolerance for fp32 sums in another order).
The path layouts and FLOP models equal the JAX ones at LMAX=4.
"""

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
