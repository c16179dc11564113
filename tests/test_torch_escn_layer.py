"""The plain versions of eSCN's kernels M and N, and `ESCNMessageFn`, against
the JAX package's fused eSCN message layer.

* At escn-oc's l_max 6, m_max 2 (S 49, S_t 29, K 235, the 7 x 5 truncated
  grid from grid_points 98) and small widths (C 8, H 16, EC 8; B 2, A 6,
  about a third of the pairs masked): plain M against `jax.vmap` of the
  per-receiver `_message_pipeline`, and plain N against `jax.vjp` of it and
  against the hand-written `_pipeline_bwd` (gx + gxi summed, as the port
  takes one x); `ESCNMessageFn`'s autograd on the CPU gives plain N's
  values, and d no gradient. Tolerance: 1e-5 x the output's largest
  magnitude (fp32 sums in another order).
* Once, at l_max 2, m_max 1 (as tests/ops/test_escn_layer.py runs the
  kernel): the port's op against `escn_message` itself, the Pallas kernels
  in interpret mode, forward and VJP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.ops.pallas import escn_layer as JK
from nabladft_tpu_torch.ops import escn_layer as el
from nabladft_tpu_torch.ops import so3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


L, M, C, H, EC, B, A = 6, 2, 8, 16, 8, 2, 6
NG = 2 * (L + 1) ** 2
REL = 1e-5
# XLA CPU compile options of the JAX references compiled as one program
XLA_FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
NAMES = ["x", "xe", "wg", "bg", "w1_0", "w2_0"] + [
    f"{w}_m{m}" for m in range(1, M + 1) for w in ("fc1", "w2r", "w2i")]


def _inputs(rng, l_max, m_max, c, h, ec, b, a):
    s = (l_max + 1) ** 2
    k = so3.trunc_compact_layout(l_max, m_max)[1]
    mask = rng.random((b, a, a)) < 0.65
    f32 = lambda *shape, scale=1.0: (rng.normal(size=shape) * scale).astype(np.float32)  # noqa: E731
    return dict(x=f32(b, a, s, c), d=f32(b, a, a, k) * mask[..., None], xe=f32(b, a, a, ec),
                ws=[f32(*shape, scale=0.3) for shape in el.weight_shapes(l_max, m_max, c, h, ec)],
                g=f32(b, a, s, c))


def _mlists(ws, m_max):
    return ([ws[4 + 3 * m] for m in range(m_max)], [ws[5 + 3 * m] for m in range(m_max)],
            [ws[6 + 3 * m] for m in range(m_max)])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def ref():
    """JAX's per-receiver pipeline vmapped over (b, i): values and VJP."""
    inp = _inputs(np.random.default_rng(0), L, M, C, H, EC, B, A)
    kw = dict(l_max=L, m_max=M, c=C, h=H, n_grid=NG)

    def per_receiver(x_sm, xi, d, xe, ws):
        return JK._message_pipeline(x_sm, xi, d, xe, *ws[:4], *_mlists(ws, M), **kw)

    def layer(x, xe, *ws):
        one = jax.vmap(per_receiver, in_axes=(None, 0, 0, 0, None))
        return jax.vmap(one, in_axes=(0, 0, 0, 0, None))(jnp.swapaxes(x, 1, 2), x,
                                                        jnp.asarray(inp["d"]), xe, ws)

    def layer_and_vjp(x, xe, ws, g):
        out, vjp = jax.vjp(layer, x, xe, *ws)
        return out, vjp(g)

    # one program, compiled without XLA's backend optimisations: faster here
    # than running the vmapped pipeline and its transpose op by op
    args = (inp["x"], inp["xe"], inp["ws"], jnp.asarray(inp["g"]))
    out, grads = jax.jit(layer_and_vjp).lower(*args).compile(compiler_options=XLA_FAST)(*args)
    grads = [np.asarray(g) for g in grads]

    def manual(x, xe, ws, g):
        def one(xi, d, xe_i, g_i):
            return JK._pipeline_bwd(jnp.swapaxes(x, 0, 1), xi, d, xe_i, *ws[:4],
                                    *_mlists(ws, M), g_i, **kw)
        return jax.vmap(one)(x, jnp.asarray(inp["d"][0]), xe, g)

    # _pipeline_bwd per receiver of molecule 0: (gx [A,S,C] as a sender sum, gxi, gxe, ...)
    man = manual(inp["x"][0], inp["xe"][0], inp["ws"], inp["g"][0])
    gx0 = np.asarray(man[0]).sum(axis=0).transpose(1, 0, 2) + np.asarray(man[1])
    manual_grads = dict(x=gx0, xe=np.asarray(man[2]))
    return dict(inp=inp, out=np.asarray(out), grads=dict(zip(NAMES, grads)), manual=manual_grads)


def _args(inp):
    return [_t(inp["x"]), _t(inp["d"]), _t(inp["xe"]), *map(_t, inp["ws"])]


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def test_plain_m_matches_jax(ref):
    _close(el.escn_fwd(*_args(ref["inp"]), l_max=L, m_max=M, n_grid=NG), ref["out"])


@pytest.fixture(scope="module")
def plain_n(ref):
    got = el.escn_bwd(*_args(ref["inp"]), g=_t(ref["inp"]["g"]), l_max=L, m_max=M, n_grid=NG)
    return dict(zip(NAMES, got))


@pytest.mark.parametrize("name", NAMES)
def test_plain_n_matches_jax_vjp(ref, plain_n, name):
    _close(plain_n[name], ref["grads"][name])


@pytest.mark.parametrize("name", ["x", "xe"])
def test_plain_n_matches_the_hand_written_backward(ref, plain_n, name):
    _close(plain_n[name][0], ref["manual"][name])


def test_autograd_function_gives_plain_n(ref, plain_n):
    args = [t.requires_grad_(True) for t in _args(ref["inp"])]
    out = el.escn_message(*args, l_max=L, m_max=M, n_grid=NG)
    _close(out, ref["out"])
    out.backward(_t(ref["inp"]["g"]))
    assert args[1].grad is None
    for name, t in zip(NAMES, [args[0], *args[2:]]):
        torch.testing.assert_close(t.grad, plain_n[name], rtol=0, atol=0)


def test_wrapper_checks_shapes_on_the_cpu(ref):
    args = _args(ref["inp"])
    with pytest.raises(ValueError, match="shape"):
        el.escn_fwd(args[0], args[1][..., :-1], *args[2:], l_max=L, m_max=M, n_grid=NG)
    with pytest.raises(ValueError, match="weight arrays"):
        el.escn_fwd(*args[:-1], l_max=L, m_max=M, n_grid=NG)
    with pytest.raises(ValueError, match="dtype"):
        el.escn_fwd(args[0].double(), *args[1:], l_max=L, m_max=M, n_grid=NG)


def test_matches_escn_message_in_interpret_mode():
    l_max, m_max, c, h, ec, b, a = 2, 1, 8, 16, 8, 2, 8
    n_grid = 2 * (l_max + 1) ** 2
    inp = _inputs(np.random.default_rng(1), l_max, m_max, c, h, ec, b, a)
    k = inp["d"].shape[-1]
    d_pad = np.pad(inp["d"], [(0, 0)] * 3 + [(0, 128 - k)])  # JAX pads K to the lanes

    def f(x, xe, *ws):
        return JK.escn_message(l_max, m_max, n_grid, True, False, jnp.swapaxes(x, 1, 2), x,
                               jnp.asarray(d_pad), xe, *ws[:4], *_mlists(ws, m_max))

    out, vjp = jax.vjp(f, inp["x"], inp["xe"], *inp["ws"])
    want = [np.asarray(t) for t in vjp(jnp.asarray(inp["g"]))]
    args = [_t(inp["x"]), _t(inp["d"]), _t(inp["xe"]), *map(_t, inp["ws"])]
    _close(el.escn_fwd(*args, l_max=l_max, m_max=m_max, n_grid=n_grid), np.asarray(out))
    got = el.escn_bwd(*args, g=_t(inp["g"]), l_max=l_max, m_max=m_max, n_grid=n_grid)
    for g, w in zip(got, want):
        _close(g, w)
