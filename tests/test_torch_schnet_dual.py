"""The port's dual-number SchNet cfconv (kernels G and H) against the JAX op.

The plain PyTorch versions of kernel G (`schnet_dual_fwd_reference`) and
kernel H (`schnet_dual_bwd_reference`) are held against the JAX Pallas op
`schnet_dual` and its VJP, run in interpret mode on the CPU, on the same
seeded numpy inputs (tangent lanes rbfd = rbfp ⊙ ṫ and envfd = envp ⊙ ṫ,
zero on masked pairs, as the model builds them); `SchNetDualFn` is held
against torch autograd through the plain forward, and the plain forward
against torch's forward AD of kernel E's plain version. Kernel H's card
decomposition (`schnet_dual_bwd_staged`) is held against the same JAX VJP,
with and without gW, on inputs with a sender that has no live receiver, a
padded molecule and a pair live only through envfd (at the cutoff's edge,
where envf rounds to zero). Kernel G's card decomposition
(`schnet_dual_fwd_staged`: the live pairs in receiver order, envf or envfd
not zero) is held against the JAX forward, the envfd-only pair and a
receiver with no live sender included. The CUDA kernels are held against
the plain versions on the card in tests/test_torch_cuda.py. Tolerances: 2e-5 forward,
3e-4/3e-5 gradients.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.ops.pallas.schnet_fused import schnet_dual as jax_schnet_dual
from nabladft_tpu_torch.ops import schnet_fused as ts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, A, R, F = 3, 8, 12, 16
RC = 5.0
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
G_IN = ("rbf", "rbfd", "envf", "envfd", "xin", "xind", "w1", "b1", "w2", "b2")
COTS = ("gmsg", "gmsgd")
H_OUT = ("gxin", "gxind", "gw1", "gb1", "gw2", "gb2")
MU = np.linspace(0.0, RC, R).astype(np.float32)
# the data fixture's cases, as in tests/test_torch_schnet_fused.py (EDGE_PAIR:
# envf 0, envfd not)
DEAD_SENDER, EDGE_PAIR, PADDED, REAL_ATOMS = 2, (1, 3, 4), 2, 5


def _chain(dist, mask):
    """(rbf, rbfp, envf, envp): an unmasked Gaussian basis, a masked cosine
    cutoff and their derivatives in dist (torch's jvp), as numpy."""
    m = torch.from_numpy(mask)

    def basis(d):
        rbf = torch.exp(-((d[..., None] - torch.from_numpy(MU)) ** 2))
        return rbf, 0.5 * (torch.cos(math.pi * d / RC) + 1.0) * (d < RC) * m

    d = torch.from_numpy(dist)
    (rbf, envf), (rbfp, envp) = torch.func.jvp(basis, (d,), (torch.ones_like(d),))
    return [t.numpy().astype(np.float32) for t in (rbf, rbfp, envf, envp)]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)

    def mk(*shape):
        return (rng.normal(size=shape) * 0.3).astype(np.float32)

    dist = (np.abs(mk(B, A, A)) * 8 + 0.5).astype(np.float32)
    mask = (rng.random((B, A, A)) > 0.3).astype(np.float32)
    mask[0, :, DEAD_SENDER] = 0.0
    mask[PADDED, REAL_ATOMS:] = mask[PADDED, :, REAL_ATOMS:] = 0.0
    mask[EDGE_PAIR] = 1.0
    dist[EDGE_PAIR] = RC * (1.0 - 2e-5)
    rbf, rbfp, envf, envp = _chain(dist, mask)
    dt = mk(B, A, A) * mask
    dt[EDGE_PAIR] = 0.7
    d = dict(rbf=rbf, rbfd=rbfp * dt[..., None], envf=envf, envfd=envp * dt,
             xin=mk(B, A, F), xind=mk(B, A, F), w1=mk(R, F), b1=mk(1, F), w2=mk(F, F),
             b2=mk(1, F), gmsg=mk(B, A, F), gmsgd=mk(B, A, F))
    assert d["envf"][EDGE_PAIR] == 0.0 != d["envfd"][EDGE_PAIR]
    return d


@pytest.fixture(scope="module")
def jax_results(data):
    """JAX schnet_dual forward and VJP in interpret mode, jitted once."""

    @jax.jit
    def run(*args):
        ins, cots = args[:10], args[10:]
        out, vjp = jax.vjp(lambda *a: jax_schnet_dual(*a, True), *ins)
        return out, vjp(tuple(cots))

    (msg, msgd), g = run(*(jnp.asarray(data[k]) for k in G_IN + COTS))
    res = dict(msg=msg, msgd=msgd, **dict(zip(H_OUT, g[4:])))
    res = {k: np.asarray(v) for k, v in res.items()}
    res["pair_grads"] = [np.asarray(x) for x in g[:4]]
    return res


def _t(data, *keys):
    return [torch.from_numpy(data[k]) for k in keys]


@pytest.mark.parametrize("name", ["msg", "msgd"])
def test_plain_dual_forward_matches_jax(data, jax_results, name):
    out = dict(zip(("msg", "msgd"), ts.schnet_dual_fwd_reference(*_t(data, *G_IN))))
    np.testing.assert_allclose(out[name].numpy(), jax_results[name], **FWD_TOL)


@pytest.mark.parametrize("name", H_OUT)
def test_plain_dual_backward_matches_jax_vjp(data, jax_results, name):
    out = dict(zip(H_OUT, ts.schnet_dual_bwd_reference(*_t(data, *G_IN + COTS))))
    np.testing.assert_allclose(out[name].numpy(), jax_results[name], **GRAD_TOL)


def test_jax_vjp_gives_pair_inputs_zeros(jax_results):
    """The contract the port keeps: no cotangent for rbf, rbfd, envf, envfd."""
    assert all((g == 0).all() for g in jax_results["pair_grads"])


def test_plain_dual_forward_is_the_jvp_of_the_plain_message(data):
    rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2 = _t(data, *G_IN)
    msg, msgd = torch.func.jvp(
        lambda r, e, x: ts.schnet_message_reference(r, e, x, w1, b1, w2, b2),
        (rbf, envf, xin), (rbfd, envfd, xind))
    got = ts.schnet_dual_fwd_reference(*_t(data, *G_IN))
    for x, y in zip(got, (msg, msgd)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **FWD_TOL)


def test_dual_fn_matches_autograd_through_plain_forward(data):
    """SchNetDualFn on CPU tensors (plain G forward, plain H backward)
    against torch autograd through the plain G forward: node and weight
    gradients, none for the pair-level inputs."""
    x = _t(data, *G_IN)
    cots = _t(data, *COTS)
    diff = (4, 5, 6, 7, 8, 9)  # xin, xind, w1, b1, w2, b2

    def run(fn):
        leaves = [t.clone().requires_grad_(i in diff) for i, t in enumerate(x)]
        out = fn(*leaves)
        sum((o * c).sum() for o, c in zip(out, cots)).backward()
        return out, [leaves[i].grad for i in diff], [leaves[i].grad for i in range(4)]

    out, grads, pair = run(ts.schnet_dual)
    out_r, grads_r, _ = run(ts.schnet_dual_fwd_reference)
    for o, r in zip(out, out_r):
        np.testing.assert_allclose(o.detach().numpy(), r.detach().numpy(), **FWD_TOL)
    for g, r, name in zip(grads, grads_r, ["xin", "xind", "w1", "b1", "w2", "b2"]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **GRAD_TOL, err_msg=name)
    assert all(g is None for g in pair)


def test_dual_fn_skips_gw_for_fixed_weights(data):
    x = [t.clone() for t in _t(data, *G_IN)]
    x[4].requires_grad_(True)
    out = ts.schnet_dual(*x)
    sum(o.sum() for o in out).backward()
    assert x[4].grad is not None and all(t.grad is None for t in x[6:])


def test_second_derivative_through_the_dual_op_raises(data):
    scale = torch.tensor(1.5, requires_grad=True)
    x = [t.clone() for t in _t(data, *G_IN)]
    x[4].requires_grad_(True)
    out = ts.schnet_dual(*x)
    (g,) = torch.autograd.grad(scale * sum(o.sum() for o in out), x[4], create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        g.sum().backward()


def test_dual_wrappers_count_no_cpu_launches(data):
    ts.reset_launches()
    ts.schnet_dual_fwd(*_t(data, *G_IN))
    ts.schnet_dual_bwd(*_t(data, *G_IN + COTS))
    assert ts.LAUNCHES == dict.fromkeys(ts.LAUNCHES, 0)


def test_dual_wrappers_reject_bad_inputs(data):
    x = _t(data, *G_IN)
    with pytest.raises(ValueError, match="rbfd has shape"):
        ts.schnet_dual_fwd(x[0], x[1][:, :, :-1], *x[2:])
    with pytest.raises(ValueError, match="dtype"):
        ts.schnet_dual_fwd(*x[:5], x[5].double(), *x[6:])


def test_dual_flop_and_byte_counts(data):
    rbf, envf, envfd = _t(data, "rbf", "envf", "envfd")
    live = int(((envf != 0) | (envfd != 0)).sum())
    w = R * F + F * F + 2 * F
    flops, nbytes = ts.schnet_dual_fwd_flops_bytes(rbf, envf, envfd, F)
    assert flops == (4 * R + 4 * F + 20) * F * live
    assert nbytes == 4 * (2 * B * A * A * R + 2 * B * A * A + 4 * B * A * F + w)
    fb, nb = ts.schnet_dual_bwd_flops_bytes(rbf, envf, envfd, F)
    fb0, nb0 = ts.schnet_dual_bwd_flops_bytes(rbf, envf, envfd, F, need_gw=False)
    assert fb0 == (4 * R + 4 * F + 20) * F * live
    assert fb - fb0 == (4 * R + 8 * F + 27) * F * live
    assert nb - nb0 == 4 * w


# ---------------------------------------------------------------------------
# kernel H's card decomposition (`schnet_dual_bwd_staged`)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("need_gw", [True, False])
@pytest.mark.parametrize("name", H_OUT)
def test_staged_dual_backward_matches_jax_vjp(data, jax_results, name, need_gw):
    out = dict(zip(H_OUT, ts.schnet_dual_bwd_staged(*_t(data, *G_IN + COTS), need_gw=need_gw)))
    if name not in ("gxin", "gxind") and not need_gw:
        assert out[name] is None
        return
    np.testing.assert_allclose(out[name].numpy(), jax_results[name], **GRAD_TOL)


def test_staged_dual_backward_lists_the_envfd_only_pair(data):
    """The edge pair (envf 0, envfd not) is live for H, and it moves gxin:
    without it the staged backward (and the plain one) would differ."""
    envf, envfd = _t(data, "envf", "envfd")
    slots, _, starts = ts.schnet_live_pairs(envf, envfd)
    m, i, j = EDGE_PAIR
    assert int(((slots // (A * A) == m) & (slots // A % A == j) & (slots % A == i)).sum()) == 1
    assert starts[DEAD_SENDER] == starts[DEAD_SENDER + 1]
    args = _t(data, *G_IN + COTS)
    cut = [t.clone() for t in args]
    cut[1][EDGE_PAIR] = 0.0
    cut[3][EDGE_PAIR] = 0.0
    assert not torch.equal(ts.schnet_dual_bwd_staged(*args)[0], ts.schnet_dual_bwd_staged(*cut)[0])


@pytest.mark.parametrize("need_gw", [True, False])
def test_dual_bwd_work_splits_the_live_pairs_flops(data, need_gw):
    rbf, envf, envfd = _t(data, "rbf", "envf", "envfd")
    work = ts.bwd_work("H", rbf, envf, envfd, F, need_gw)
    flops, nbytes = ts.schnet_dual_bwd_flops_bytes(rbf, envf, envfd, F, need_gw)
    assert work["flops_live"] == flops == work["flops_live_products"] + work["flops_live_other"]
    assert work["bytes"] == nbytes and work["pairs"] == B * A * A
    per = (8 * R + 12 * F) if need_gw else (4 * R + 4 * F)
    assert work["flops_live_products"] == per * F * work["live_pairs"]
    fwd = ts.fwd_work("G", rbf, envf, envfd, F)
    assert fwd["flops_live"] == ts.schnet_dual_fwd_flops_bytes(rbf, envf, envfd, F)[0]
    assert fwd["live_pairs"] == work["live_pairs"]


# ---------------------------------------------------------------------------
# kernel G's card decomposition (`schnet_dual_fwd_staged`): the live pairs in
# receiver order (envf or envfd not zero), the per-receiver sums
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["msg", "msgd"])
def test_staged_dual_forward_matches_jax(data, jax_results, name):
    out = dict(zip(("msg", "msgd"), ts.schnet_dual_fwd_staged(*_t(data, *G_IN))))
    np.testing.assert_allclose(out[name].numpy(), jax_results[name], **FWD_TOL)


def test_staged_dual_forward_lists_the_envfd_only_pair(data):
    """The edge pair (envf 0, envfd not) is in G's list and not in E's, and
    it moves msgd of its receiver only (the rest within the tolerance: the
    products over one row fewer sum in another order). Its envfd is raised
    to 0.5 here so that its term stands out of that tolerance."""
    envf, envfd = _t(data, "envf", "envfd")
    m, i, j = EDGE_PAIR
    row = (m * A + i) * A + j
    assert int((ts.schnet_live_rows(envf, envfd)[0] == row).sum()) == 1
    assert not bool((ts.schnet_live_rows(envf)[0] == row).any())
    args = [t.clone() for t in _t(data, *G_IN)]
    args[3][EDGE_PAIR] = 0.5
    cut = [t.clone() for t in args]
    cut[1][EDGE_PAIR] = 0.0
    cut[3][EDGE_PAIR] = 0.0
    (msg, msgd), (msg_c, msgd_c) = ts.schnet_dual_fwd_staged(*args), ts.schnet_dual_fwd_staged(*cut)
    assert float((msgd[m, i] - msgd_c[m, i]).abs().max()) > 1e-3
    msgd_c[m, i] = msgd[m, i]
    for x, y in ((msg, msg_c), (msgd, msgd_c)):
        np.testing.assert_allclose(y.numpy(), x.numpy(), **FWD_TOL)


def test_staged_dual_forward_gives_zeros_where_a_receiver_has_no_live_sender(data):
    """Receiver 1 of molecule 0 cut off in both lanes, and the padded
    molecule's padding atoms: zero rows, and the rest as the plain version."""
    args = [t.clone() for t in _t(data, *G_IN)]
    for k in (2, 3):  # envf, envfd
        args[k][0, 1] = 0.0
    got = ts.schnet_dual_fwd_staged(*args)
    for out, ref in zip(got, ts.schnet_dual_fwd_reference(*args)):
        assert bool((out[0, 1] == 0).all()) and bool((out[PADDED, REAL_ATOMS:] == 0).all())
        assert bool((out[0, 2] != 0).any())
        np.testing.assert_allclose(out.numpy(), ref.numpy(), **FWD_TOL)


def test_dual_fwd_work_splits_the_live_pairs_flops(data):
    rbf, envf, envfd = _t(data, "rbf", "envf", "envfd")
    work = ts.fwd_work("G", rbf, envf, envfd, F)
    flops, nbytes = ts.schnet_dual_fwd_flops_bytes(rbf, envf, envfd, F)
    assert work["flops_live"] == flops == work["flops_live_products"] + work["flops_live_other"]
    assert work["bytes"] == nbytes
    assert work["live_pairs"] == len(ts.schnet_live_rows(envf, envfd)[0])
    assert work["live_pairs"] == len(ts.schnet_live_rows(envf)[0]) + 1  # the edge pair
    assert work["flops_live_products"] == (4 * R + 4 * F) * F * work["live_pairs"]
    assert work["flops_live_other"] == 20 * F * work["live_pairs"]
