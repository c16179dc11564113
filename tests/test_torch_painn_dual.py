"""The port's dual-number PaiNN message (kernels C and D) against the JAX op.

The plain PyTorch versions of kernel C (`painn_dual_fwd_reference`) and
kernel D (`painn_dual_bwd_reference`), and the card's decompositions of
both (`painn_dual_fwd_staged`, `painn_dual_bwd_staged`), are held against
the JAX Pallas op `painn_dual` and its VJP, run in interpret mode on the
CPU, on the same seeded numpy inputs; `PaiNNDualFn` (the autograd binding) is held against
torch autograd through the plain forward, and the plain forward against
torch's forward AD of kernel A's plain version. The CUDA kernels are held
against the plain versions on the card in tests/test_torch_cuda.py.
Tolerances as in tests/ops/test_painn_fused.py: 2e-5 forward, 3e-4/3e-5
gradients (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.ops.pallas.painn_fused import painn_dual as jax_painn_dual
from nabladft_tpu_torch.ops import painn_fused as tp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, A, R, F = 3, 8, 12, 16
F3 = 3 * F
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
C_IN = ("rbf", "rbfd", "phi", "phid", "v", "vd", "unit_t", "unitd_t", "w")
COTS = ("gds", "gdv", "gdsd", "gdvd")
D_OUT = ("gphi", "gphid", "gv", "gvd", "gw")
DEAD_SENDER, PADDED, REAL_ATOMS = 2, 2, 5
DEAD_RECEIVER = 4  # of molecule 0
EDGE = (0, 1, 3)  # (b, i, j): a pair live through rbfd alone
C_OUT = ("ds", "dv", "dsd", "dvd")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)

    def mk(*shape):
        return (rng.normal(size=shape) * 0.3).astype(np.float32)

    mask = (rng.random((B, A, A)) > 0.3).astype(np.float32)
    mask[1, :, DEAD_SENDER] = 0.0  # a sender with no live receiver (mask[b, i, j], j sends)
    mask[PADDED, REAL_ATOMS:] = mask[PADDED, :, REAL_ATOMS:] = 0.0  # a molecule with padding
    mask[0, DEAD_RECEIVER] = 0.0  # a real receiver with no live sender
    mask[EDGE] = 1.0
    d = dict(rbf=mk(B, A, A, R) * mask[..., None], rbfd=mk(B, A, A, R) * mask[..., None],
             phi=mk(B, A, F3), phid=mk(B, A, F3), v=mk(B, A, F3), vd=mk(B, A, F3),
             unit_t=mk(B, A, 3, A), unitd_t=mk(B, A, 3, A), w=mk(R, F3),
             gds=mk(B, A, F), gdv=mk(B, A, F3), gdsd=mk(B, A, F), gdvd=mk(B, A, F3))
    # at the cutoff's edge the envelope rounds to 0 but its derivative does not
    d["rbf"][EDGE] = 0.0
    return d


@pytest.fixture(scope="module")
def jax_results(data):
    """JAX painn_dual forward and VJP in interpret mode, jitted once."""

    @jax.jit
    def run(*args):
        ins, cots = args[:9], args[9:]
        out, vjp = jax.vjp(lambda *a: jax_painn_dual(*a, True), *ins)
        return out, vjp(tuple(cots))

    out, grads = run(*(jnp.asarray(data[k]) for k in C_IN + COTS))
    res = dict(zip(("ds", "dv", "dsd", "dvd"), (np.asarray(x) for x in out)))
    g = dict(zip(C_IN, grads))
    res.update(gphi=g["phi"], gphid=g["phid"], gv=g["v"], gvd=g["vd"], gw=g["w"])
    res["pair_grads"] = [np.asarray(g[k]) for k in ("rbf", "rbfd", "unit_t", "unitd_t")]
    return {k: (np.asarray(v) if k != "pair_grads" else v) for k, v in res.items()}


def _t(data, *keys):
    return [torch.from_numpy(data[k]) for k in keys]


@pytest.mark.parametrize("name", ["ds", "dv", "dsd", "dvd"])
def test_plain_dual_forward_matches_jax(data, jax_results, name):
    out = dict(zip(("ds", "dv", "dsd", "dvd"), tp.painn_dual_fwd_reference(*_t(data, *C_IN))))
    np.testing.assert_allclose(out[name].numpy(), jax_results[name], **FWD_TOL)


@pytest.mark.parametrize("name", D_OUT)
def test_plain_dual_backward_matches_jax_vjp(data, jax_results, name):
    out = dict(zip(D_OUT, tp.painn_dual_bwd_reference(*_t(data, *C_IN + COTS))))
    np.testing.assert_allclose(out[name].numpy(), jax_results[name], **GRAD_TOL)


def test_jax_vjp_gives_pair_inputs_zeros(jax_results):
    """The contract the port keeps: no cotangent for rbf, rbfd, unit_t, unitd_t."""
    assert all((g == 0).all() for g in jax_results["pair_grads"])


def test_plain_dual_forward_is_the_jvp_of_the_plain_message(data):
    rbf, rbfd, phi, phid, v, vd, ut, utd, w = _t(data, *C_IN)
    (ds, dv), (dsd, dvd) = torch.func.jvp(
        lambda *x: tp.painn_message_reference(*x, w), (rbf, phi, v, ut), (rbfd, phid, vd, utd))
    got = tp.painn_dual_fwd_reference(rbf, rbfd, phi, phid, v, vd, ut, utd, w)
    for x, y in zip(got, (ds, dv, dsd, dvd)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **FWD_TOL)


def test_dual_fn_matches_autograd_through_plain_forward(data):
    """PaiNNDualFn on CPU tensors (plain C forward, plain D backward) against
    torch autograd through the plain C forward: node and weight gradients,
    none for the pair-level inputs."""
    x = _t(data, *C_IN)
    cots = _t(data, *COTS)
    diff = (2, 3, 4, 5, 8)  # phi, phid, v, vd, w

    def run(fn):
        leaves = [t.clone().requires_grad_(i in diff) for i, t in enumerate(x)]
        out = fn(*leaves)
        sum((o * c).sum() for o, c in zip(out, cots)).backward()
        return out, [leaves[i].grad for i in diff], [leaves[i].grad for i in (0, 1, 6, 7)]

    out, grads, pair = run(tp.painn_dual)
    out_r, grads_r, _ = run(tp.painn_dual_fwd_reference)
    for o, r in zip(out, out_r):
        np.testing.assert_allclose(o.detach().numpy(), r.detach().numpy(), **FWD_TOL)
    for g, r, name in zip(grads, grads_r, ["phi", "phid", "v", "vd", "w"]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **GRAD_TOL, err_msg=name)
    assert all(g is None for g in pair)


def test_dual_fn_skips_gw_for_fixed_weights(data):
    x = [t.clone() for t in _t(data, *C_IN)]
    x[2].requires_grad_(True)
    out = tp.painn_dual(*x)
    sum(o.sum() for o in out).backward()
    assert x[2].grad is not None and x[8].grad is None


def test_second_derivatives_through_the_kernel_ops_raise(data):
    """Neither VJP is differentiable: kernels B and D return results with no
    graph on the card, so a double backward must raise on every device
    rather than silently drop the second-order terms. The cotangents depend
    on a weight here, as they do in a force loss."""
    scale = torch.tensor(1.5, requires_grad=True)
    dist = torch.rand(B, A, A) + 0.5
    rbf, rbfp, phi, v, ut, w = _t(data, "rbf", "rbfd", "phi", "v", "unit_t", "w")
    dist.requires_grad_(True)
    ds, dv = tp.painn_message(dist, rbf, rbfp, phi, v, ut, w)
    (g,) = torch.autograd.grad(scale * (ds.sum() + dv.sum()), dist, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        g.sum().backward()

    x = [t.clone() for t in _t(data, *C_IN)]
    x[2].requires_grad_(True)
    out = tp.painn_dual(*x)
    (g,) = torch.autograd.grad(scale * sum(o.sum() for o in out), x[2], create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        g.sum().backward()


def test_dual_wrappers_count_no_cpu_launches(data):
    tp.reset_launches()
    tp.painn_dual_fwd(*_t(data, *C_IN))
    tp.painn_dual_bwd(*_t(data, *C_IN + COTS))
    assert tp.LAUNCHES == dict.fromkeys(tp.LAUNCHES, 0)


def test_dual_wrappers_reject_bad_inputs(data):
    x = _t(data, *C_IN)
    with pytest.raises(ValueError, match="rbfd has shape"):
        tp.painn_dual_fwd(x[0], x[1][:, :, :-1], *x[2:])
    with pytest.raises(ValueError, match="dtype"):
        tp.painn_dual_fwd(*x[:3], x[3].double(), *x[4:])


def test_dual_flop_and_byte_counts(data):
    rbf, rbfd = _t(data, "rbf", "rbfd")
    live = int(((rbf != 0).any(-1) | (rbfd != 0).any(-1)).sum())
    flops, nbytes = tp.painn_dual_fwd_flops_bytes(rbf, rbfd, F)
    assert flops == (12 * R + 50) * F * live
    assert nbytes == 4 * (2 * B * A * A * R + 4 * B * A * F3 + 2 * B * A * 3 * A + R * F3
                          + 2 * (B * A * F + B * A * F3))
    fb, nb = tp.painn_dual_bwd_flops_bytes(rbf, rbfd, F)
    fb0, nb0 = tp.painn_dual_bwd_flops_bytes(rbf, rbfd, F, need_gw=False)
    assert fb0 == (12 * R + 46) * F * live
    assert fb - fb0 == (12 * R + 44) * F * live
    assert nb - nb0 == 4 * R * F3


# ---------------------------------------------------------------------------
# kernel D's card decomposition (`painn_dual_bwd_staged`)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("need_gw", [True, False])
@pytest.mark.parametrize("name", D_OUT)
def test_staged_dual_backward_matches_jax_vjp(data, jax_results, name, need_gw):
    out = dict(zip(D_OUT, tp.painn_dual_bwd_staged(*_t(data, *C_IN + COTS), need_gw=need_gw)))
    if name == "gw" and not need_gw:
        assert out["gw"] is None
        return
    np.testing.assert_allclose(out[name].numpy(), jax_results[name], **GRAD_TOL)


def test_dual_live_pairs_skip_the_dead_sender_and_padding(data):
    rbf, rbfd = _t(data, "rbf", "rbfd")
    slots, _, starts = tp.painn_live_pairs(rbf, rbfd)
    assert len(slots) == int(((rbf != 0).any(-1) | (rbfd != 0).any(-1)).sum())
    assert starts[1 * A + DEAD_SENDER] == starts[1 * A + DEAD_SENDER + 1]
    assert all(starts[PADDED * A + a] == starts[PADDED * A + a + 1] for a in range(REAL_ATOMS, A))


@pytest.mark.parametrize("need_gw", [True, False])
def test_dual_bwd_work_splits_the_live_pairs_flops(data, need_gw):
    rbf, rbfd = _t(data, "rbf", "rbfd")
    work = tp.bwd_work("D", rbf, rbfd, F, need_gw)
    flops, nbytes = tp.painn_dual_bwd_flops_bytes(rbf, rbfd, F, need_gw)
    assert work["flops_live"] == flops == work["flops_live_products"] + work["flops_live_other"]
    assert work["bytes"] == nbytes
    assert work["flops_live_products"] == (24 if need_gw else 12) * R * F * work["live_pairs"]


# ---------------------------------------------------------------------------
# kernel C's card decomposition (`painn_dual_fwd_staged`): the live pairs in
# receiver order (rbf or rbfd row not zero), wm and wmd over them, the
# per-receiver sums in list order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", C_OUT)
def test_staged_dual_forward_matches_jax(data, jax_results, name):
    out = dict(zip(C_OUT, tp.painn_dual_fwd_staged(*_t(data, *C_IN))))
    np.testing.assert_allclose(out[name].numpy(), jax_results[name], **FWD_TOL)


def test_dual_live_rows_keep_the_pair_live_through_rbfd_alone(data):
    """The rbfd-only pair is listed and adds its wmd terms: without it the
    receiver's tangent lanes differ."""
    rbf, rbfd = _t(data, "rbf", "rbfd")
    b, i, j = EDGE
    row = (b * A + i) * A + j
    assert not bool((rbf.reshape(-1, R)[row] != 0).any())
    rows, starts = tp.painn_live_rows(rbf, rbfd)
    assert row in set(rows.tolist()) and row not in set(tp.painn_live_rows(rbf)[0].tolist())
    assert len(rows) == int(((rbf != 0).any(-1) | (rbfd != 0).any(-1)).sum()) == int(starts[-1])
    x = _t(data, *C_IN)
    x[1] = x[1].clone()
    x[1][EDGE] = 0.0
    full, cut = tp.painn_dual_fwd_staged(*_t(data, *C_IN)), tp.painn_dual_fwd_staged(*x)
    assert torch.equal(full[0], cut[0]) and torch.equal(full[1], cut[1])
    assert not torch.equal(full[2][b, i], cut[2][b, i])


def test_staged_dual_forward_gives_zeros_where_a_receiver_has_no_live_sender(data):
    rbf, rbfd = _t(data, "rbf", "rbfd")
    _, starts = tp.painn_live_rows(rbf, rbfd)
    assert starts[DEAD_RECEIVER] == starts[DEAD_RECEIVER + 1]
    for out in tp.painn_dual_fwd_staged(*_t(data, *C_IN)):
        assert bool((out[0, DEAD_RECEIVER] == 0).all())
        assert bool((out[PADDED, REAL_ATOMS:] == 0).all())


def test_dual_live_rows_are_the_engines_list_of_row_flags(data):
    from nabladft_tpu_torch.ops import eqv2_attn as ea

    rbf, rbfd = _t(data, "rbf", "rbfd")
    rows, starts = tp.painn_live_rows(rbf, rbfd)
    flags = ((rbf != 0).any(-1) | (rbfd != 0).any(-1)).reshape(-1).int()
    eidx, _, rs, n = ea.so2_live_rows_reference(flags, A)
    assert n == len(rows) and torch.equal(eidx.long(), rows) and torch.equal(rs.long(), starts)


def test_dual_fwd_work_splits_the_live_pairs_flops(data):
    rbf, rbfd = _t(data, "rbf", "rbfd")
    work = tp.fwd_work("C", rbf, rbfd, F)
    flops, nbytes = tp.painn_dual_fwd_flops_bytes(rbf, rbfd, F)
    assert work["flops_live"] == flops == work["flops_live_products"] + work["flops_live_other"]
    assert work["bytes"] == nbytes and work["live_pairs"] == len(tp.painn_live_rows(rbf, rbfd)[0])
    assert work["flops_live_products"] == 12 * R * F * work["live_pairs"]
