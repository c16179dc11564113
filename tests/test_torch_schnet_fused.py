"""The port's fused SchNet cfconv (kernels E and F) against the JAX op.

The plain PyTorch versions of kernel E (`schnet_message_reference`) and
kernel F (`schnet_message_bwd_reference`) are held against the JAX Pallas
op `schnet_message` and its VJP, run in interpret mode on the CPU, on the
same seeded numpy inputs: a Gaussian basis of random distances (not
masked) and a cosine cutoff zero on ~30 % masked pairs, as the model builds
them. `SchNetMessageFn` (the autograd binding) is held against torch
autograd through the plain forward with the basis and envelope chains
attached. Kernel F's card decomposition (`schnet_bwd_staged`: the live
pairs in sender order, the filter-MLP products over them, the per-sender
stage, gz1, g_dist and gW) is held against the same JAX VJP, with and
without gW, on inputs with a sender that has no live receiver, a padded
molecule and a pair live only through envp (at the cutoff's edge, where
envf rounds to zero). Kernel E's card decomposition (`schnet_fwd_staged`: the live pairs in
receiver order, the filter-MLP products over them, the per-receiver stage)
is held against the JAX forward on the same inputs, which hold a receiver
with no live sender. The CUDA kernels are held against the plain versions
on the card in tests/test_torch_cuda.py. Tolerances as in
tests/ops/test_painn_fused.py: 2e-5 forward, 3e-4/3e-5 gradients (float32
sums in another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.ops.pallas.schnet_fused import schnet_message as jax_schnet_message
from nabladft_tpu_torch.ops import schnet_fused as ts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, A, R, F = 4, 9, 12, 16
RC = 5.0
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
E_IN = ("rbf", "envf", "xin", "w1", "b1", "w2", "b2")
F_IN = ("rbf", "rbfp", "envf", "envp", "xin", "w1", "b1", "w2", "b2", "gmsg")
F_OUT = ("g_dist", "gxin", "gw1", "gb1", "gw2", "gb2")
MU = np.linspace(0.0, RC, R).astype(np.float32)
# the data fixture's cases: molecule 0's sender DEAD_SENDER has no live receiver
# and its pair EDGE_PAIR lies at the cutoff's edge (envf 0, envp not); molecule
# PADDED has REAL_ATOMS atoms, the rest padding
DEAD_SENDER, EDGE_PAIR, PADDED, REAL_ATOMS = 3, (0, 1, 2), 2, 6


def basis_torch(dist, mask):
    """(rbf, envf): an unmasked Gaussian basis and a masked cosine cutoff."""
    rbf = torch.exp(-((dist[..., None] - torch.from_numpy(MU)) ** 2))
    env = 0.5 * (torch.cos(math.pi * dist / RC) + 1.0) * (dist < RC) * mask
    return rbf, env


def _chain(dist, mask):
    """(rbf, rbfp, envf, envp) as numpy, the derivatives by torch's jvp."""
    d = torch.from_numpy(dist)
    m = torch.from_numpy(mask)
    (rbf, envf), (rbfp, envp) = torch.func.jvp(lambda x: basis_torch(x, m), (d,),
                                               (torch.ones_like(d),))
    return [t.numpy().astype(np.float32) for t in (rbf, rbfp, envf, envp)]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)

    def mk(*shape):
        return (rng.normal(size=shape) * 0.3).astype(np.float32)

    dist = (np.abs(mk(B, A, A)) * 8 + 0.5).astype(np.float32)  # some beyond the cutoff
    mask = (rng.random((B, A, A)) > 0.3).astype(np.float32)
    mask[1, 5:] = 0.0  # padded receivers: whole rows of dead pairs
    mask[0, :, DEAD_SENDER] = 0.0
    mask[PADDED, REAL_ATOMS:] = mask[PADDED, :, REAL_ATOMS:] = 0.0
    mask[EDGE_PAIR] = 1.0
    dist[EDGE_PAIR] = RC * (1.0 - 2e-5)
    d = dict(dist=dist, mask=mask, xin=mk(B, A, F), w1=mk(R, F), b1=mk(1, F), w2=mk(F, F),
             b2=mk(1, F), gmsg=mk(B, A, F))
    d["rbf"], d["rbfp"], d["envf"], d["envp"] = _chain(dist, mask)
    assert d["envf"][EDGE_PAIR] == 0.0 != d["envp"][EDGE_PAIR]
    return d


@pytest.fixture(scope="module")
def jax_results(data):
    """JAX op forward and VJP in interpret mode, jitted once for the module."""

    @jax.jit
    def run(dist, rbf, rbfp, envf, envp, xin, w1, b1, w2, b2, gmsg):
        out, vjp = jax.vjp(lambda *a: jax_schnet_message(*a, True),
                           dist, rbf, rbfp, envf, envp, xin, w1, b1, w2, b2)
        return out, vjp(gmsg)

    keys = ("dist",) + F_IN
    msg, g = run(*(jnp.asarray(data[k]) for k in keys))
    res = dict(msg=msg, g_dist=g[0], gxin=g[5], gw1=g[6], gb1=g[7], gw2=g[8], gb2=g[9])
    res = {k: np.asarray(v) for k, v in res.items()}
    res["pair_grads"] = [np.asarray(x) for x in g[1:5]]
    return res


def _t(data, *keys):
    return [torch.from_numpy(data[k]) for k in keys]


def test_plain_forward_matches_jax_kernel(data, jax_results):
    msg = ts.schnet_message_reference(*_t(data, *E_IN))
    np.testing.assert_allclose(msg.numpy(), jax_results["msg"], **FWD_TOL)


@pytest.mark.parametrize("name", F_OUT)
def test_plain_backward_matches_jax_vjp(data, jax_results, name):
    out = dict(zip(F_OUT, ts.schnet_message_bwd_reference(*_t(data, *F_IN))))
    np.testing.assert_allclose(out[name].numpy(), jax_results[name], **GRAD_TOL)


def test_jax_vjp_gives_pair_inputs_zeros(jax_results):
    """The contract the port keeps: no cotangent for rbf, rbfp, envf, envp."""
    assert all((g == 0).all() for g in jax_results["pair_grads"])


def test_plain_backward_is_exactly_zero_on_dead_pairs(data):
    g_dist = ts.schnet_message_bwd_reference(*_t(data, *F_IN))[0].numpy()
    dead = (data["envf"] == 0) & (data["envp"] == 0)
    assert dead.any() and (g_dist[dead] == 0).all()


def test_plain_backward_skips_gw_on_request(data):
    out = ts.schnet_message_bwd_reference(*_t(data, *F_IN), need_gw=False)
    assert out[2:] == (None, None, None, None)


def test_autograd_fn_matches_autograd_through_plain_forward(data):
    """SchNetMessageFn on CPU tensors (plain E forward, plain F backward)
    against torch autograd through the plain forward with the basis and
    envelope chains attached: gradients wrt dist, xin and the four weights."""
    dist, mask, xin, w1, b1, w2, b2, gmsg = _t(
        data, "dist", "mask", "xin", "w1", "b1", "w2", "b2", "gmsg")

    def leaves():
        return [x.clone().requires_grad_(True) for x in (dist, xin, w1, b1, w2, b2)]

    a = leaves()
    rbf, rbfp, envf, envp = _t(data, "rbf", "rbfp", "envf", "envp")
    msg = ts.schnet_message(a[0], rbf, rbfp, envf, envp, *a[1:])
    (msg * gmsg).sum().backward()

    r = leaves()
    rbf_r, envf_r = basis_torch(r[0], mask)
    msg_r = ts.schnet_message_reference(rbf_r, envf_r, *r[1:])
    (msg_r * gmsg).sum().backward()

    np.testing.assert_allclose(msg.detach().numpy(), msg_r.detach().numpy(), **FWD_TOL)
    for x, y, name in zip(a, r, ["dist", "xin", "w1", "b1", "w2", "b2"]):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), **GRAD_TOL, err_msg=name)


def test_autograd_fn_skips_gw_for_frozen_weights(data, monkeypatch):
    calls = []
    real = ts.schnet_bwd
    monkeypatch.setattr(ts, "schnet_bwd",
                        lambda *a, **kw: calls.append(kw["need_gw"]) or real(*a, **kw))
    dist, rbf, rbfp, envf, envp, xin, w1, b1, w2, b2 = _t(data, "dist", *F_IN[:-1])
    dist = dist.clone().requires_grad_(True)
    b2 = b2.clone().requires_grad_(True)
    ts.schnet_message(dist, rbf, rbfp, envf, envp, xin, w1, b1, w2, b2).sum().backward()
    assert dist.grad is not None and w1.grad is None and b2.grad is not None
    dist.grad = None
    ts.schnet_message(dist, rbf, rbfp, envf, envp, xin, w1, b1, w2, b2.detach()).sum().backward()
    assert calls == [True, False]


def test_second_derivative_through_the_kernel_op_raises(data):
    scale = torch.tensor(1.5, requires_grad=True)
    dist, rbf, rbfp, envf, envp, xin, w1, b1, w2, b2 = _t(data, "dist", *F_IN[:-1])
    dist.requires_grad_(True)
    msg = ts.schnet_message(dist, rbf, rbfp, envf, envp, xin, w1, b1, w2, b2)
    (g,) = torch.autograd.grad(scale * msg.sum(), dist, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        g.sum().backward()


def test_wrappers_reject_bad_inputs(data):
    x = _t(data, *E_IN)
    with pytest.raises(ValueError, match="dtype"):
        ts.schnet_fwd(x[0].double(), *x[1:])
    with pytest.raises(ValueError, match="envf has shape"):
        ts.schnet_fwd(x[0], x[1][:, :, :-1], *x[2:])
    with pytest.raises(ValueError, match="b1 has shape"):
        ts.schnet_fwd(*x[:4], x[4][0], *x[5:])


def test_wrappers_count_no_cpu_launches(data):
    """The plain CPU path launches no kernel, so it adds to no count."""
    ts.reset_launches()
    ts.schnet_fwd(*_t(data, *E_IN))
    ts.schnet_bwd(*_t(data, *F_IN))
    assert ts.LAUNCHES == dict.fromkeys(ts.LAUNCHES, 0)
    names = {"schnet_fwd", "schnet_bwd", "schnet_bwd_gw", "schnet_dual_fwd", "schnet_dual_bwd"}
    assert set(ts.LAUNCHES) == names | {k + "_bf16" for k in names}


def test_flop_and_byte_counts_follow_live_pairs(data):
    rbf, envf, envp = _t(data, "rbf", "envf", "envp")
    live_e = int((envf != 0).sum())
    live_f = int(((envf != 0) | (envp != 0)).sum())
    flops, nbytes = ts.schnet_fwd_flops_bytes(rbf, envf, F)
    assert flops == (2 * R + 2 * F + 10) * F * live_e
    w = R * F + F * F + 2 * F
    assert nbytes == 4 * (B * A * A * R + B * A * A + 2 * B * A * F + w)
    fb, nb = ts.schnet_bwd_flops_bytes(rbf, envf, envp, F)
    fb0, nb0 = ts.schnet_bwd_flops_bytes(rbf, envf, envp, F, need_gw=False)
    assert fb0 == (4 * R + 4 * F + 20) * F * live_f
    assert fb - fb0 == (2 * R + 2 * F + 7) * F * live_f
    assert nb - nb0 == 4 * w
    # at schnet width (R=100, F=128): 466 FLOPs per channel and live pair for E
    assert ts.pair_flops("fwd", 100, 128) == 466 * 128


# ---------------------------------------------------------------------------
# kernel F's card decomposition (`schnet_bwd_staged`): the live pairs in sender
# order, the filter-MLP products over them, the per-sender stage, gz1, g_dist,
# gW1 | gb1 = rbf_liveᵀ gz1 and gW2 | gb2 = hᵀ gwmr
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("need_gw", [True, False])
@pytest.mark.parametrize("name", F_OUT)
def test_staged_backward_matches_jax_vjp(data, jax_results, name, need_gw):
    out = dict(zip(F_OUT, ts.schnet_bwd_staged(*_t(data, *F_IN), need_gw=need_gw)))
    if name.startswith("g") and name[1] in "wb" and not need_gw:
        assert out[name] is None
        return
    np.testing.assert_allclose(out[name].numpy(), jax_results[name], **GRAD_TOL)


def test_live_pair_list_is_in_sender_order(data):
    """The list covers every pair whose envf or envp is not zero, once, by
    (molecule, sender, receiver), the edge pair included; the dead sender
    and the padding atoms own no row."""
    envf, envp = _t(data, "envf", "envp")
    slots, rows, starts = ts.schnet_live_pairs(envf, envp)
    live = (envf != 0) | (envp != 0)
    assert len(slots) == int(live.sum()) == int(starts[-1])
    assert bool((slots[1:] > slots[:-1]).all())
    b, j, i = slots // (A * A), slots // A % A, slots % A
    assert bool(live[b, i, j].all()) and bool((rows == (b * A + i) * A + j).all())
    m, ei, ej = EDGE_PAIR
    assert bool(((b == m) & (i == ei) & (j == ej)).any())
    assert starts[DEAD_SENDER] == starts[DEAD_SENDER + 1]
    for a in range(REAL_ATOMS, A):
        assert starts[PADDED * A + a] == starts[PADDED * A + a + 1]
        assert not bool(((b == PADDED) & (i == a)).any())


def test_live_pair_list_is_the_engines_list_of_sender_flags(data):
    """schnet_live_pairs is what the card lists: so2_common.cuh's live_rows
    (plain version `so2_live_rows_reference`) over the envelope flags in
    (b, j, i) order, a segment a sender."""
    from nabladft_tpu_torch.ops import eqv2_attn as ea

    envf, envp = _t(data, "envf", "envp")
    slots, _, starts = ts.schnet_live_pairs(envf, envp)
    flags = ((envf != 0) | (envp != 0)).transpose(1, 2).reshape(-1).int()
    eidx, pos, rs, n = ea.so2_live_rows_reference(flags, A)
    assert n == len(slots) and torch.equal(eidx.long(), slots) and torch.equal(rs.long(), starts)
    assert torch.equal(pos[eidx.long()], torch.arange(n, dtype=torch.int32))


def test_staged_backward_writes_zeros_in_dead_slots(data):
    g_dist = ts.schnet_bwd_staged(*_t(data, *F_IN))[0]
    assert bool((g_dist[0, :, DEAD_SENDER] == 0).all())
    assert bool((g_dist[PADDED, REAL_ATOMS:] == 0).all())
    assert bool((g_dist[PADDED, :, REAL_ATOMS:] == 0).all())
    assert g_dist[EDGE_PAIR] != 0


@pytest.mark.parametrize("kind", ["fwd", "bwd", "bwd_gw", "dual_fwd", "dual_bwd", "dual_bwd_gw"])
def test_flop_split_adds_up_to_pair_flops(kind):
    """One table: the products grow with R and F, the rest with F only."""
    for r, f in ((R, F), (100, 128)):
        prod, other = ts.flops_split(kind, r, f)
        assert prod + other == ts.pair_flops(kind, r, f) and other % f == 0
        assert ts.flops_split(kind, 0, f)[1] == other and ts.flops_split(kind, r, 0) == (0, 0)
    # at schnet width, the products are ~96-98 % of the work
    prod, other = ts.flops_split(kind, 100, 128)
    assert 0.95 < prod / (prod + other) < 0.99


@pytest.mark.parametrize("need_gw", [True, False])
def test_bwd_work_splits_the_live_pairs_flops(data, need_gw):
    rbf, envf, envp = _t(data, "rbf", "envf", "envp")
    work = ts.bwd_work("F", rbf, envf, envp, F, need_gw)
    flops, nbytes = ts.schnet_bwd_flops_bytes(rbf, envf, envp, F, need_gw)
    assert work["flops_live"] == flops == work["flops_live_products"] + work["flops_live_other"]
    assert work["bytes"] == nbytes and work["pairs"] == B * A * A
    assert work["live_pairs"] == int(((envf != 0) | (envp != 0)).sum())
    per = (6 * R + 6 * F) if need_gw else (4 * R + 4 * F)
    assert work["flops_live_products"] == per * F * work["live_pairs"]
    fwd = ts.fwd_work("E", rbf, envf, envf, F)
    assert fwd["flops_live"] == ts.schnet_fwd_flops_bytes(rbf, envf, F)[0]
    assert fwd["flops_live_products"] == (2 * R + 2 * F) * F * int((envf != 0).sum())


# ---------------------------------------------------------------------------
# kernel E's card decomposition (`schnet_fwd_staged`): the live pairs in
# receiver order, the filter-MLP products over them, the per-receiver sums in
# list order
# ---------------------------------------------------------------------------

# molecule 1's receivers 5.. have no live sender (their senders' rows are live)
DEAD_RECEIVERS = (1, slice(5, None))


def test_staged_forward_matches_jax_kernel(data, jax_results):
    msg = ts.schnet_fwd_staged(*_t(data, *E_IN))
    np.testing.assert_allclose(msg.numpy(), jax_results["msg"], **FWD_TOL)


def test_staged_forward_gives_zeros_where_a_receiver_has_no_live_sender(data):
    msg = ts.schnet_fwd_staged(*_t(data, *E_IN))
    assert bool((msg[DEAD_RECEIVERS] == 0).all()) and bool((msg[PADDED, REAL_ATOMS:] == 0).all())
    assert bool((msg[1, 4] != 0).any()) and bool((msg[PADDED, REAL_ATOMS - 1] != 0).any())


def test_live_row_list_is_in_receiver_order(data):
    """The list covers every pair row whose envf is not zero, once, by
    (molecule, receiver, sender); the edge pair (envf 0), the dead
    receivers, the dead sender and the padding atoms own no row."""
    (envf,) = _t(data, "envf")
    rows, starts = ts.schnet_live_rows(envf)
    live = (envf != 0).reshape(-1)
    assert len(rows) == int(live.sum()) == int(starts[-1])
    assert bool((rows[1:] > rows[:-1]).all()) and bool(live[rows].all())
    m, i, j = EDGE_PAIR
    assert not bool((rows == (m * A + i) * A + j).any())
    for r in range(5, A):
        assert starts[A + r] == starts[A + r + 1]
    b, j = rows // (A * A), rows % A
    assert not bool(((b == 0) & (j == DEAD_SENDER)).any())
    for a in range(REAL_ATOMS, A):
        assert starts[PADDED * A + a] == starts[PADDED * A + a + 1]
        assert not bool(((b == PADDED) & (j == a)).any())


def test_live_row_list_is_the_engines_list_of_row_flags(data):
    """schnet_live_rows is what the card lists: so2_common.cuh's live_rows
    (plain version `so2_live_rows_reference`) over the envelope flags in
    pair-row order, a segment a receiver."""
    from nabladft_tpu_torch.ops import eqv2_attn as ea

    envf, envp = _t(data, "envf", "envp")
    for env2 in (None, envp):
        rows, starts = ts.schnet_live_rows(envf, env2)
        live = envf != 0 if env2 is None else (envf != 0) | (env2 != 0)
        eidx, pos, rs, n = ea.so2_live_rows_reference(live.reshape(-1).int(), A)
        assert n == len(rows) and torch.equal(eidx.long(), rows) and torch.equal(rs.long(), starts)
        assert torch.equal(pos[eidx.long()], torch.arange(n, dtype=torch.int32))


def test_fwd_work_splits_the_live_pairs_flops(data):
    rbf, envf = _t(data, "rbf", "envf")
    work = ts.fwd_work("E", rbf, envf, envf, F)
    flops, nbytes = ts.schnet_fwd_flops_bytes(rbf, envf, F)
    assert work["flops_live"] == flops == work["flops_live_products"] + work["flops_live_other"]
    assert work["bytes"] == nbytes and work["live_pairs"] == len(ts.schnet_live_rows(envf)[0])
    assert work["flops_live_products"] == (2 * R + 2 * F) * F * work["live_pairs"]
    assert work["flops_live_other"] == 10 * F * work["live_pairs"]
