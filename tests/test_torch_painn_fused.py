"""The port's fused PaiNN message (kernels A and B) against the JAX op.

The plain PyTorch versions of kernel A (`painn_message_reference`) and
kernel B (`painn_message_bwd_reference`), and the card's decompositions of
both (`painn_fwd_staged`, `painn_bwd_staged`), are held against the JAX
Pallas kernels run in interpret mode on the CPU, on the same seeded numpy
inputs;
`PaiNNMessageFn` (the autograd binding) is held against torch autograd
through the plain forward. The CUDA kernels themselves are held against the
plain versions on the card in tests/test_torch_cuda.py.
Tolerances as in tests/ops/test_painn_fused.py: 2e-5 forward, 3e-4/3e-5
gradients (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.ops.pallas.painn_fused import painn_message as jax_painn_message
from nabladft_tpu_torch.ops import painn_fused as tp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, A, R, F = 4, 8, 12, 16
F3 = 3 * F
DEAD_SENDER, PADDED, REAL_ATOMS = 5, 3, 5
DEAD_RECEIVER = 2  # of molecule 0
B_OUT = ["g_dist", "g_unit_t", "gphi", "gv", "gw"]
B_IN = ("rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv")
A_OUT = ["ds", "dv"]
A_IN = ("rbf", "phi", "v", "unit_t", "w")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return (rng.normal(size=shape) * 0.3).astype(np.float32)

    dist = np.abs(mk(B, A, A)) + 0.5
    mask = (rng.random((B, A, A)) > 0.3).astype(np.float32)
    mask[1, :, DEAD_SENDER] = 0.0  # a sender with no live receiver (mask[b, i, j], j sends)
    mask[PADDED, REAL_ATOMS:] = mask[PADDED, :, REAL_ATOMS:] = 0.0  # a molecule with padding
    mask[0, DEAD_RECEIVER] = 0.0  # a real receiver with no live sender
    phi, v, unit_t, w = mk(B, A, F3), mk(B, A, F3), mk(B, A, 3, A), mk(R, F3)
    gds, gdv = mk(B, A, F), mk(B, A, F3)
    return dict(dist=dist, mask=mask, phi=phi, v=v, unit_t=unit_t, w=w, gds=gds, gdv=gdv)


MU = np.linspace(0.5, 3.0, R).astype(np.float32)


def basis_np(dist, mask):
    """A stand-in radial chain f(dist)·mask and its derivative (closed form)."""
    g = np.exp(-((dist[..., None] - MU) ** 2)) * mask[..., None]
    return g.astype(np.float32), (-2.0 * (dist[..., None] - MU) * g).astype(np.float32)


def basis_torch(dist, mask):
    return torch.exp(-((dist[..., None] - torch.from_numpy(MU)) ** 2)) * mask[..., None]


@pytest.fixture(scope="module")
def data():
    d = _inputs()
    d["rbf"], d["rbfp"] = basis_np(d["dist"], d["mask"])
    return d


@pytest.fixture(scope="module")
def jax_results(data):
    """JAX op forward and VJP in interpret mode, jitted once for the module."""
    d = data

    @jax.jit
    def run(dist, rbf, rbfp, phi, v, unit_t, w, gds, gdv):
        out, vjp = jax.vjp(
            lambda *a: jax_painn_message(*a, True), dist, rbf, rbfp, phi, v, unit_t, w
        )
        return out, vjp((gds, gdv))

    keys = ("dist", "rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv")
    (ds, dv), grads = run(*(jnp.asarray(d[k]) for k in keys))
    g_dist, _, _, gphi, gv, g_ut, gw = grads
    return {k: np.asarray(x) for k, x in dict(
        ds=ds, dv=dv, g_dist=g_dist, gphi=gphi, gv=gv, g_unit_t=g_ut, gw=gw).items()}


def _t(data, *keys):
    return [torch.from_numpy(data[k]) for k in keys]


def test_plain_forward_matches_jax_kernel(data, jax_results):
    ds, dv = tp.painn_message_reference(*_t(data, "rbf", "phi", "v", "unit_t", "w"))
    np.testing.assert_allclose(ds.numpy(), jax_results["ds"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dv.numpy(), jax_results["dv"], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["g_dist", "g_unit_t", "gphi", "gv", "gw"])
def test_plain_backward_matches_jax_vjp(data, jax_results, name):
    out = tp.painn_message_bwd_reference(
        *_t(data, "rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv"))
    got = dict(zip(["g_dist", "g_unit_t", "gphi", "gv", "gw"], out))[name]
    np.testing.assert_allclose(got.numpy(), jax_results[name], rtol=3e-4, atol=3e-5)


def test_plain_backward_skips_gw_on_request(data):
    out = tp.painn_message_bwd_reference(
        *_t(data, "rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv"), need_gw=False)
    assert out[4] is None


def test_autograd_fn_matches_autograd_through_plain_forward(data):
    """PaiNNMessageFn on CPU tensors (plain A forward, plain B backward)
    against torch autograd through the plain forward with the basis chain
    attached: gradients wrt dist, phi, v, unit_t and w."""
    dist, mask, phi, v, unit_t, w, gds, gdv = _t(
        data, "dist", "mask", "phi", "v", "unit_t", "w", "gds", "gdv")

    def leaves():
        return [x.clone().requires_grad_(True) for x in (dist, phi, v, unit_t, w)]

    a = leaves()
    with torch.no_grad():
        rbf = basis_torch(a[0], mask)
        rbfp = torch.func.jvp(lambda d: basis_torch(d, mask), (dist,), (torch.ones_like(dist),))[1]
    ds, dv = tp.painn_message(a[0], rbf, rbfp, *a[1:])
    ((ds * gds).sum() + (dv * gdv).sum()).backward()

    r = leaves()
    ds_r, dv_r = tp.painn_message_reference(basis_torch(r[0], mask), *r[1:])
    ((ds_r * gds).sum() + (dv_r * gdv).sum()).backward()

    np.testing.assert_allclose(ds.detach().numpy(), ds_r.detach().numpy(), rtol=2e-5, atol=2e-5)
    for x, y, name in zip(a, r, ["dist", "phi", "v", "unit_t", "w"]):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=3e-4, atol=3e-5,
                                   err_msg=name)


def test_autograd_fn_skips_gw_for_frozen_weights(data):
    dist, rbf, rbfp, phi, v, unit_t, w = _t(
        data, "dist", "rbf", "rbfp", "phi", "v", "unit_t", "w")
    dist = dist.clone().requires_grad_(True)
    ds, dv = tp.painn_message(dist, rbf, rbfp, phi, v, unit_t, w)
    (ds.sum() + dv.sum()).backward()
    assert dist.grad is not None and w.grad is None


def test_wrappers_reject_bad_inputs(data):
    rbf, phi, v, unit_t, w = _t(data, "rbf", "phi", "v", "unit_t", "w")
    with pytest.raises(ValueError, match="dtype"):
        tp.painn_fwd(rbf.double(), phi, v, unit_t, w)
    with pytest.raises(ValueError, match="shape"):
        tp.painn_fwd(rbf[:, :, :-1], phi, v, unit_t, w)
    with pytest.raises(ValueError, match="3F"):
        tp.painn_fwd(rbf, phi, v, unit_t, w[:, :-1])


def test_wrappers_count_no_cpu_launches(data):
    """The plain CPU path launches no kernel, so it adds to no count."""
    tp.reset_launches()
    tp.painn_fwd(*_t(data, "rbf", "phi", "v", "unit_t", "w"))
    tp.painn_bwd(*_t(data, "rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv"))
    assert tp.LAUNCHES == dict.fromkeys(tp.LAUNCHES, 0)
    assert {"painn_fwd", "painn_bwd", "painn_bwd_gw"} <= set(tp.LAUNCHES)


def test_flop_and_byte_counts_follow_live_pairs(data):
    rbf, rbfp = _t(data, "rbf", "rbfp")
    live = int((rbf != 0).any(dim=-1).sum())
    flops, nbytes = tp.painn_fwd_flops_bytes(rbf, F)
    assert flops == (6 * R + 16) * F * live
    assert nbytes == 4 * (B * A * A * R + 2 * B * A * F3 + B * A * 3 * A + R * F3
                          + B * A * F + B * A * F3)
    # B works on the pairs whose rbf or rbfp row is not zero
    live_b = int(((rbf != 0).any(dim=-1) | (rbfp != 0).any(dim=-1)).sum())
    fb, _ = tp.painn_bwd_flops_bytes(rbf, rbfp, F)
    fb_nogw, _ = tp.painn_bwd_flops_bytes(rbf, rbfp, F, need_gw=False)
    assert fb_nogw == (12 * R + 49) * F * live_b
    assert fb - fb_nogw == (6 * R + 13) * F * live_b
    # at painn-oc width (R=100): 616 FLOPs per channel and live pair for A
    assert tp.pair_flops("fwd", 100, 128) == 616 * 128


# ---------------------------------------------------------------------------
# kernel B's card decomposition (`painn_bwd_staged`): the live pairs in sender
# order, the radial products over them, the per-pair stage, gW = rbf_liveᵀ gwm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("need_gw", [True, False])
@pytest.mark.parametrize("name", B_OUT)
def test_staged_backward_matches_jax_vjp(data, jax_results, name, need_gw):
    out = dict(zip(B_OUT, tp.painn_bwd_staged(*_t(data, *B_IN), need_gw=need_gw)))
    if name == "gw" and not need_gw:
        assert out["gw"] is None
        return
    np.testing.assert_allclose(out[name].numpy(), jax_results[name], rtol=3e-4, atol=3e-5)


def test_live_pair_list_is_in_sender_order(data):
    """The list covers every pair whose rbf or rbfp row is not zero, once,
    by (molecule, sender, receiver); the dead sender and the padding atoms
    own no row."""
    rbf, rbfp = _t(data, "rbf", "rbfp")
    slots, rows, starts = tp.painn_live_pairs(rbf, rbfp)
    live = (rbf != 0).any(-1) | (rbfp != 0).any(-1)
    assert len(slots) == int(live.sum()) == int(starts[-1])
    assert bool((slots[1:] > slots[:-1]).all())
    b, j, i = slots // (A * A), slots // A % A, slots % A
    assert bool(live[b, i, j].all()) and bool((rows == (b * A + i) * A + j).all())
    assert starts[1 * A + DEAD_SENDER] == starts[1 * A + DEAD_SENDER + 1]
    for a in range(REAL_ATOMS, A):
        assert starts[PADDED * A + a] == starts[PADDED * A + a + 1]
        assert not bool(((b == PADDED) & (i == a)).any())


def test_live_pair_list_is_the_engines_list_of_sender_flags(data):
    """painn_live_pairs is what the card lists: so2_common.cuh's live_rows
    (plain version `so2_live_rows_reference`) over the flags in (b, j, i)
    order, a segment a sender."""
    from nabladft_tpu_torch.ops import eqv2_attn as ea

    rbf, rbfp = _t(data, "rbf", "rbfp")
    slots, _, starts = tp.painn_live_pairs(rbf, rbfp)
    live = (rbf != 0).any(-1) | (rbfp != 0).any(-1)  # [B, A(i), A(j)]
    flags = live.transpose(1, 2).reshape(-1).int()
    eidx, pos, rs, n = ea.so2_live_rows_reference(flags, A)
    assert n == len(slots) and torch.equal(eidx.long(), slots) and torch.equal(rs.long(), starts)
    assert torch.equal(pos[eidx.long()], torch.arange(n, dtype=torch.int32))


def test_staged_backward_writes_zeros_in_dead_slots(data):
    g_dist, g_ut = tp.painn_bwd_staged(*_t(data, *B_IN))[:2]
    assert bool((g_dist[1, :, DEAD_SENDER] == 0).all())
    assert bool((g_ut[PADDED, REAL_ATOMS:] == 0).all())


@pytest.mark.parametrize("kind", ["fwd", "bwd", "bwd_gw", "dual_fwd", "dual_bwd", "dual_bwd_gw"])
def test_flop_split_adds_up_to_pair_flops(kind):
    """The products are exactly the part of pair_flops that grows with R."""
    for r, f in ((R, F), (100, 128)):
        prod, other = tp.flops_split(kind, r, f)
        assert prod + other == tp.pair_flops(kind, r, f) and prod % r == 0
        assert other == tp.pair_flops(kind, 0, f) > 0


@pytest.mark.parametrize("need_gw", [True, False])
def test_bwd_work_splits_the_live_pairs_flops(data, need_gw):
    rbf, rbfp = _t(data, "rbf", "rbfp")
    work = tp.bwd_work("B", rbf, rbfp, F, need_gw)
    flops, nbytes = tp.painn_bwd_flops_bytes(rbf, rbfp, F, need_gw)
    assert work["flops_live"] == flops == work["flops_live_products"] + work["flops_live_other"]
    assert work["bytes"] == nbytes and work["pairs"] == B * A * A
    assert work["flops_live_products"] == (18 if need_gw else 12) * R * F * work["live_pairs"]


# ---------------------------------------------------------------------------
# kernel A's card decomposition (`painn_fwd_staged`): the live pairs in
# receiver order, wm = rbf W over them, the per-receiver sums in list order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", A_OUT)
def test_staged_forward_matches_jax_kernel(data, jax_results, name):
    out = dict(zip(A_OUT, tp.painn_fwd_staged(*_t(data, *A_IN))))
    np.testing.assert_allclose(out[name].numpy(), jax_results[name], rtol=2e-5, atol=2e-5)


def test_staged_forward_gives_zeros_where_a_receiver_has_no_live_sender(data):
    for out in tp.painn_fwd_staged(*_t(data, *A_IN)):
        assert bool((out[0, DEAD_RECEIVER] == 0).all())
        assert bool((out[PADDED, REAL_ATOMS:] == 0).all())
        assert bool((out[0, DEAD_RECEIVER + 1] != 0).any())


def test_live_row_list_is_in_receiver_order(data):
    """The list covers every pair row whose rbf row is not zero, once, by
    (molecule, receiver, sender); the dead receiver, the dead sender and the
    padding atoms own no row."""
    (rbf,) = _t(data, "rbf")
    rows, starts = tp.painn_live_rows(rbf)
    live = (rbf != 0).any(-1).reshape(-1)
    assert len(rows) == int(live.sum()) == int(starts[-1])
    assert bool((rows[1:] > rows[:-1]).all()) and bool(live[rows].all())
    assert starts[DEAD_RECEIVER] == starts[DEAD_RECEIVER + 1]
    b, j = rows // (A * A), rows % A
    assert not bool(((b == 1) & (j == DEAD_SENDER)).any())
    for a in range(REAL_ATOMS, A):
        assert starts[PADDED * A + a] == starts[PADDED * A + a + 1]
        assert not bool(((b == PADDED) & (j == a)).any())


def test_live_row_list_is_the_engines_list_of_row_flags(data):
    """painn_live_rows is what the card lists: so2_common.cuh's live_rows
    (plain version `so2_live_rows_reference`) over the flags in pair-row
    order, a segment a receiver."""
    from nabladft_tpu_torch.ops import eqv2_attn as ea

    (rbf,) = _t(data, "rbf")
    rows, starts = tp.painn_live_rows(rbf)
    flags = (rbf != 0).any(-1).reshape(-1).int()
    eidx, pos, rs, n = ea.so2_live_rows_reference(flags, A)
    assert n == len(rows) and torch.equal(eidx.long(), rows) and torch.equal(rs.long(), starts)
    assert torch.equal(pos[eidx.long()], torch.arange(n, dtype=torch.int32))


def test_fwd_work_splits_the_live_pairs_flops(data):
    (rbf,) = _t(data, "rbf")
    work = tp.fwd_work("A", rbf, rbf, F)
    flops, nbytes = tp.painn_fwd_flops_bytes(rbf, F)
    assert work["flops_live"] == flops == work["flops_live_products"] + work["flops_live_other"]
    assert work["bytes"] == nbytes and work["live_pairs"] == len(tp.painn_live_rows(rbf)[0])
    assert work["flops_live_products"] == 6 * R * F * work["live_pairs"]
