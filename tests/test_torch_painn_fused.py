"""The port's fused PaiNN message (kernels A and B) against the JAX op.

The plain PyTorch versions of kernel A (`painn_message_reference`) and
kernel B (`painn_message_bwd_reference`) are held against the JAX Pallas
kernels run in interpret mode on the CPU, on the same seeded numpy inputs;
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

B, A, R, F = 4, 8, 12, 16
F3 = 3 * F


def _inputs(seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return (rng.normal(size=shape) * 0.3).astype(np.float32)

    dist = np.abs(mk(B, A, A)) + 0.5
    mask = (rng.random((B, A, A)) > 0.3).astype(np.float32)
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
    assert tp.LAUNCHES == {"painn_fwd": 0, "painn_bwd": 0}


def test_flop_and_byte_counts_follow_live_pairs(data):
    rbf = torch.from_numpy(data["rbf"])
    live = int((rbf != 0).any(dim=-1).sum())
    flops, nbytes = tp.painn_fwd_flops_bytes(rbf, F)
    assert flops == (6 * R + 16) * F * live
    assert nbytes == 4 * (B * A * A * R + 2 * B * A * F3 + B * A * 3 * A + R * F3
                          + B * A * F + B * A * F3)
    fb, _ = tp.painn_bwd_flops_bytes(rbf, F)
    fb_nogw, _ = tp.painn_bwd_flops_bytes(rbf, F, need_gw=False)
    assert fb_nogw == (12 * R + 49) * F * live
    assert fb - fb_nogw == (6 * R + 13) * F * live + (B - 1) * R * F3
    # at painn-oc width (R=100): 616 FLOPs per channel and live pair for A
    assert tp.pair_flops("fwd", 100, 128) == 616 * 128
