"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test needs a CUDA card and nvcc and skips without a card. The file
imports no JAX, so it also runs on a machine without it (tests/conftest.py
imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Shapes cover the edges the kernels handle: atom counts that are not a
multiple of the 16-row blocks, channel counts that leave a partial
128-lane chunk, and basis sizes that are not a multiple of 4. Tolerance:
max |kernel - plain| <= 2e-5 x max |plain| per output (fp32 sums in
another order), as in chip_smoke.py.
"""

import pytest
import torch

from nabladft_tpu_torch.ops import painn_fused as pf

SHAPES = [(4, 8, 12, 16), (3, 10, 13, 160), (2, 33, 100, 128), (1, 62, 100, 128)]
REL = 2e-5


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dev, seed=0):
    b, a, r, f = shape
    g = torch.Generator().manual_seed(seed)

    def mk(*s):
        return torch.randn(*s, generator=g) * 0.3

    dist = mk(b, a, a).abs() * 5 + 0.8
    mask = (torch.rand(b, a, a, generator=g) > 0.3).float()
    mu = torch.linspace(0.0, 5.0, r)
    rbf = torch.exp(-((dist[..., None] - mu) ** 2) / 0.05) * mask[..., None]
    rbfp = (-2.0 / 0.05) * (dist[..., None] - mu) * rbf
    x = dict(dist=dist, rbf=rbf, rbfp=rbfp, phi=mk(b, a, 3 * f), v=mk(b, a, 3 * f),
             unit_t=mk(b, a, 3, a), w=mk(r, 3 * f), gds=mk(b, a, f), gdv=mk(b, a, 3 * f))
    return {k: t.to(dev) for k, t in x.items()}


def _assert_close(got, ref):
    for i, (x, y) in enumerate(zip(got, ref)):
        err = float((x - y).abs().max())
        assert err <= REL * float(y.abs().max()) + 1e-30, (i, err)


A_ARGS = ("rbf", "phi", "v", "unit_t", "w")
B_ARGS = ("rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_fwd_kernel_matches_plain(card, shape):
    x = _inputs(shape, card)
    args = [x[k] for k in A_ARGS]
    pf.reset_launches()
    got = pf.painn_fwd(*args)
    torch.cuda.synchronize()
    assert pf.LAUNCHES["painn_fwd"] == 1
    _assert_close(got, pf.painn_message_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("need_gw", [True, False])
def test_bwd_kernel_matches_plain(card, shape, need_gw):
    x = _inputs(shape, card)
    args = [x[k] for k in B_ARGS]
    got = pf.painn_bwd(*args, need_gw=need_gw)
    torch.cuda.synchronize()
    ref = pf.painn_message_bwd_reference(*args, need_gw=need_gw)
    if not need_gw:
        assert got[4] is None and ref[4] is None
        got, ref = got[:4], ref[:4]
    _assert_close(got, ref)


@pytest.mark.cuda
def test_bwd_kernel_is_deterministic(card):
    x = _inputs(SHAPES[2], card)
    args = [x[k] for k in B_ARGS]
    first, second = pf.painn_bwd(*args), pf.painn_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_autograd_fn_on_card_matches_cpu(card):
    """PaiNNMessageFn's gradients on the card (kernels A and B) against the
    same op on CPU tensors (the plain versions)."""
    x = _inputs(SHAPES[1], card)

    def grads(dev):
        leaves = {k: x[k].to(dev).clone().requires_grad_(True)
                  for k in ("dist", "phi", "v", "unit_t", "w")}
        ds, dv = pf.painn_message(leaves["dist"], x["rbf"].to(dev), x["rbfp"].to(dev),
                                  leaves["phi"], leaves["v"], leaves["unit_t"], leaves["w"])
        ((ds * x["gds"].to(dev)).sum() + (dv * x["gdv"].to(dev)).sum()).backward()
        return [leaves[k].grad.cpu() for k in ("dist", "phi", "v", "unit_t", "w")]

    _assert_close(grads(card), grads(torch.device("cpu")))


@pytest.mark.cuda
def test_wrappers_raise_on_bad_card_inputs(card):
    x = _inputs(SHAPES[0], card)
    args = [x[k] for k in A_ARGS]
    with pytest.raises(ValueError, match="contiguous"):
        pf.painn_fwd(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="on cpu"):
        pf.painn_fwd(args[0], args[1].cpu(), *args[2:])


@pytest.mark.cuda
def test_fused_painn_on_card_matches_cpu_plain(card):
    from nabladft_tpu_torch.data.synthetic import random_molecule
    from nabladft_tpu_torch.data.batch import MolBatch
    from nabladft_tpu_torch.models import create_model, forward
    from nabladft_tpu_torch.train import seeded_generator

    import numpy as np

    rng = np.random.default_rng(0)
    b, a = 4, 20
    z = np.zeros((b, a), np.int32)
    pos = np.zeros((b, a, 3), np.float32)
    mask = np.zeros((b, a), bool)
    for i, n in enumerate([20, 13, 7, 17]):
        zi, pi = random_molecule(rng, n)
        z[i, :n], pos[i, :n], mask[i, :n] = zi, pi, True
    batch = MolBatch(z=torch.from_numpy(z), pos=torch.from_numpy(pos),
                     node_mask=torch.from_numpy(mask), graph_mask=torch.ones(b, dtype=torch.bool),
                     energy=torch.zeros(b), forces=torch.zeros(b, a, 3),
                     mol_id=torch.arange(b, dtype=torch.int32))
    kw = dict(hidden=32, n_interactions=2, n_rbf=20, max_neighbors=9)
    gpu = create_model("painn", device=card, generator=seeded_generator(1), use_pallas="fused",
                       **kw)
    cpu = create_model("painn", device="cpu", generator=seeded_generator(1), **kw)
    out_g = forward(gpu, batch.to(card))
    out_c = forward(cpu, batch)
    torch.testing.assert_close(out_g["energy"].cpu(), out_c["energy"], rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(out_g["forces"].cpu(), out_c["forces"], rtol=2e-3, atol=2e-4)
