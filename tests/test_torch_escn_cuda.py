"""eSCN's CUDA kernels M and N against their plain PyTorch versions on the
card, and the fused eSCN against the plain one.

Every test needs a CUDA card and nvcc and skips without a card. The file
imports no JAX (tests/conftest.py does, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_escn_cuda.py

Inputs come from chip_smoke.escn_kernel_inputs at the widths of
configs/escn-oc.yaml (l_max 6, m_max 2, C 128, H 256, EC 128; d from the
8 Å / 40-neighbour graph, padded atoms), at the bucket shapes A = 32/48/64
with two molecules (the plain version's memory), and at a width that leaves
partial 128-row and 128-column tiles. Tolerance: max |kernel - plain| <=
2e-5 x max |plain| per output (fp32 sums in another order), as in
chip_smoke.py.
"""

import sys
from pathlib import Path

import pytest
import torch

from nabladft_tpu_torch.ops import escn_layer as el

REPO = Path(__file__).resolve().parent.parent
REL = 2e-5
# (B, A, overrides of the escn-oc widths)
SHAPES = [(1, 11, dict(sphere_channels=40, hidden=24, edge_channels=16)),
          (2, 32, {}), (2, 48, {}), (2, 64, {})]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture()
def smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def _close(got, ref):
    for i, (x, y) in enumerate(zip(got, ref)):
        assert x.shape == y.shape, i
        err = float((x - y).abs().max())
        assert err <= REL * float(y.abs().max()) + 1e-30, (i, err, float(y.abs().max()))


def _inputs(smoke, card, shape):
    b, a, kw = shape
    return smoke.escn_kernel_inputs(card, b, a, seed=a, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"B{s[0]}A{s[1]}")
def test_forward_matches_plain(card, smoke, shape):
    x = _inputs(smoke, card, shape)
    args = (x["x"], x["d"], x["xe"], *x["ws"])
    el.reset_launches()
    got = el.escn_fwd(*args, **x["dims"])
    torch.cuda.synchronize()
    assert el.LAUNCHES == {"escn_fwd": 1, "escn_bwd": 0, "escn_fwd_bf16": 0,
                           "escn_bwd_bf16": 0}
    _close([got], [el.escn_fwd_reference(*args, **x["dims"])])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"B{s[0]}A{s[1]}")
def test_backward_matches_plain_and_repeats_its_bits(card, smoke, shape):
    x = _inputs(smoke, card, shape)
    args = (x["x"], x["d"], x["xe"], *x["ws"])
    el.reset_launches()
    got = el.escn_bwd(*args, g=x["g"], **x["dims"])
    again = el.escn_bwd(*args, g=x["g"], **x["dims"])
    torch.cuda.synchronize()
    assert el.LAUNCHES == {"escn_fwd": 0, "escn_bwd": 2, "escn_fwd_bf16": 0,
                           "escn_bwd_bf16": 0}
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    _close(got, el.escn_bwd_reference(*args, g=x["g"], **x["dims"]))


@pytest.mark.cuda
def test_padding_and_masked_pairs_give_exact_zeros(card, smoke):
    x = _inputs(smoke, card, (2, 48, {}))
    args = (x["x"], x["d"], x["xe"], *x["ws"])
    out = el.escn_fwd(*args, **x["dims"])
    gx, gxe, *_ = el.escn_bwd(*args, g=x["g"], **x["dims"])
    pad, dead = ~x["node_mask"], ~x["pair_mask"]
    assert bool(pad.any()) and bool(dead.any())
    assert float(out[pad].abs().max()) == 0.0
    assert float(gx[pad].abs().max()) == 0.0
    assert float(gxe[dead].abs().max()) == 0.0
    assert float(gxe[x["pair_mask"]].abs().max()) > 0.0


@pytest.mark.cuda
def test_bad_inputs_raise(card, smoke):
    x = _inputs(smoke, card, (1, 11, dict(sphere_channels=40, hidden=24, edge_channels=16)))
    args = [x["x"], x["d"], x["xe"], *x["ws"]]
    with pytest.raises(ValueError, match="dtype"):
        el.escn_fwd(args[0].double(), *args[1:], **x["dims"])
    with pytest.raises(ValueError, match="shape"):
        el.escn_fwd(args[0], args[1][..., :-1].contiguous(), *args[2:], **x["dims"])
    with pytest.raises(ValueError, match="contiguous"):
        el.escn_fwd(args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:],
                    **x["dims"])
    with pytest.raises(ValueError, match="is on"):
        el.escn_fwd(args[0].cpu(), *args[1:], **x["dims"])
    small = smoke.escn_kernel_inputs(card, 1, 6, l_max=3, sphere_channels=8, hidden=8,
                                     edge_channels=8)
    with pytest.raises(ValueError, match="l_max=6"):
        el.escn_fwd(small["x"], small["d"], small["xe"], *small["ws"], **small["dims"])
    odd = smoke.escn_kernel_inputs(card, 1, 6, sphere_channels=12, hidden=8, edge_channels=8)
    with pytest.raises(ValueError, match="multiples of 8"):
        el.escn_fwd(odd["x"], odd["d"], odd["xe"], *odd["ws"], **odd["dims"])


@pytest.mark.cuda
def test_fused_model_matches_plain_model(card):
    from nabladft_tpu_torch.data.batch import MolBatch
    from nabladft_tpu_torch.models import create_model
    from nabladft_tpu_torch.train import seeded_generator
    from nabladft_tpu_torch.train.losses import multitask_loss

    kw = dict(num_layers=2)
    fused = create_model("escn", device=card, generator=seeded_generator(3), use_pallas="fused", **kw)
    plain = create_model("escn", device=card, generator=seeded_generator(3), use_pallas="off", **kw)
    g = torch.Generator().manual_seed(4)
    b, a = 2, 32
    real = torch.arange(a)[None] < torch.tensor([[30], [19]])
    batch = MolBatch(z=(torch.randint(1, 9, (b, a), generator=g) * real).int(),
                     pos=torch.randn(b, a, 3, generator=g) * 2.5, node_mask=real,
                     graph_mask=torch.ones(b, dtype=torch.bool),
                     energy=torch.randn(b, generator=g),
                     forces=torch.randn(b, a, 3, generator=g) * real[..., None],
                     mol_id=torch.arange(b)).to(card)
    spec, coef = {"energy": "l1", "forces": "l2norm"}, {"energy": 1.0, "forces": 100.0}
    el.reset_launches()
    outs = []
    for model in (fused, plain):
        out = model(batch)
        multitask_loss(out, batch, spec, coef)["total"].backward()
        outs.append(out)
    torch.cuda.synchronize()
    assert el.LAUNCHES == {"escn_fwd": 2, "escn_bwd": 2, "escn_fwd_bf16": 0,
                           "escn_bwd_bf16": 0}
    for k in ("energy", "forces"):
        want = outs[1][k].detach()
        assert float((outs[0][k].detach() - want).abs().max()) <= 1e-4 * float(want.abs().max())
    for (n, p), (_, q) in zip(fused.named_parameters(), plain.named_parameters()):
        err = float((p.grad - q.grad).abs().max())
        assert err <= 1e-3 * float(q.grad.abs().max()) + 1e-30, (n, err)
