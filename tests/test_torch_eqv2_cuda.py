"""EquiformerV2's CUDA kernels O and P against their plain PyTorch versions on
the card, and the fused EquiformerV2 against the plain one.

Every test needs a CUDA card and nvcc and skips without a card. The file
imports no JAX (tests/conftest.py does, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_eqv2_cuda.py

The products' engine: float32 O and P run it in 3xTF32 (so2_mma_kernel,
so2_mmw_kernel), bf16 ones (mxu_bf16) in its bf16 operand mode
(so2_mma16_kernel, so2_mmw16_kernel), seen in a profile of one call each.

Inputs come from chip_smoke.eqv2_kernel_inputs at the widths of
configs/equiformer_v2.yaml (l_max 6, m_max 2, C 128, 8 heads × 16 value and
64 alpha channels, 3 × 128 edge channels; idx, d and xe from the 12 Å /
30-neighbour graph, padded atoms, a seeded dropout mask), at the bucket
shapes A = 32/48/64 with two molecules (the plain version's memory), and at
narrow widths that leave partial 128-row and 128-column tiles. Tolerance: max
|kernel - plain| <= 2e-5 x max |plain| per output (fp32 sums in another
order), as in chip_smoke.py; the fused model within 1e-4 (E, F) and 1e-3
(gradients, per tensor) of the plain model's largest magnitude.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.data.synthetic import random_molecule
from nabladft_tpu_torch.ops import eqv2_attn as ea

REPO = Path(__file__).resolve().parent.parent
REL = 2e-5
NARROW = dict(sphere_channels=40, num_heads=3, attn_alpha_channels=40, attn_value_channels=8,
              edge_channels=16)
# (B, A, overrides of the equiformer_v2 widths)
SHAPES = [(1, 11, NARROW), (2, 32, {}), (2, 48, {}), (2, 64, {})]
ARGS = ("x", "x", "idx", "d", "xe", "maskf", "dropk")


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


def _close(got, ref, rel=REL):
    for i, (x, y) in enumerate(zip(got, ref)):
        assert x.shape == y.shape, i
        err = float((x - y).abs().max())
        assert err <= rel * float(y.abs().max()) + 1e-30, (i, err, float(y.abs().max()))


def _maxabs(t) -> float:
    return float(t.abs().max()) if t.numel() else 0.0


def _args(inp):
    return [inp[k] for k in ARGS] + inp["ws"]


def _batch(dev, b: int, a: int, seed: int = 0) -> MolBatch:
    """b seeded molecules of a/2..a atoms (random_molecule), padded to a."""
    rng = np.random.default_rng(seed)
    f = dict(z=np.zeros((b, a), np.int32), pos=np.zeros((b, a, 3), np.float32),
             node_mask=np.zeros((b, a), bool), graph_mask=np.ones(b, bool),
             energy=rng.normal(size=b).astype(np.float32), forces=np.zeros((b, a, 3), np.float32),
             mol_id=np.arange(b, dtype=np.int32))
    for i in range(b):
        n = int(rng.integers(a // 2, a + 1))
        f["z"][i, :n], f["pos"][i, :n] = random_molecule(rng, n)
        f["node_mask"][i, :n] = True
        f["forces"][i, :n] = rng.normal(size=(n, 3))
    return MolBatch(**{k: torch.from_numpy(v) for k, v in f.items()}).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_o_matches_plain(card, smoke, shape, drop):
    b, a, kw = shape
    inp = smoke.eqv2_kernel_inputs(card, b, a, seed=a, drop=drop, **kw)
    got = ea.eqv2_fwd(*_args(inp), **inp["dims"])
    torch.cuda.synchronize()
    _close([got], [ea.eqv2_fwd_reference(*_args(inp), **inp["dims"])])
    # padded atoms receive nothing
    assert _maxabs(got[~inp["node_mask"]]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_p_matches_plain_and_repeats(card, smoke, shape):
    b, a, kw = shape
    inp = smoke.eqv2_kernel_inputs(card, b, a, seed=a + 1, **kw)
    got = ea.eqv2_bwd(*_args(inp), g=inp["g"], **inp["dims"])
    again = ea.eqv2_bwd(*_args(inp), g=inp["g"], **inp["dims"])
    torch.cuda.synchronize()
    ref = ea.eqv2_bwd_reference(*_args(inp), g=inp["g"], **inp["dims"])
    assert len(got) == len(ref) == 3 + len(inp["ws"])
    _close(got, ref)
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    dead = inp["maskf"] == 0
    assert _maxabs(got[2][dead]) == 0.0  # gxe of dead edges
    pad = ~inp["node_mask"]
    assert _maxabs(got[0][pad]) == 0.0 and _maxabs(got[1][pad]) == 0.0  # gx, gxi of padding


@pytest.mark.cuda
def test_autograd_function_launches_o_and_p(card, smoke):
    inp = smoke.eqv2_kernel_inputs(card, 2, 24, seed=5)
    x = inp["x"].clone().requires_grad_(True)
    xe = inp["xe"].clone().requires_grad_(True)
    ws = [w.clone().requires_grad_(True) for w in inp["ws"]]
    ea.reset_launches()
    out = ea.eqv2_attention(x, x, inp["idx"], inp["d"], xe, inp["maskf"], inp["dropk"], *ws,
                            **inp["dims"])
    out.backward(inp["g"])
    assert ea.LAUNCHES == {"eqv2_fwd": 1, "eqv2_bwd": 1, "eqv2_fwd_bf16": 0,
                           "eqv2_bwd_bf16": 0, "so2_products": 0, "so2_wgrads": 0}
    gx, gxi, gxe, *gws = ea.eqv2_bwd_reference(*_args(inp), g=inp["g"], **inp["dims"])
    _close([x.grad, xe.grad, *[w.grad for w in ws]], [gx + gxi, gxe, *gws])


def _kernel_names(fn) -> dict:
    """{kernel name: launches} of one call of fn (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
def test_products_run_on_the_mode_s_engine_kernels(card, smoke, mxu_bf16):
    """O and P in the bf16 mode run their products and weight gradients on
    the bf16 operand mode's kernels (bf16 wgmma) and none on the float32
    engine's; in float32 the other way round."""
    inp = smoke.eqv2_kernel_inputs(card, 2, 32, seed=9)
    dims = dict(inp["dims"], mxu_bf16=mxu_bf16)
    names = _kernel_names(lambda: (ea.eqv2_fwd(*_args(inp), **dims),
                                   ea.eqv2_bwd(*_args(inp), g=inp["g"], **dims)))
    has = {k: any(k + "<" in n or k + "(" in n for n in names)
           for k in ("so2_mma16_kernel", "so2_mmw16_kernel", "so2_mma_kernel", "so2_mmw_kernel",
                     "eqv2_rows16_kernel")}
    assert has == {"so2_mma16_kernel": mxu_bf16, "so2_mmw16_kernel": mxu_bf16,
                   "so2_mma_kernel": not mxu_bf16, "so2_mmw_kernel": not mxu_bf16,
                   "eqv2_rows16_kernel": mxu_bf16}, names


@pytest.mark.cuda
def test_unsupported_shapes_raise(card, smoke):
    inp = smoke.eqv2_kernel_inputs(card, 1, 8, seed=2, l_max=2, m_max=1, **NARROW)
    with pytest.raises(ValueError, match="built for l_max=6"):
        ea.eqv2_fwd(*_args(inp), **inp["dims"])


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
def test_fused_model_matches_plain(card, train):
    """EquiformerV2 at narrow widths (2 layers, l_max 6, m_max 2): E, F and
    one step's parameter gradients of the fused model against the plain
    one's; in train mode both draw the same dropout masks (the same seeded
    generator)."""
    from nabladft_tpu_torch.models import create_model
    from nabladft_tpu_torch.train import seeded_generator
    from nabladft_tpu_torch.train.losses import multitask_loss

    kw = dict(num_layers=2, sphere_channels=16, num_heads=2, attn_alpha_channels=8,
              attn_value_channels=8, ffn_hidden_channels=16, edge_channels=8,
              num_distance_basis=16)
    batch = _batch(card, 4, 20)
    outs, grads = [], []
    for mode in ("fused", "off"):
        model = create_model("equiformer_v2", device=card, generator=seeded_generator(0),
                             use_pallas=mode, **kw).train(train)
        model.dropout_generator = torch.Generator(device=card).manual_seed(7)
        out = model(batch)
        multitask_loss(out, batch, {"energy": "l1", "forces": "l2norm"},
                       {"energy": 1.0, "forces": 100.0})["total"].backward()
        outs.append({k: v.detach() for k, v in out.items()})
        grads.append([p.grad for p in model.parameters()])
    for k in ("energy", "forces"):
        _close([outs[0][k]], [outs[1][k]], rel=1e-4)
    _close(grads[0], grads[1], rel=1e-3)
