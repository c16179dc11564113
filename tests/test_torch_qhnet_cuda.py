"""QHNet's CUDA kernels I-L against their plain PyTorch versions on the card,
and the fused QHNet against the CPU plain path.

Every test needs a CUDA card and nvcc and skips without a card. The file
imports no JAX (tests/conftest.py does, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_qhnet_cuda.py

Inputs come from chip_smoke.qhnet_kernel_inputs (padded atoms, the 12 Bohr
radius graph folded into cgsh, the full-graph mask in maskf). Shapes cover
atom counts that are not a multiple of the 8-row blocks, channel counts that
leave a partial 128-lane chunk, and the train path's bucket shapes.
Tolerance: max |kernel - plain| <= 2e-5 x max |plain| per output (fp32 sums
in another order), as in chip_smoke.py.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nabladft_tpu_torch.ops import qhnet_tp as qt

REPO = Path(__file__).resolve().parent.parent
REL = 2e-5
# (B, A, C, conv H1/H2, pair H1/H2)
SMALL = [(2, 13, 40, (5, 7), (3, 9)), (1, 9, 136, (32, 32), (8, 128))]
BUCKETS = [(8, a, 128, (32, 32), (8, 128)) for a in (32, 48, 64)]


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
        err = float((x - y).abs().max())
        assert err <= REL * float(y.abs().max()) + 1e-30, (i, err, float(y.abs().max()))


KERNELS = {"I": (qt.qhnet_conv_fwd, qt.conv_fwd_reference),
           "J": (qt.qhnet_conv_bwd, qt.conv_bwd_reference),
           "K": (qt.qhnet_pair_fwd, qt.pair_fwd_reference),
           "L": (qt.qhnet_pair_bwd, qt.pair_bwd_reference)}


def _args(smoke, kind, x):
    return [x[k] for k in smoke.QH_ARGS[kind]]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["I", "J", "K", "L"])
@pytest.mark.parametrize("shape", SMALL + BUCKETS, ids=lambda s: f"B{s[0]}A{s[1]}C{s[2]}")
def test_kernel_matches_plain(card, smoke, kind, shape):
    b, a, c, hc, hp = shape
    x = smoke.qhnet_kernel_inputs(card, b, a, c, hc, hp, seed=a + c)
    fn, ref = KERNELS[kind]
    qt.reset_launches()
    got, want = fn(*_args(smoke, kind, x)), ref(*_args(smoke, kind, x))
    torch.cuda.synchronize()
    got, want = (got, want) if kind in "JL" else ((got,), (want,))
    assert sum(qt.LAUNCHES.values()) == 1
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["I", "J", "K", "L"])
def test_backward_kernels_repeat_their_bits(card, smoke, kind):
    x = smoke.qhnet_kernel_inputs(card, 3, 21, 72, (32, 32), (8, 128), seed=3)
    fn = KERNELS[kind][0]
    first, again = fn(*_args(smoke, kind, x)), fn(*_args(smoke, kind, x))
    first, again = (first, again) if kind in "JL" else ((first,), (again,))
    assert all(torch.equal(p, q) for p, q in zip(first, again))


# each kernel's launches on the card: those that must run, and the bodies they replaced
ENGINE_RUNS = {
    "I": (("so2_mma_kernel", "qhnet_conv_tp_fwd_kernel"), ("qhnet_conv_fwd_kernel",)),
    "J": (("so2_mma_kernel", "so2_mmw_kernel", "so2_colsum_kernel", "qhnet_conv_tp_bwd_kernel"),
          ("qhnet_gemm_nt", "qhnet_gw_")),
    "K": (("so2_mma_kernel", "qhnet_pair_tp_fwd_kernel"), ("qhnet_pair_fwd_kernel",)),
    "L": (("so2_mma_kernel", "so2_mmw_kernel", "so2_colsum_kernel", "qhnet_pair_tp_bwd_kernel"),
          ("qhnet_gemm_nt", "qhnet_gw_")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["I", "J", "K", "L"])
def test_backward_gate_products_run_on_the_engine(card, smoke, kind):
    """The gate products of I-L (u or w = u_r u_s; in J and L also gh and
    [gW2; gb2]) are the tensor-core engine's kernels; the CUDA-core bodies
    they replaced are gone."""
    from torch.profiler import ProfilerActivity, profile

    x = smoke.qhnet_kernel_inputs(card, 2, 24, 128, (32, 32), (8, 128), seed=5)
    fn = KERNELS[kind][0]
    fn(*_args(smoke, kind, x))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*_args(smoke, kind, x))
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    present, absent = ENGINE_RUNS[kind]
    for want in present:
        assert any(want in n for n in names), (want, sorted(names))
    assert not any(gone in n for n in names for gone in absent), sorted(names)


@pytest.mark.cuda
def test_masked_pairs_and_padded_atoms_give_exact_zeros(card, smoke):
    b, a = 3, 19
    x = smoke.qhnet_kernel_inputs(card, b, a, 40, (32, 32), (8, 128), seed=7)
    real = x["node_mask"]
    pad_j = ~real  # [B,A]
    # conv: padded receivers (no live pair) get no agg
    agg = qt.qhnet_conv_fwd(*_args(smoke, "I", x))
    assert float(agg[pad_j].abs().max()) == 0.0
    # conv: padded senders get no gx; pairs off the radius graph no ghr / ghs
    gx, ghr, ghs, *_ = qt.qhnet_conv_bwd(*_args(smoke, "J", x))
    assert float(gx.permute(0, 2, 1, 3)[pad_j].abs().max()) == 0.0
    dead = ~x["adj"]
    assert float(ghr[dead].abs().max()) == 0.0 and float(ghs[dead].abs().max()) == 0.0
    # pair: masked pairs give zero blocks and zero gate cotangents
    fij = qt.qhnet_pair_fwd(*_args(smoke, "K", x))
    off = x["maskf"][..., 0] == 0  # [B,A(i),A(j)]
    assert float(fij.permute(0, 1, 3, 2, 4)[off].abs().max()) == 0.0
    gx, gzi, ghr, ghs, *_ = qt.qhnet_pair_bwd(*_args(smoke, "L", x))
    assert float(ghr[off].abs().max()) == 0.0 and float(ghs[off].abs().max()) == 0.0
    assert float(gx.permute(0, 2, 1, 3)[pad_j].abs().max()) == 0.0
    kz_used = qt._zi_layout(qt.LMAX)[1]
    assert float(gzi[:, :, kz_used:].abs().max()) == 0.0


def _batch(seed=0):
    from nabladft_tpu_torch.data.batch import MolBatch

    rng = np.random.default_rng(seed)
    norb = {1: 5, 6: 14, 8: 14}
    mols, a, o = ((6, 1, 1, 8, 1), (8, 1, 1), (6, 6, 8, 1, 1, 1, 1)), 9, 64
    b = len(mols)
    z = np.zeros((b, a), np.int32)
    pos = np.zeros((b, a, 3), np.float32)
    om = np.zeros((b, o), bool)
    ham = np.zeros((b, o, o), np.float32)
    for i, zs in enumerate(mols):
        z[i, :len(zs)] = zs
        pos[i, :len(zs)] = rng.uniform(-3, 3, (len(zs), 3))
        no = sum(norb[q] for q in zs)
        om[i, :no] = True
        m = rng.normal(size=(no, no))
        ham[i, :no, :no] = m + m.T
    t = torch.from_numpy
    return MolBatch(z=t(z), pos=t(pos), node_mask=t(z > 0),
                    graph_mask=torch.ones(b, dtype=torch.bool), energy=torch.zeros(b),
                    forces=torch.zeros(b, a, 3),
                    mol_id=torch.arange(b, dtype=torch.int32), hamiltonian=t(ham), orb_mask=t(om))


@pytest.mark.cuda
def test_fused_qhnet_matches_cpu_plain_path(card):
    from nabladft_tpu_torch.models import create_model
    from nabladft_tpu_torch.train import losses, seeded_generator

    kw = dict(hidden=16, bottle_hidden=8, num_layers=3, start_layer=1, rbf_dim=8,
              orbitals={1: (0, 0, 1), 6: (0, 0, 0, 1, 1, 2), 8: (0, 0, 0, 1, 1, 2)})
    batch = _batch()
    cpu = create_model("qhnet", device="cpu", generator=seeded_generator(0), **kw)
    fused = create_model("qhnet", device=card, use_pallas="fused",
                         generator=seeded_generator(0), **kw)
    plain = create_model("qhnet", device=card, generator=seeded_generator(0), **kw)
    with torch.no_grad():
        h_cpu = cpu(batch)["hamiltonian"]
        h_gpu = fused(batch.to(card))["hamiltonian"].cpu()
    assert float((h_gpu - h_cpu).abs().max()) <= 1e-4 * float(h_cpu.abs().max())
    spec = {"hamiltonian": "rmse_mae"}
    for m in (fused, plain):
        losses.multitask_loss(m(batch.to(card)), batch.to(card), spec, {})["total"].backward()
    for (n, p), (_, q) in zip(fused.named_parameters(), plain.named_parameters()):
        err = float((p.grad - q.grad).abs().max())
        assert err <= 1e-3 * float(q.grad.abs().max()) + 1e-30, n
