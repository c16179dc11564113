"""PaiNN's kernels A-D in their bf16 mode on the card, against their plain
versions on the same bf16 inputs on the card, and the bf16 PaiNN fused on
the card against its plain path on the CPU.

Every test needs a CUDA card and nvcc and skips without a card. The file
imports no JAX (tests/conftest.py does, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_painn_bf16_cuda.py

Tolerance of a kernel against its plain version: |kernel - plain| <=
2^-7 |plain| + 2e-5 max |plain| per element. Both compute in float32 from
the same bf16 values and round once (A and C their outputs, B and D in the
wrapper); summing in another order may flip that one rounding, which moves
a value by at most one bf16 ulp (2^-7 of it, relative), and g_dist, which
stays float32, by the fp32 tolerance of the float32 kernels.
"""

import pytest
import torch

from nabladft_tpu_torch.ops import painn_fused as pf

SHAPES = [(4, 8, 12, 16), (3, 10, 13, 160), (2, 33, 100, 128)]
BUCKET_SHAPES = [(64, a, 100, 128) for a in (32, 48, 64)]
ULP_REL = 2.0 ** -7
MAX_REL = 2e-5
BF = torch.bfloat16

A_ARGS = ("rbf", "phi", "v", "unit_t", "w")
B_ARGS = ("rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv")
C_ARGS = ("rbf", "rbfd", "phi", "phid", "v", "vd", "unit_t", "unitd_t", "w")
D_ARGS = C_ARGS + ("gds", "gdv", "gdsd", "gdvd")
KERNELS = {  # kernel: (wrapper, plain version, inputs, launch counter)
    "A": (pf.painn_fwd, pf.painn_message_reference, A_ARGS, "painn_fwd_bf16"),
    "B": (pf.painn_bwd, pf.painn_message_bwd_reference, B_ARGS, "painn_bwd_bf16"),
    "C": (pf.painn_dual_fwd, pf.painn_dual_fwd_reference, C_ARGS, "painn_dual_fwd_bf16"),
    "D": (pf.painn_dual_bwd, pf.painn_dual_bwd_reference, D_ARGS, "painn_dual_bwd_bf16"),
}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _inputs(shape, dev, seed=0):
    """Seeded bf16 kernel inputs, ~30 % of pairs masked (the radial chain a
    Gaussian basis of random distances, computed in float32 and cast, as
    the model casts its features)."""
    b, a, r, f = shape
    g = torch.Generator().manual_seed(seed)

    def mk(*s):
        return torch.randn(*s, generator=g) * 0.3

    dist = mk(b, a, a).abs() * 5 + 0.8
    mask = (torch.rand(b, a, a, generator=g) > 0.3).float()
    mu = torch.linspace(0.0, 5.0, r)
    rbf = torch.exp(-((dist[..., None] - mu) ** 2) / 0.05) * mask[..., None]
    rbfp = (-2.0 / 0.05) * (dist[..., None] - mu) * rbf
    x = dict(rbf=rbf, rbfp=rbfp, phi=mk(b, a, 3 * f), v=mk(b, a, 3 * f),
             unit_t=mk(b, a, 3, a), w=mk(r, 3 * f), gds=mk(b, a, f), gdv=mk(b, a, 3 * f),
             rbfd=rbfp * mk(b, a, a)[..., None], phid=mk(b, a, 3 * f), vd=mk(b, a, 3 * f),
             unitd_t=mk(b, a, 3, a), gdsd=mk(b, a, f), gdvd=mk(b, a, 3 * f))
    return {k: t.to(dev, BF) for k, t in x.items()}


def _assert_close(got, ref):
    for i, (x, y) in enumerate(zip(got, ref)):
        if x is None and y is None:
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, i
        x, y = x.float(), y.float()
        limit = ULP_REL * y.abs() + MAX_REL * float(y.abs().max())
        assert bool(((x - y).abs() <= limit).all()), (i, float((x - y).abs().max()))


def _run(kernel, x, **kw):
    fn, ref, names, _ = KERNELS[kernel]
    args = [x[k] for k in names]
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    return got, ref(*args, **kw), args


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + BUCKET_SHAPES)
@pytest.mark.parametrize("kernel", ["A", "B", "C", "D"])
def test_bf16_kernels_match_plain(card, shape, kernel):
    x = _inputs(shape, card)
    pf.reset_launches()
    got, ref, args = _run(kernel, x)
    counter = KERNELS[kernel][3]
    assert pf.LAUNCHES[counter] == 1
    assert pf.LAUNCHES[counter[: -len("_bf16")]] == 0  # the fp32 kernel never ran
    _assert_close(got, ref)
    # the outputs' dtypes as the JAX wrappers give them
    if kernel in "AC":
        assert all(t.dtype == BF for t in got)
    elif kernel == "B":
        assert got[0].dtype == torch.float32 and all(t.dtype == BF for t in got[1:])
    else:
        assert all(t.dtype == BF for t in got)
    assert all(torch.equal(p, q) for p, q in zip(got, KERNELS[kernel][0](*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES[1:] + BUCKET_SHAPES[1:])
@pytest.mark.parametrize("kernel", ["B", "D"])
def test_bf16_backward_kernels_without_gw(card, shape, kernel):
    x = _inputs(shape, card, seed=3)
    pf.reset_launches()
    got, ref, _ = _run(kernel, x, need_gw=False)
    assert got[4] is None and ref[4] is None
    _assert_close(got[:4], ref[:4])
    assert pf.LAUNCHES["painn_bwd_gw_bf16"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["A", "B", "C", "D"])
def test_bf16_kernels_never_reach_the_plain_versions(card, kernel, monkeypatch):
    """A bf16 CUDA tensor launches the bf16 kernel: neither the plain
    version nor a float32 kernel runs."""
    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("painn_message_dense", "_message_bwd", "_dual_fwd", "_dual_bwd"):
        monkeypatch.setattr(pf, name, refuse)
    x = _inputs(SHAPES[2], card, seed=1)
    pf.reset_launches()
    fn, _, names, counter = KERNELS[kernel]
    fn(*[x[k] for k in names])
    torch.cuda.synchronize()
    assert pf.LAUNCHES[counter] == 1
    assert sum(v for k, v in pf.LAUNCHES.items() if not k.endswith("_bf16")) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["A", "B", "C", "D"])
def test_bf16_wrappers_refuse_mixed_dtypes(card, kernel):
    x = _inputs(SHAPES[0], card)
    fn, _, names, _ = KERNELS[kernel]
    for i in range(len(names)):
        args = [x[k] for k in names]
        args[i] = args[i].float()
        with pytest.raises(ValueError, match="dtype"):
            fn(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["A", "C"])
def test_bf16_kernels_pad_r(card, kernel):
    """R off a multiple of 4: the wrapper pads the bf16 pair tensors (a bf16
    copy) for the engine."""
    got, ref, _ = _run(kernel, _inputs((2, 9, 13, 30), card, seed=5))
    _assert_close(got, ref)


@pytest.mark.cuda
def test_bf16_painn_fused_on_card_matches_cpu(card):
    """The bf16 PaiNN, fused on the card (A and B in bf16) against the same
    model's plain path on the CPU in bf16: E within 2e-2 and F within 4e-2
    of their largest magnitude (bf16's 2^-8 rounding compounded over two
    layers, summed in other orders on the two devices)."""
    import numpy as np

    from nabladft_tpu_torch.data.batch import MolBatch
    from nabladft_tpu_torch.data.synthetic import random_molecule
    from nabladft_tpu_torch.models import create_model, forward
    from nabladft_tpu_torch.train import seeded_generator

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
    kw = dict(hidden=32, n_interactions=2, n_rbf=20, max_neighbors=9, compute_dtype="bfloat16")
    gpu = create_model("painn", device=card, generator=seeded_generator(1), use_pallas="fused",
                       **kw)
    cpu = create_model("painn", device="cpu", generator=seeded_generator(1), **kw)
    pf.reset_launches()
    out_g = forward(gpu, batch.to(card))
    assert pf.LAUNCHES["painn_fwd_bf16"] == 2 and pf.LAUNCHES["painn_bwd_bf16"] == 2
    out_c = forward(cpu, batch)
    for key, rel in (("energy", 2e-2), ("forces", 4e-2)):
        g, c = out_g[key].cpu(), out_c[key]
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert float((g - c).abs().max()) <= rel * float(c.abs().max()), key
