"""SchNet's kernels E-H in their bf16 mode on the card, against their plain
versions on the same inputs on the card, and the bf16 SchNet fused on the
card against its plain path on the CPU.

Every test needs a CUDA card and nvcc and skips without a card. The file
imports no JAX (tests/conftest.py does, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_schnet_bf16_cuda.py

The pair and node inputs (and the cotangents) are bf16, the filter weights
float32, as the model hands them over. Tolerance of a kernel against its
plain version, per element: |kernel - plain| <= 2^-7 |plain| + 2e-5 max
|plain| for the bf16 outputs (msg, msgd, gxin, gxind), 2e-5 max |plain| for
the float32 ones (g_dist, the weight gradients). Both compute in float32
from the same bf16 values and round once; summing in another order may flip
that one rounding, which moves a value by at most one bf16 ulp (2^-7 of it,
relative); the float32 outputs keep the float32 kernels' tolerance
(tests/test_torch_cuda.py).
"""

import pytest
import torch

from nabladft_tpu_torch.ops import schnet_fused as sf

SHAPES = [(4, 8, 12, 16), (3, 10, 13, 160), (2, 33, 100, 128)]
BUCKET_SHAPES = [(64, a, 100, 128) for a in (32, 48, 64)]
ULP_REL = 2.0 ** -7
MAX_REL = 2e-5
BF = torch.bfloat16
WEIGHTS = ("w1", "b1", "w2", "b2")

E_ARGS = ("rbf", "envf", "xin") + WEIGHTS
F_ARGS = ("rbf", "rbfp", "envf", "envp", "xin") + WEIGHTS + ("gmsg",)
G_ARGS = ("rbf", "rbfd", "envf", "envfd", "xin", "xind") + WEIGHTS
H_ARGS = G_ARGS + ("gmsg", "gmsgd")
KERNELS = {  # kernel: (wrapper, plain version, inputs, launch counter, bf16 outputs)
    "E": (sf.schnet_fwd, sf.schnet_message_reference, E_ARGS, "schnet_fwd_bf16", (0,)),
    "F": (sf.schnet_bwd, sf.schnet_message_bwd_reference, F_ARGS, "schnet_bwd_bf16", (1,)),
    "G": (sf.schnet_dual_fwd, sf.schnet_dual_fwd_reference, G_ARGS, "schnet_dual_fwd_bf16",
          (0, 1)),
    "H": (sf.schnet_dual_bwd, sf.schnet_dual_bwd_reference, H_ARGS, "schnet_dual_bwd_bf16",
          (0, 1)),
}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _inputs(shape, dev, seed=0):
    """As the model builds them, in bf16 (computed in float32 and cast):
    padded atoms, pairs live within the cutoff minus ~30 %; rbf NOT masked,
    the cosine cutoff and its derivative zero off the live pairs; tangents
    rbfd = rbfp ⊙ ṫ, envfd = envp ⊙ ṫ; the filter weights float32."""
    import math

    b, a, r, f = shape
    g = torch.Generator().manual_seed(seed)

    def mk(*s):
        return torch.randn(*s, generator=g) * 0.3

    n_atoms = torch.randint(max(a // 2, 1), a + 1, (b,), generator=g)
    real = torch.arange(a)[None] < n_atoms[:, None]
    dist = mk(b, a, a).abs() * 8 + 0.8
    live = ((torch.rand(b, a, a, generator=g) > 0.3) & real[:, :, None] & real[:, None, :]
            & ~torch.eye(a, dtype=torch.bool) & (dist < 5.0))
    mu = torch.linspace(0.0, 5.0, r)
    rbf = torch.exp(-((dist[..., None] - mu) ** 2) / 0.25)
    rbfp = (-2.0 / 0.25) * (dist[..., None] - mu) * rbf
    zero = torch.zeros_like(dist)
    envf = torch.where(live, 0.5 * (torch.cos(math.pi * dist / 5.0) + 1.0), zero)
    envp = torch.where(live, -0.5 * math.pi / 5.0 * torch.sin(math.pi * dist / 5.0), zero)
    dt = mk(b, a, a) * live
    x = dict(rbf=rbf, rbfp=rbfp, envf=envf, envp=envp, rbfd=rbfp * dt[..., None],
             envfd=envp * dt, xin=mk(b, a, f), xind=mk(b, a, f), w1=torch.randn(r, f, generator=g)
             / r ** 0.5, b1=mk(1, f), w2=torch.randn(f, f, generator=g) / f ** 0.5, b2=mk(1, f),
             gmsg=mk(b, a, f), gmsgd=mk(b, a, f))
    return {k: t.to(dev, torch.float32 if k in WEIGHTS else BF).contiguous()
            for k, t in x.items()}


def _assert_close(got, ref, bf16_outs):
    for i, (x, y) in enumerate(zip(got, ref)):
        if x is None and y is None:
            continue
        assert x.dtype == y.dtype == (BF if i in bf16_outs else torch.float32), i
        assert x.shape == y.shape, i
        x, y = x.float(), y.float()
        limit = MAX_REL * float(y.abs().max()) + (ULP_REL * y.abs() if i in bf16_outs else 0.0)
        assert bool(((x - y).abs() <= limit).all()), (i, float((x - y).abs().max()))


def _run(kernel, x, **kw):
    fn, ref, names, _, _ = KERNELS[kernel]
    args = [x[k] for k in names]
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    return got if isinstance(got, tuple) else (got,), ref, args


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + BUCKET_SHAPES)
@pytest.mark.parametrize("kernel", ["E", "F", "G", "H"])
def test_bf16_kernels_match_plain(card, shape, kernel):
    x = _inputs(shape, card)
    sf.reset_launches()
    got, ref, args = _run(kernel, x)
    counter, bf16_outs = KERNELS[kernel][3], KERNELS[kernel][4]
    assert sf.LAUNCHES[counter] == 1
    assert sf.LAUNCHES[counter[: -len("_bf16")]] == 0  # the fp32 kernel never ran
    want = ref(*args)
    _assert_close(got, want if isinstance(want, tuple) else (want,), bf16_outs)
    again = KERNELS[kernel][0](*args)  # the same bits twice
    again = again if isinstance(again, tuple) else (again,)
    assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES[1:] + BUCKET_SHAPES[1:])
@pytest.mark.parametrize("kernel", ["F", "H"])
def test_bf16_backward_kernels_without_gw(card, shape, kernel):
    x = _inputs(shape, card, seed=3)
    sf.reset_launches()
    got, ref, args = _run(kernel, x, need_gw=False)
    want = ref(*args, need_gw=False)
    assert got[2:] == (None,) * 4 and want[2:] == (None,) * 4
    _assert_close(got[:2], want[:2], KERNELS[kernel][4])
    assert sf.LAUNCHES["schnet_bwd_gw_bf16"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["E", "F", "G", "H"])
def test_bf16_kernels_never_reach_the_plain_versions(card, kernel, monkeypatch):
    """A bf16 CUDA tensor launches the bf16 kernel: neither the plain
    version nor a float32 kernel runs."""
    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("schnet_message_reference", "schnet_message_bwd_reference",
                 "schnet_dual_fwd_reference", "schnet_dual_bwd_reference", "_message_bwd",
                 "_dual_bwd", "_filter", "_dual_filter"):
        monkeypatch.setattr(sf, name, refuse)
    x = _inputs(SHAPES[2], card, seed=1)
    sf.reset_launches()
    fn, _, names, counter, _ = KERNELS[kernel]
    fn(*[x[k] for k in names])
    torch.cuda.synchronize()
    assert sf.LAUNCHES[counter] == 1
    assert sum(v for k, v in sf.LAUNCHES.items() if not k.endswith("_bf16")) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["E", "F", "G", "H"])
def test_bf16_wrappers_refuse_mixed_dtypes(card, kernel):
    """One pair or node tensor in float32 among bf16 ones, or a filter
    weight in bf16, is refused."""
    x = _inputs(SHAPES[0], card)
    fn, _, names, _, _ = KERNELS[kernel]
    for i, name in enumerate(names):
        args = [x[k] for k in names]
        args[i] = args[i].to(BF if name in WEIGHTS else torch.float32)
        with pytest.raises(ValueError, match="dtype"):
            fn(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["E", "G"])
def test_bf16_kernels_pad_r_and_f(card, kernel):
    """R and F off a multiple of 4: the wrapper pads the bf16 tensors (a
    bf16 copy) and the weights for the engine."""
    got, ref, args = _run(kernel, _inputs((2, 9, 13, 30), card, seed=5))
    want = ref(*args)
    _assert_close(got, want if isinstance(want, tuple) else (want,), KERNELS[kernel][4])


@pytest.mark.cuda
def test_bf16_schnet_fused_on_card_matches_cpu(card):
    """The bf16 SchNet, fused on the card (E and F in bf16) against the same
    model's plain path on the CPU in bf16: E within 2e-2 and F within 4e-2
    of their largest magnitude (bf16's 2^-8 rounding compounded over two
    interactions, summed in other orders on the two devices)."""
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
    gpu = create_model("schnet", device=card, generator=seeded_generator(1), use_pallas="fused",
                       **kw)
    cpu = create_model("schnet", device="cpu", generator=seeded_generator(1), **kw)
    sf.reset_launches()
    out_g = forward(gpu, batch.to(card))
    assert sf.LAUNCHES["schnet_fwd_bf16"] == 2 and sf.LAUNCHES["schnet_bwd_bf16"] == 2
    assert sf.LAUNCHES["schnet_fwd"] == sf.LAUNCHES["schnet_bwd"] == 0
    out_c = forward(cpu, batch)
    for key, rel in (("energy", 2e-2), ("forces", 4e-2)):
        g, c = out_g[key].cpu(), out_c[key]
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert float((g - c).abs().max()) <= rel * float(c.abs().max()), key
