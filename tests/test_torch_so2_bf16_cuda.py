"""The bf16 mode (mxu_bf16) of kernels M-P and of their SO(2) product engine
on the card, against plain PyTorch versions that round the same way.

Every test needs a CUDA card and nvcc and skips without a card. The file
imports no JAX (tests/conftest.py does, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_so2_bf16_cuda.py

* The engine's `rbf16` segments (so2_common.cuh: both operands rounded to
  bf16, nearest-even, one TF32 pass, float32 sums): products (gathered and
  scattered rows, transposed and signed segments, a launch mixing rounded and
  float32 segments over the same B) and weight gradients (rows, gathered),
  against float64 products of the operands rounded by torch (`round_bf16`),
  within 2e-5 x max (the engine's float32 sums); values halfway between two
  bf16 numbers round to the even one, exactly as torch rounds them.
* Kernels M, N, O and P with mxu_bf16 on chip_smoke's inputs at the widths
  of configs/escn-oc.yaml and configs/equiformer_v2.yaml (two molecules at
  A = 32 and 48) against their plain versions in the same mode, every
  output within chip_smoke's BF16_SO2_FRO_REL (relative Frobenius) and
  BF16_SO2_MAX_REL x max (float32 sums in another order may flip a rounding,
  and later stages carry the flips), twice for the same bits, counted under
  their bf16 names; the float32 kernels on the same inputs lie farther from
  the plain bf16 versions than the bf16 kernels do; the autograd Functions launch the
  bf16 kernels and never their plain versions.
* The fused bf16 eSCN and EquiformerV2 (two layers) against the plain bf16
  models on the card: E and F within chip_smoke.BF16_PATHS_TOL x max, one
  step's whole gradient within relative Frobenius error
  BF16_PATHS_TOL["forces"]. The two round at the same points, but every bf16
  stage (EquiformerV2's grid FFNs and attentions) turns the other's
  sum-order differences into flipped roundings, so they part at the bf16
  noise level, as two paths that round in other places do.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nabladft_tpu_torch.ops import eqv2_attn as ea
from nabladft_tpu_torch.ops import escn_layer as el

REPO = Path(__file__).resolve().parent.parent
REL = 2e-5
SHAPES = [(2, 32), (2, 48)]


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


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _rel(got, ref) -> float:
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# the engine's bf16-rounding segments
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [127, 5000])
def test_rounded_products_match_rounded_float64(card, rows):
    rng = np.random.default_rng(rows)
    slots, k, n = rows + 77, 96, 136
    a, b, bt = _rand(rng, slots, k), _rand(rng, k, n, scale=0.1), _rand(rng, n, k, scale=0.1)
    eidx = torch.from_numpy(np.sort(rng.choice(slots, rows, replace=False)).astype(np.int32))
    t = {q: v.to(card) for q, v in dict(a=a, b=b, bt=bt, c=torch.zeros(slots, n),
                                          c2=torch.zeros(slots, n)).items()}
    probs = [dict(segs=[dict(a=t["a"], b=t["b"], k=k, rbf16=True),
                        dict(a=t["a"], b=t["bt"], k=k, btrans=True, sign=-1, rbf16=True)],
                  n=n, c=t["c"], gather=True),
             # the same B as float32 in the same launch (a prep job of its own)
             dict(segs=[dict(a=t["a"], b=t["b"], k=k)], n=n, c=t["c2"], gather=True,
                  scatter=True)]
    ea.so2_products(probs, rows, eidx.to(card))
    torch.cuda.synchronize()
    r = el.round_bf16
    live = eidx.long()
    want = r(a[live]).double() @ r(b).double() - r(a[live]).double() @ r(bt).double().T
    assert _rel(t["c"][:rows].cpu(), want) <= REL
    want32 = a[live].double() @ b.double()
    assert _rel(t["c2"][live.to(card)].cpu(), want32) <= REL
    # the rounding shows: the float32 product lies farther off
    assert _rel(t["c"][:rows].cpu(), a[live].double() @ (b.double() - bt.double().T)) > 1e2 * REL


@pytest.mark.cuda
def test_rounded_weight_gradients_match_rounded_float64(card):
    rng = np.random.default_rng(3)
    rows, slots, m, n = 9000, 9100, 72, 200
    a, bb = _rand(rng, slots, m), _rand(rng, slots, n)
    eidx = torch.from_numpy(np.sort(rng.choice(slots, rows, replace=False)).astype(np.int32))
    out, outg = torch.zeros(m, n, device=card), torch.zeros(m, n, device=card)
    ad, bd = a.to(card), bb.to(card)
    ea.so2_wgrads([dict(segs=[dict(a=ad, b=bd, rbf16=True), dict(a=ad, b=bd, sign=-1)],
                        m=m, n=n, out=out),
                   dict(segs=[dict(a=ad, b=bd, rbf16=True)], amode="gather", m=m, n=n,
                        out=outg)], rows, eidx.to(card))
    again = torch.zeros_like(out)
    ea.so2_wgrads([dict(segs=[dict(a=ad, b=bd, rbf16=True), dict(a=ad, b=bd, sign=-1)],
                        m=m, n=n, out=again)], rows, eidx.to(card))
    torch.cuda.synchronize()
    r = el.round_bf16
    rows_ = torch.arange(rows)
    want = (r(a[rows_]).double().T @ r(bb[rows_]).double()
            - a[rows_].double().T @ bb[rows_].double())
    assert float((out.cpu().double() - want).abs().max()) <= REL * float(
        (a[rows_].double().T @ bb[rows_].double()).abs().max())
    wantg = r(a[eidx.long()]).double().T @ r(bb[rows_]).double()
    assert _rel(outg.cpu(), wantg) <= REL
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_rounding_is_nearest_even_at_ties(card):
    """A holds values halfway between two bf16 numbers (and their
    neighbours); B is the identity, so C is A rounded, exactly."""
    k = 64
    base = torch.tensor([1.0, 1.5, -1.25, 3.0], dtype=torch.float32)
    bits = base.view(torch.int32)
    ties = [(bits + off).view(torch.float32) for off in (0x8000, 0x18000, 0x7FFF, 0x8001)]
    a = torch.cat(ties).repeat(k).reshape(16, k)  # 16 values, each k times
    eye = torch.eye(k)
    c = torch.zeros(16, k, device=card)
    ea.so2_products([dict(segs=[dict(a=a.to(card), b=eye.to(card), k=k, rbf16=True)], n=k,
                          c=c)], 16)
    out = torch.zeros(k, k, device=card)
    ea.so2_wgrads([dict(segs=[dict(a=eye[:16].to(card), b=a.to(card), rbf16=True)], m=16, n=k,
                        out=out[:16])], 16)
    torch.cuda.synchronize()
    assert torch.equal(c.cpu(), el.round_bf16(a))
    assert torch.equal(out[:16].cpu(), el.round_bf16(a))


# ---------------------------------------------------------------------------
# kernels M-P in their bf16 mode
# ---------------------------------------------------------------------------


def _cases(smoke, card, kernel, b, a):
    """(wrapper, plain version, args, keywords with mxu_bf16, launch counter)."""
    if kernel in "MN":
        x = smoke.escn_kernel_inputs(card, b, a, seed=a)
        args, kw = (x["x"], x["d"], x["xe"], *x["ws"]), dict(x["dims"], mxu_bf16=True)
        if kernel == "N":
            kw["g"] = x["g"]
        fns = {"M": (el.escn_fwd, el.escn_fwd_reference), "N": (el.escn_bwd, el.escn_bwd_reference)}
    else:
        inp = smoke.eqv2_kernel_inputs(card, b, a, seed=a + 1)
        args, kw = tuple(smoke._eqv2_args(inp)), dict(inp["dims"], mxu_bf16=True)
        if kernel == "P":
            kw["g"] = inp["g"]
        fns = {"O": (ea.eqv2_fwd, ea.eqv2_fwd_reference), "P": (ea.eqv2_bwd, ea.eqv2_bwd_reference)}
    counter = {"M": "escn_fwd", "N": "escn_bwd", "O": "eqv2_fwd", "P": "eqv2_bwd"}[kernel]
    return (*fns[kernel], args, kw, counter)


def _tuple(t):
    return t if isinstance(t, tuple) else (t,)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"B{s[0]}A{s[1]}")
@pytest.mark.parametrize("kernel", ["M", "N", "O", "P"])
def test_bf16_kernels_match_plain(card, smoke, kernel, shape):
    fn, ref, args, kw, counter = _cases(smoke, card, kernel, *shape)
    mod = el if kernel in "MN" else ea
    mod.reset_launches()
    got, again = _tuple(fn(*args, **kw)), _tuple(fn(*args, **kw))
    torch.cuda.synchronize()
    assert mod.LAUNCHES[counter + "_bf16"] == 2 and mod.LAUNCHES[counter] == 0
    want = _tuple(ref(*args, **kw))
    got32 = _tuple(fn(*args, **dict(kw, mxu_bf16=False)))
    assert len(got) == len(want)
    for i, (p, q) in enumerate(zip(got, want)):
        assert p.dtype == torch.float32 and torch.equal(p, again[i]), i
        assert smoke.fro_rel(p, q) <= smoke.BF16_SO2_FRO_REL, (i, smoke.fro_rel(p, q))
        assert _rel(p, q) <= smoke.BF16_SO2_MAX_REL, (i, _rel(p, q))
    # the rounding shows: the float32 kernel lies farther from the plain bf16 version
    assert (min(smoke.fro_rel(p, q) for p, q in zip(got32, want))
            > max(smoke.fro_rel(p, q) for p, q in zip(got, want)))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["escn", "eqv2"])
def test_autograd_functions_launch_the_bf16_kernels(card, smoke, family, monkeypatch):
    mod = el if family == "escn" else ea
    for name in ([f"{family}_fwd_reference", f"{family}_bwd_reference"]):
        monkeypatch.setattr(mod, name, lambda *a, **k: pytest.fail("a plain version ran"))
    mod.reset_launches()
    if family == "escn":
        x = smoke.escn_kernel_inputs(card, 2, 24, seed=5)
        xx = x["x"].clone().requires_grad_(True)
        out = el.escn_message(xx, x["d"], x["xe"], *x["ws"], **x["dims"], mxu_bf16=True)
        out.backward(x["g"])
    else:
        inp = smoke.eqv2_kernel_inputs(card, 2, 24, seed=5)
        xx = inp["x"].clone().requires_grad_(True)
        dims = dict(inp["dims"], mxu_bf16=True)
        out = ea.eqv2_attention(xx, xx, inp["idx"], inp["d"], inp["xe"], inp["maskf"],
                                inp["dropk"], *inp["ws"], **dims)
        out.backward(inp["g"])
    torch.cuda.synchronize()
    assert mod.LAUNCHES[f"{family}_fwd_bf16"] == mod.LAUNCHES[f"{family}_bwd_bf16"] == 1
    assert mod.LAUNCHES[f"{family}_fwd"] == mod.LAUNCHES[f"{family}_bwd"] == 0
    assert bool(torch.isfinite(xx.grad).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["escn", "equiformer_v2"])
def test_fused_bf16_model_matches_plain_bf16_model(card, smoke, name):
    from nabladft_tpu_torch.data.batch import MolBatch
    from nabladft_tpu_torch.models import create_model
    from nabladft_tpu_torch.train import seeded_generator
    from nabladft_tpu_torch.train.losses import multitask_loss

    kw = dict(num_layers=2, compute_dtype="bfloat16")
    if name == "equiformer_v2":
        kw.update(sphere_channels=16, num_heads=2, attn_alpha_channels=8, attn_value_channels=8,
                  ffn_hidden_channels=16, edge_channels=8, num_distance_basis=16)
    g = torch.Generator().manual_seed(4)
    b, a = 2, 24
    real = torch.arange(a)[None] < torch.tensor([[22], [15]])
    batch = MolBatch(z=(torch.randint(1, 9, (b, a), generator=g) * real).int(),
                     pos=torch.randn(b, a, 3, generator=g) * 2.5, node_mask=real,
                     graph_mask=torch.ones(b, dtype=torch.bool),
                     energy=torch.randn(b, generator=g),
                     forces=torch.randn(b, a, 3, generator=g) * real[..., None],
                     mol_id=torch.arange(b)).to(card)
    outs, grads = [], []
    for mode in ("fused", "off"):
        model = create_model(name, device=card, generator=seeded_generator(3), use_pallas=mode,
                             **kw).eval()
        out = model(batch)
        multitask_loss(out, batch, {"energy": "l1", "forces": "l2norm"},
                       {"energy": 1.0, "forces": 100.0})["total"].backward()
        outs.append({k: v.detach() for k, v in out.items()})
        grads.append([p.grad for p in model.parameters()])
    for k in ("energy", "forces"):
        assert _rel(outs[0][k], outs[1][k]) <= smoke.BF16_PATHS_TOL[k], (k, _rel(outs[0][k],
                                                                             outs[1][k]))
    flat = [torch.cat([g.reshape(-1) for g in gs]) for gs in grads]
    assert smoke.fro_rel(*flat) <= smoke.BF16_PATHS_TOL["forces"], smoke.fro_rel(*flat)
