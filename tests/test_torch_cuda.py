"""The port's CUDA kernels (PaiNN's A-D, SchNet's E-H) against their plain
PyTorch versions, on the card, and the fused models against the CPU plain
path.

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
# the train path's kernel shapes: B=64 molecules of each bucket's A atoms
BUCKET_SHAPES = [(64, a, 100, 128) for a in (32, 48, 64)]
REL = 2e-5


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dev, seed=0, masks=None):
    """Seeded kernel inputs, ~30 % of pairs masked; `masks` {molecule: 0 or
    1} makes a molecule's pairs all dead or all live."""
    b, a, r, f = shape
    g = torch.Generator().manual_seed(seed)

    def mk(*s):
        return torch.randn(*s, generator=g) * 0.3

    dist = mk(b, a, a).abs() * 5 + 0.8
    mask = (torch.rand(b, a, a, generator=g) > 0.3).float()
    for mol, value in (masks or {}).items():
        mask[mol] = value
    mu = torch.linspace(0.0, 5.0, r)
    rbf = torch.exp(-((dist[..., None] - mu) ** 2) / 0.05) * mask[..., None]
    rbfp = (-2.0 / 0.05) * (dist[..., None] - mu) * rbf
    x = dict(dist=dist, rbf=rbf, rbfp=rbfp, phi=mk(b, a, 3 * f), v=mk(b, a, 3 * f),
             unit_t=mk(b, a, 3, a), w=mk(r, 3 * f), gds=mk(b, a, f), gdv=mk(b, a, 3 * f))
    # the tangent lanes: rbfd = rbfp * (a distance tangent), as the model builds it
    x.update(rbfd=rbfp * mk(b, a, a)[..., None], phid=mk(b, a, 3 * f), vd=mk(b, a, 3 * f),
             unitd_t=mk(b, a, 3, a), gdsd=mk(b, a, f), gdvd=mk(b, a, 3 * f))
    return {k: t.to(dev) for k, t in x.items()}


def _assert_close(got, ref):
    for i, (x, y) in enumerate(zip(got, ref)):
        err = float((x - y).abs().max())
        assert err <= REL * float(y.abs().max()) + 1e-30, (i, err)


A_ARGS = ("rbf", "phi", "v", "unit_t", "w")
B_ARGS = ("rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv")
C_ARGS = ("rbf", "rbfd", "phi", "phid", "v", "vd", "unit_t", "unitd_t", "w")
D_ARGS = C_ARGS + ("gds", "gdv", "gdsd", "gdvd")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + BUCKET_SHAPES)
def test_fwd_kernel_matches_plain(card, shape):
    x = _inputs(shape, card)
    args = [x[k] for k in A_ARGS]
    pf.reset_launches()
    got = pf.painn_fwd(*args)
    torch.cuda.synchronize()
    assert pf.LAUNCHES["painn_fwd"] == 1
    _assert_close(got, pf.painn_message_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + BUCKET_SHAPES)
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
@pytest.mark.parametrize("kernel", ["B", "D"])
@pytest.mark.parametrize("need_gw", [True, False])
@pytest.mark.parametrize("masks", [{0: 0.0, 1: 1.0}, {0: 0.0, 1: 0.0, 2: 0.0}],
                         ids=["dead_and_live_molecules", "all_dead"])
def test_bwd_kernels_on_dead_and_live_molecules(card, kernel, need_gw, masks):
    """B and D list the live pairs (rbf or its second pair tensor not zero):
    a molecule with no live pair, one with every pair live (self pairs too),
    and a batch with none."""
    x = _inputs((3, 48, 100, 128), card, seed=4, masks=masks)
    fn, ref, names = ((pf.painn_bwd, pf.painn_message_bwd_reference, B_ARGS) if kernel == "B"
                      else (pf.painn_dual_bwd, pf.painn_dual_bwd_reference, D_ARGS))
    args = [x[k] for k in names]
    got = fn(*args, need_gw=need_gw)
    torch.cuda.synchronize()
    want = ref(*args, need_gw=need_gw)
    if not need_gw:
        assert got[-1] is None and want[-1] is None
        got, want = got[:-1], want[:-1]
    _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("need_gw", [True, False])
def test_bwd_kernel_is_deterministic_at_a_bucket(card, need_gw):
    x = _inputs(BUCKET_SHAPES[1], card)
    args = [x[k] for k in B_ARGS]
    first, second = pf.painn_bwd(*args, need_gw=need_gw), pf.painn_bwd(*args, need_gw=need_gw)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(first, second))


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


@pytest.mark.cuda
def test_fused_relaxation_on_card_matches_plain(card):
    """The first five L-BFGS iterations of the fused PaiNN on the card (A
    and B once per evaluation, B's gW stage never) against the plain module
    on the card, same weights: positions within 1e-4 Å, E and F within the
    model tolerances of the plain module at the same positions."""
    from nabladft_tpu_torch.data import BucketedLoader, EnergyDataset, LoaderConfig
    from nabladft_tpu_torch.data.synthetic import write_random_db
    from nabladft_tpu_torch.models import create_model
    from nabladft_tpu_torch.optimize import BatchwiseCalculator, lbfgs_relax
    from nabladft_tpu_torch.train import seeded_generator
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        db = write_random_db(Path(tmp) / "in.db", n_mols=16, min_atoms=8, max_atoms=30, seed=2)
        ds = EnergyDataset(db, root=tmp, bucket_boundaries=(32,))
        batch = next(iter(BucketedLoader(ds, config=LoaderConfig(batch_size=16,
                                                                   shuffle=False)))).to(card)
    kw = dict(hidden=128, n_interactions=2, n_rbf=100)
    fused, plain = (create_model("painn", device=card, generator=seeded_generator(1),
                                 use_pallas=mode, **kw).eval() for mode in ("fused", "off"))
    results, launches = [], []
    for model in (fused, plain):
        pf.reset_launches()
        results.append(lbfgs_relax(BatchwiseCalculator(model), batch, fmax=1e-6, max_steps=5,
                                   memory=100))
        launches.append(dict(pf.LAUNCHES))
    # 2 layers x 6 evaluations (the initial one and one a step)
    assert launches[0] == dict(launches[0], painn_fwd=12, painn_bwd=12, painn_bwd_gw=0)
    assert not any(launches[1].values())  # the plain module launches nothing
    r_f, r_p = results
    assert r_f.nsteps == r_p.nsteps == 5
    torch.testing.assert_close(r_f.pos, r_p.pos, rtol=0, atol=1e-4)
    # E and F against the plain module at the same positions: the two runs'
    # own energies also differ by |F|·|Δx|
    e_p, f_p = BatchwiseCalculator(plain)(batch.replace(pos=r_f.pos))
    torch.testing.assert_close(r_f.energy, e_p, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(r_f.forces, f_p, rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + BUCKET_SHAPES)
def test_dual_fwd_kernel_matches_plain(card, shape):
    x = _inputs(shape, card)
    args = [x[k] for k in C_ARGS]
    pf.reset_launches()
    got = pf.painn_dual_fwd(*args)
    torch.cuda.synchronize()
    assert pf.LAUNCHES["painn_dual_fwd"] == 1
    _assert_close(got, pf.painn_dual_fwd_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + BUCKET_SHAPES)
def test_dual_bwd_kernel_matches_plain(card, shape):
    x = _inputs(shape, card)
    args = [x[k] for k in D_ARGS]
    pf.reset_launches()
    got = pf.painn_dual_bwd(*args)
    torch.cuda.synchronize()
    assert pf.LAUNCHES["painn_dual_bwd"] == 1
    _assert_close(got, pf.painn_dual_bwd_reference(*args))
    no_gw = pf.painn_dual_bwd(*args, need_gw=False)
    assert no_gw[4] is None and all(torch.equal(p, q) for p, q in zip(no_gw[:4], got[:4]))


@pytest.mark.cuda
def test_dual_bwd_kernel_is_deterministic(card):
    x = _inputs(BUCKET_SHAPES[1], card)
    args = [x[k] for k in D_ARGS]
    first, second = pf.painn_dual_bwd(*args), pf.painn_dual_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_dual_fn_on_card_matches_cpu(card):
    """PaiNNDualFn's outputs and gradients on the card (kernels C and D)
    against the same op on CPU tensors (the plain versions)."""
    x = _inputs(SHAPES[1], card)
    diff = ("phi", "phid", "v", "vd", "w")

    def run(dev):
        leaves = {k: x[k].to(dev).clone().requires_grad_(k in diff) for k in C_ARGS}
        out = pf.painn_dual(*(leaves[k] for k in C_ARGS))
        cots = [x[k].to(dev) for k in ("gds", "gdv", "gdsd", "gdvd")]
        sum((o * c).sum() for o, c in zip(out, cots)).backward()
        return [o.detach().cpu() for o in out] + [leaves[k].grad.cpu() for k in diff]

    _assert_close(run(card), run(torch.device("cpu")))


def _fwd(kernel, x):
    """Kernel A or C and its plain version on the inputs x."""
    names, fn, ref = ((A_ARGS, pf.painn_fwd, pf.painn_message_reference) if kernel == "A"
                      else (C_ARGS, pf.painn_dual_fwd, pf.painn_dual_fwd_reference))
    args = [x[k] for k in names]
    got = fn(*args)
    torch.cuda.synchronize()
    return got, ref(*args), args, fn


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BUCKET_SHAPES)
@pytest.mark.parametrize("kernel", ["A", "C"])
def test_fwd_kernels_repeat_their_bits_at_every_bucket(card, shape, kernel):
    got, ref, args, fn = _fwd(kernel, _inputs(shape, card, seed=7))
    _assert_close(got, ref)
    assert all(torch.equal(p, q) for p, q in zip(got, fn(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["A", "C"])
def test_fwd_kernels_on_dead_receivers_and_molecules(card, kernel):
    """A and C list the live pairs in receiver order (rbf, or in C rbf or
    rbfd, not zero): a molecule with no live pair, one with every pair live,
    a real receiver with no live sender and a pair live through rbfd alone
    (rbf rounds to 0 at the cutoff's edge, its tangent does not), against
    the plain version; the dead receivers' rows are exact zeros. Then a
    batch with no live pair at all."""
    x = {k: t.clone() for k, t in
         _inputs((3, 48, 100, 128), card, seed=4, masks={0: 0.0, 1: 1.0}).items()}
    x["rbf"][2, 5] = x["rbfd"][2, 5] = 0.0  # receiver 5 of molecule 2: no live sender
    x["rbf"][2, 1, 2], x["rbfd"][2, 1, 2] = 0.0, 0.05  # the edge pair
    got, ref, args, fn = _fwd(kernel, x)
    _assert_close(got, ref)
    assert all(bool((t[0] == 0).all()) and bool((t[2, 5] == 0).all()) for t in got)
    if kernel == "C":
        x["rbfd"][2, 1, 2] = 0.0
        without = fn(*[x[k] for k in C_ARGS])
        assert torch.equal(without[0], got[0]) and not torch.equal(without[2][2, 1], got[2][2, 1])
    x["rbf"].zero_()
    x["rbfd"].zero_()
    got, ref, _, _ = _fwd(kernel, x)
    assert all(float(t.abs().max()) == 0 for t in got)
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 9, 13, 30), (2, 9, 13, 300)], ids=["f30", "f300"])
@pytest.mark.parametrize("kernel", ["A", "C"])
def test_fwd_kernels_pad_r_and_f(card, kernel, shape):
    """R and 3F off multiples of 4: the wrapper pads them with zeros for the
    engine, and the outputs keep the caller's shapes; F=300 runs the stage's
    1024-thread instance."""
    got, ref, _, _ = _fwd(kernel, _inputs(shape, card, seed=5))
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in ref]
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["A", "C"])
def test_fwd_products_run_on_the_engine(card, kernel):
    """A's and C's radial products run on the SO(2) engine (so2_mma_kernel)
    over the receiver-order list (so2_list_kernel, no pair-row map), then
    their per-receiver stages; the CUDA-core bodies they replaced are gone."""
    from torch.profiler import ProfilerActivity, profile

    x = _inputs(BUCKET_SHAPES[0], card)
    fn, names = (pf.painn_fwd, A_ARGS) if kernel == "A" else (pf.painn_dual_fwd, C_ARGS)
    args = [x[k] for k in names]
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    stage = "painn_fwd_stage_kernel" if kernel == "A" else "painn_dual_fwd_stage_kernel"
    for want in ("so2_mma_kernel", "so2_list_kernel", stage):
        assert any(want in n for n in names), (want, names)
    for gone in ("painn_fwd_kernel", "painn_dual_fwd_kernel", "so2_pair_rows_kernel"):
        assert not any(gone in n for n in names), (gone, names)


@pytest.mark.cuda
def test_pallas_train_step_on_card_matches_plain_direct(card):
    """One train step's parameter gradients: kernels A-D (force_grads
    "pallas") against the plain module's double backward (force_grads
    "direct"), on the card, same weights and batch. Tolerance as the CPU
    parity tests of the surrogate (rtol 5e-3, atol 1e-5)."""
    import numpy as np

    from nabladft_tpu_torch.data.batch import MolBatch
    from nabladft_tpu_torch.data.synthetic import random_molecule
    from nabladft_tpu_torch.models import create_model
    from nabladft_tpu_torch.train import Trainer, TrainerConfig, seeded_generator

    rng = np.random.default_rng(1)
    b, a = 4, 20
    z, pos = np.zeros((b, a), np.int32), np.zeros((b, a, 3), np.float32)
    mask = np.zeros((b, a), bool)
    for i, n in enumerate([20, 13, 7, 17]):
        zi, pi = random_molecule(rng, n)
        z[i, :n], pos[i, :n], mask[i, :n] = zi, pi, True
    batch = MolBatch(z=torch.from_numpy(z), pos=torch.from_numpy(pos),
                     node_mask=torch.from_numpy(mask), graph_mask=torch.ones(b, dtype=torch.bool),
                     energy=torch.from_numpy(rng.normal(size=b).astype(np.float32)),
                     forces=torch.from_numpy(rng.normal(size=(b, a, 3)).astype(np.float32)
                                             * mask[..., None]),
                     mol_id=torch.arange(b, dtype=torch.int32)).to(card)
    kw = dict(hidden=32, n_interactions=2, n_rbf=20, max_neighbors=9)
    grads = {}
    for mode, route in (("fused", "pallas"), ("off", "direct")):
        model = create_model("painn", device=card, generator=seeded_generator(1),
                             use_pallas=mode, **kw)
        Trainer(model, card, TrainerConfig(force_grads=route))._compute_grads(batch)
        grads[route] = {n: p.grad for n, p in model.named_parameters()}
    for n, g in grads["direct"].items():
        torch.testing.assert_close(grads["pallas"][n], g, rtol=5e-3, atol=1e-5, msg=n)


# ---------------------------------------------------------------------------
# SchNet: kernels E, F, G, H
# ---------------------------------------------------------------------------

# (B, A, R, F): odd atom counts, a partial 128-lane channel chunk (F=160),
# basis sizes not a multiple of 4, and the bucket shapes
SCHNET_SHAPES = [(4, 8, 12, 16), (3, 10, 13, 160), (2, 33, 100, 128), (1, 62, 100, 128)]
E_ARGS = ("rbf", "envf", "xin", "w1", "b1", "w2", "b2")
F_ARGS = ("rbf", "rbfp", "envf", "envp", "xin", "w1", "b1", "w2", "b2", "gmsg")
G_ARGS = ("rbf", "rbfd", "envf", "envfd", "xin", "xind", "w1", "b1", "w2", "b2")
H_ARGS = G_ARGS + ("gmsg", "gmsgd")


def _schnet_inputs(shape, dev, seed=0):
    """As the model builds them: padded atoms, pairs live within the cutoff
    minus ~30 %; rbf NOT masked, the cosine cutoff and its derivative zero
    off the live pairs; tangents rbfd = rbfp ⊙ ṫ, envfd = envp ⊙ ṫ."""
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
    return {k: t.to(dev).contiguous() for k, t in x.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCHNET_SHAPES + BUCKET_SHAPES)
def test_schnet_fwd_kernel_matches_plain(card, shape):
    from nabladft_tpu_torch.ops import schnet_fused as sf

    args = [_schnet_inputs(shape, card)[k] for k in E_ARGS]
    sf.reset_launches()
    got = sf.schnet_fwd(*args)
    torch.cuda.synchronize()
    assert sf.LAUNCHES["schnet_fwd"] == 1
    _assert_close([got], [sf.schnet_message_reference(*args)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCHNET_SHAPES + BUCKET_SHAPES)
@pytest.mark.parametrize("need_gw", [True, False])
def test_schnet_bwd_kernel_matches_plain(card, shape, need_gw):
    from nabladft_tpu_torch.ops import schnet_fused as sf

    x = _schnet_inputs(shape, card)
    args = [x[k] for k in F_ARGS]
    sf.reset_launches()
    got = sf.schnet_bwd(*args, need_gw=need_gw)
    torch.cuda.synchronize()
    assert (sf.LAUNCHES["schnet_bwd"], sf.LAUNCHES["schnet_bwd_gw"]) == (1, int(need_gw))
    ref = sf.schnet_message_bwd_reference(*args, need_gw=need_gw)
    if not need_gw:
        assert got[2:] == (None,) * 4
        got, ref = got[:2], ref[:2]
    _assert_close(got, ref)
    dead = (x["envf"] == 0) & (x["envp"] == 0)
    assert dead.any() and (got[0][dead] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCHNET_SHAPES + BUCKET_SHAPES)
def test_schnet_dual_fwd_kernel_matches_plain(card, shape):
    from nabladft_tpu_torch.ops import schnet_fused as sf

    args = [_schnet_inputs(shape, card)[k] for k in G_ARGS]
    sf.reset_launches()
    got = sf.schnet_dual_fwd(*args)
    torch.cuda.synchronize()
    assert sf.LAUNCHES["schnet_dual_fwd"] == 1
    _assert_close(got, sf.schnet_dual_fwd_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCHNET_SHAPES + BUCKET_SHAPES)
def test_schnet_dual_bwd_kernel_matches_plain(card, shape):
    from nabladft_tpu_torch.ops import schnet_fused as sf

    args = [_schnet_inputs(shape, card)[k] for k in H_ARGS]
    sf.reset_launches()
    got = sf.schnet_dual_bwd(*args)
    torch.cuda.synchronize()
    assert sf.LAUNCHES["schnet_dual_bwd"] == 1
    _assert_close(got, sf.schnet_dual_bwd_reference(*args))
    no_gw = sf.schnet_dual_bwd(*args, need_gw=False)
    assert no_gw[2:] == (None,) * 4 and all(torch.equal(p, q) for p, q in zip(no_gw[:2], got))


@pytest.mark.cuda
def test_schnet_bwd_kernels_are_deterministic(card):
    from nabladft_tpu_torch.ops import schnet_fused as sf

    x = _schnet_inputs(BUCKET_SHAPES[1], card)
    for fn, names in ((sf.schnet_dual_bwd, H_ARGS), (sf.schnet_bwd, F_ARGS)):
        args = [x[k] for k in names]
        first, second = fn(*args), fn(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_schnet_wrappers_raise_on_bad_card_inputs(card):
    from nabladft_tpu_torch.ops import schnet_fused as sf

    args = [_schnet_inputs(SCHNET_SHAPES[0], card)[k] for k in E_ARGS]
    with pytest.raises(ValueError, match="contiguous"):
        sf.schnet_fwd(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="on cpu"):
        sf.schnet_fwd(args[0], args[1].cpu(), *args[2:])
    # more channels than a stage's block has threads: refused at launch, raised
    wide = [_schnet_inputs((1, 8, 12, 1028), card)[k] for k in E_ARGS]
    with pytest.raises(RuntimeError, match="schnet_fwd launch failed"):
        sf.schnet_fwd(*wide)


@pytest.mark.cuda
def test_schnet_fns_on_card_match_cpu(card):
    """SchNetMessageFn's and SchNetDualFn's outputs and gradients on the card
    (kernels E-H) against the same ops on CPU tensors (the plain versions)."""
    from nabladft_tpu_torch.ops import schnet_fused as sf

    x = _schnet_inputs(SCHNET_SHAPES[1], card)
    x["dist"] = torch.rand_like(x["envf"])
    w = ("w1", "b1", "w2", "b2")

    def run(dev):
        leaves = {k: v.to(dev).clone().requires_grad_(k in ("dist", "xin", "xind") + w)
                  for k, v in x.items()}
        msg = sf.schnet_message(*(leaves[k] for k in ("dist",) + F_ARGS[:-1]))
        out = sf.schnet_dual(*(leaves[k] for k in G_ARGS))
        loss = (msg * x["gmsg"].to(dev)).sum() + sum(
            (o * x[c].to(dev)).sum() for o, c in zip(out, ("gmsg", "gmsgd")))
        loss.backward()
        return ([msg.detach().cpu()] + [o.detach().cpu() for o in out]
                + [leaves[k].grad.cpu() for k in ("dist", "xin", "xind") + w])

    _assert_close(run(card), run(torch.device("cpu")))


def _schnet_batch(seed):
    import numpy as np

    from nabladft_tpu_torch.data.batch import MolBatch
    from nabladft_tpu_torch.data.synthetic import random_molecule

    rng = np.random.default_rng(seed)
    b, a = 4, 20
    z, pos = np.zeros((b, a), np.int32), np.zeros((b, a, 3), np.float32)
    mask = np.zeros((b, a), bool)
    for i, n in enumerate([20, 13, 7, 17]):
        zi, pi = random_molecule(rng, n)
        z[i, :n], pos[i, :n], mask[i, :n] = zi, pi, True
    return MolBatch(z=torch.from_numpy(z), pos=torch.from_numpy(pos),
                    node_mask=torch.from_numpy(mask), graph_mask=torch.ones(b, dtype=torch.bool),
                    energy=torch.from_numpy(rng.normal(size=b).astype(np.float32)),
                    forces=torch.from_numpy(rng.normal(size=(b, a, 3)).astype(np.float32)
                                            * mask[..., None]),
                    mol_id=torch.arange(b, dtype=torch.int32))


SCHNET_KW = dict(hidden=32, n_interactions=2, n_rbf=20, max_neighbors=9)


@pytest.mark.cuda
def test_fused_schnet_on_card_matches_cpu_plain(card):
    from nabladft_tpu_torch.models import create_model, forward
    from nabladft_tpu_torch.train import seeded_generator

    batch = _schnet_batch(0)
    gpu = create_model("schnet", device=card, generator=seeded_generator(1), use_pallas="fused",
                       **SCHNET_KW)
    cpu = create_model("schnet", device="cpu", generator=seeded_generator(1), **SCHNET_KW)
    out_g = forward(gpu, batch.to(card))
    out_c = forward(cpu, batch)
    torch.testing.assert_close(out_g["energy"].cpu(), out_c["energy"], rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(out_g["forces"].cpu(), out_c["forces"], rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
def test_schnet_pallas_train_step_on_card_matches_plain_direct(card):
    """One train step's parameter gradients: kernels E-H (force_grads
    "pallas") against the plain module's double backward ("direct"), on the
    card, same weights and batch (rtol 5e-3, atol 1e-5)."""
    from nabladft_tpu_torch.models import create_model
    from nabladft_tpu_torch.train import Trainer, TrainerConfig, seeded_generator

    batch = _schnet_batch(1).to(card)
    losses = dict(loss_specs={"energy": "mse", "forces": "mse"})
    grads = {}
    for mode, route in (("fused", "pallas"), ("off", "direct")):
        model = create_model("schnet", device=card, generator=seeded_generator(1),
                             use_pallas=mode, **SCHNET_KW)
        Trainer(model, card, TrainerConfig(force_grads=route, **losses))._compute_grads(batch)
        grads[route] = {n: p.grad for n, p in model.named_parameters()}
    for n, g in grads["direct"].items():
        torch.testing.assert_close(grads["pallas"][n], g, rtol=5e-3, atol=1e-5, msg=n)


@pytest.mark.cuda
def test_schnet_shared_memory_fits_two_blocks_per_sm_at_a48(card):
    """The stages' dynamic shared memory: E's per-receiver stage holds the
    receiver's envf row, G's its envf and envfd rows; F's per-sender stage
    its warps' pair sums, H's none. At A=48 and A=64 every stage leaves room
    for as many blocks of 128 threads as an SM runs (16) in its 228 KB."""
    from nabladft_tpu_torch.ops import schnet_fused as sf

    assert sf.smem_bytes("E", 64, 100, 128) == 4 * 64
    assert sf.smem_bytes("G", 64, 100, 128) == 4 * 2 * 64
    assert sf.smem_bytes("F", 64, 100, 128) == 4 * 2 * 128 and sf.smem_bytes("H", 64, 100, 128) == 0
    for k in "EFGH":
        for a in (48, 64):
            assert 16 * sf.smem_bytes(k, a, 100, 128) <= 228 * 1024


def _schnet_bwd(sf, kernel, x, need_gw=True):
    """Kernel F or H and its plain version on the inputs x."""
    names, fn, ref = ((F_ARGS, sf.schnet_bwd, sf.schnet_message_bwd_reference) if kernel == "F"
                      else (H_ARGS, sf.schnet_dual_bwd, sf.schnet_dual_bwd_reference))
    args = [x[k] for k in names]
    return fn(*args, need_gw=need_gw), ref(*args, need_gw=need_gw), args, fn


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["F", "H"])
@pytest.mark.parametrize("need_gw", [True, False])
def test_schnet_bwd_kernels_on_dead_molecules_and_edge_pairs(card, kernel, need_gw):
    """A molecule with no live pair, a sender with no live receiver and a
    pair live only through the second envelope lane (envp in F, envfd in H:
    envf zero at the cutoff's edge), against the plain version; F's dead
    slots hold exact zeros. Then a batch with no live pair at all."""
    from nabladft_tpu_torch.ops import schnet_fused as sf

    x = {k: v.clone() for k, v in _schnet_inputs((3, 20, 100, 128), card, seed=3).items()}
    for k in ("envf", "envp", "envfd"):
        x[k][1] = 0.0
        x[k][0, :, 4] = 0.0
    x["envf"][2, 1, 2] = 0.0  # the edge pair: envp and envfd stay
    x["envp"][2, 1, 2] = x["envfd"][2, 1, 2] = -0.04
    got, ref, _, _ = _schnet_bwd(sf, kernel, x, need_gw)
    n = 6 if need_gw else 2
    _assert_close(got[:n], ref[:n])
    if kernel == "F":
        assert (got[0][1] == 0).all() and (got[0][0, :, 4] == 0).all() and got[0][2, 1, 2] != 0
    for k in ("envf", "envp", "envfd"):
        x[k].zero_()
    got, ref, _, _ = _schnet_bwd(sf, kernel, x, need_gw)
    assert all(float(t.abs().max()) == 0 for t in got[:2])
    _assert_close(got[:n], ref[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BUCKET_SHAPES)
@pytest.mark.parametrize("kernel,need_gw", [("F", True), ("F", False), ("H", True)])
def test_schnet_bwd_kernels_repeat_their_bits_at_every_bucket(card, shape, kernel, need_gw):
    from nabladft_tpu_torch.ops import schnet_fused as sf

    got, ref, args, fn = _schnet_bwd(sf, kernel, _schnet_inputs(shape, card, seed=7), need_gw)
    n = 6 if need_gw else 2
    _assert_close(got[:n], ref[:n])
    again = fn(*args, need_gw=need_gw)
    assert all(torch.equal(p, q) for p, q in zip(got[:n], again[:n]))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["F", "H"])
def test_schnet_bwd_kernels_pad_r_and_f(card, kernel):
    """R and F off multiples of 4: the wrapper pads them with zeros for the
    engine, and the outputs keep the caller's shapes."""
    from nabladft_tpu_torch.ops import schnet_fused as sf

    got, ref, _, _ = _schnet_bwd(sf, kernel, _schnet_inputs((2, 9, 13, 30), card, seed=5))
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in ref]
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["F", "H"])
def test_schnet_bwd_products_run_on_the_engine(card, kernel):
    """F's and H's filter-MLP products and weight gradients run on the SO(2)
    engine (so2_mma_kernel, so2_mmw_kernel) around their CUDA-core stages."""
    from torch.profiler import ProfilerActivity, profile

    from nabladft_tpu_torch.ops import schnet_fused as sf

    x = _schnet_inputs(BUCKET_SHAPES[0], card)
    _schnet_bwd(sf, kernel, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _schnet_bwd(sf, kernel, x)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    stage = "schnet_bwd_stage_kernel" if kernel == "F" else "schnet_dual_bwd_stage_kernel"
    for want in ("so2_mma_kernel", "so2_mmw_kernel", "so2_list_kernel", stage):
        assert any(want in n for n in names), (want, names)


def _schnet_fwd(sf, kernel, x):
    """Kernel E or G and its plain version on the inputs x, as tuples."""
    names, fn, ref = ((E_ARGS, sf.schnet_fwd, sf.schnet_message_reference) if kernel == "E"
                      else (G_ARGS, sf.schnet_dual_fwd, sf.schnet_dual_fwd_reference))
    args = [x[k] for k in names]
    tup = lambda t: t if isinstance(t, tuple) else (t,)  # noqa: E731
    got = tup(fn(*args))
    torch.cuda.synchronize()
    return got, tup(ref(*args)), args, lambda *a: tup(fn(*a))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BUCKET_SHAPES)
@pytest.mark.parametrize("kernel", ["E", "G"])
def test_schnet_fwd_kernels_repeat_their_bits_at_every_bucket(card, shape, kernel):
    from nabladft_tpu_torch.ops import schnet_fused as sf

    got, ref, args, fn = _schnet_fwd(sf, kernel, _schnet_inputs(shape, card, seed=7))
    _assert_close(got, ref)
    assert all(torch.equal(p, q) for p, q in zip(got, fn(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["E", "G"])
def test_schnet_fwd_kernels_on_dead_receivers_and_molecules(card, kernel):
    """E and G list the live pairs in receiver order (envf, or in G envf or
    envfd, not zero): a molecule with no live pair, a real receiver with no
    live sender and a pair live through envfd alone (envf zero at the
    cutoff's edge), against the plain version; the dead receivers' rows are
    exact zeros. Without the edge pair G's msg keeps its bits and msgd of
    its receiver moves. Then a batch with no live pair at all."""
    from nabladft_tpu_torch.ops import schnet_fused as sf

    x = {k: v.clone() for k, v in _schnet_inputs((3, 48, 100, 128), card, seed=4).items()}
    for k in ("envf", "envfd"):
        x[k][0] = 0.0
        x[k][2, 5] = 0.0  # receiver 5 of molecule 2: no live sender
    x["envf"][2, 1, 2], x["envfd"][2, 1, 2] = 0.0, -0.04  # the edge pair
    got, ref, _, fn = _schnet_fwd(sf, kernel, x)
    _assert_close(got, ref)
    assert all(bool((t[0] == 0).all()) and bool((t[2, 5] == 0).all()) for t in got)
    if kernel == "G":
        x["envfd"][2, 1, 2] = 0.0
        without = fn(*[x[k] for k in G_ARGS])
        assert torch.equal(without[0], got[0]) and not torch.equal(without[1][2, 1], got[1][2, 1])
    for k in ("envf", "envfd"):
        x[k].zero_()
    got, ref, _, _ = _schnet_fwd(sf, kernel, x)
    assert all(float(t.abs().max()) == 0 for t in got)
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 9, 13, 30), (2, 9, 50, 300)], ids=["f30", "f300"])
@pytest.mark.parametrize("kernel", ["E", "G"])
def test_schnet_fwd_kernels_pad_r_and_f(card, kernel, shape):
    """R and F off multiples of 4: the wrapper pads them with zeros for the
    engine, and the outputs keep the caller's shapes; F=300 runs the stage's
    1024-thread instance."""
    from nabladft_tpu_torch.ops import schnet_fused as sf

    got, ref, _, _ = _schnet_fwd(sf, kernel, _schnet_inputs(shape, card, seed=5))
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in ref]
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["E", "G"])
def test_schnet_fwd_products_run_on_the_engine(card, kernel):
    """E's and G's filter-MLP products run on the SO(2) engine
    (so2_mma_kernel) over the receiver-order list (so2_list_kernel, no
    pair-row map), then their per-receiver stages; the CUDA-core bodies they
    replaced are gone."""
    from torch.profiler import ProfilerActivity, profile

    from nabladft_tpu_torch.ops import schnet_fused as sf

    x = _schnet_inputs(BUCKET_SHAPES[0], card)
    _schnet_fwd(sf, kernel, x)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _schnet_fwd(sf, kernel, x)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    stage = "schnet_fwd_stage_kernel" if kernel == "E" else "schnet_dual_fwd_stage_kernel"
    for want in ("so2_mma_kernel", "so2_list_kernel", "schnet_ssp_kernel", stage):
        assert any(want in n for n in names), (want, names)
    for gone in ("schnet_fwd_kernel", "schnet_dual_fwd_kernel", "so2_pair_rows_kernel"):
        assert not any(gone in n for n in names), (gone, names)
