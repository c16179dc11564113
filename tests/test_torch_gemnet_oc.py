"""The port's GemNet-OC against the JAX package on the CPU.

Small widths (2 blocks, emb 16 / 32, K 7 / 4, as
tests/models/test_gemnet_scales.py) on a padded batch of 4 × 9 atoms, the
JAX init's weights carried across with `load_flax_params`, every scale
factor × 1.37 (as tests/models/test_gemnet_factored.py) so both readers
of `scale_cbf_basis` are exercised:
* `gather_neighbor_edges` and `triplet_angles` on the same neighbour list;
* E and F of the factorised path against `model.apply`, with and without
  coupled forces and quadruplets (rtol 1e-4, atol 1e-5);
* the fitting path (explicit triplet lattice) against `apply(...,
  mutable=["scale_stats"])`: E, F and every scale's statistics pair;
* `fit_scale_factors` over two batches and two rounds against JAX's;
* the loss's gradients with respect to the parameters and the scales
  against `jax.grad` over the whole variables (1e-4 of each tensor's max);
* the whole tree loads, float16 raises, a neighbour tie keeps the lower
  indices;
* `Trainer.fit` with a one-batch scale fit and two clipped AdamW steps
  against the JAX Trainer: parameters, scales (frozen at the fitted
  values), and the loader's epoch counter; in bf16 the port's job with
  its fit within 5e-4 of the JAX Trainer's fit (below JAX's
  bf16-vs-float32 gap).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.data import DataModule as JaxDataModule, EnergyDataset as JaxEnergyDataset
from nabladft_tpu.data.batch import MolBatch as JaxBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models.gemnet_oc import fit_scale_factors as jax_fit_scale_factors
from nabladft_tpu.ops import graph as jax_graph
from nabladft_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from nabladft_tpu.train.losses import multitask_loss as jax_multitask_loss
from nabladft_tpu.train.state import TrainState as JaxTrainState
from nabladft_tpu_torch.data import DataModule, EnergyDataset
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.data.synthetic import write_random_db
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models.convert import flax_params_of, load_flax_params
from nabladft_tpu_torch.models.gemnet_oc import fit_scale_factors
from nabladft_tpu_torch.ops import graph
from nabladft_tpu_torch.train import Trainer, TrainerConfig
from nabladft_tpu_torch.train.loggers import Logger
from nabladft_tpu_torch.train.losses import multitask_loss


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(num_blocks=2, emb_size_atom=16, emb_size_edge=32, emb_size_trip_in=8,
          emb_size_trip_out=8, emb_size_quad_in=8, emb_size_quad_out=8, emb_size_rbf=8,
          emb_size_cbf=8, emb_size_sbf=8, num_radial=16, num_spherical=4,
          num_spherical_quad=3, max_neighbors=7, max_neighbors_qint=4)
TOL = dict(rtol=1e-4, atol=1e-5)
LOSS = dict(loss_specs={"energy": "l1", "forces": "l2norm"},
            loss_coefs={"energy": 1.0, "forces": 100.0})
SCALE = 1.37
# the bf16 scale fit against JAX's, relative (<= 1.4e-4 seen)
BF16_FIT_REL = 5e-4


def _arrays(seed=0, b=4, a=9):
    rng = np.random.default_rng(seed)
    z = rng.integers(1, 9, (b, a)).astype(np.int32)
    pos = rng.uniform(-3, 3, (b, a, 3)).astype(np.float32)
    mask = np.ones((b, a), bool)
    mask[0, -3:] = False
    mask[1, -1:] = False
    z[~mask], pos[~mask] = 0, 0.0
    graph_mask = np.ones((b,), bool)
    return dict(z=z, pos=pos, node_mask=mask, graph_mask=graph_mask,
                energy=rng.normal(size=b).astype(np.float32),
                forces=(rng.normal(size=(b, a, 3)) * mask[..., None]).astype(np.float32),
                mol_id=np.arange(b, dtype=np.int32))


def _tb(arrs):
    return MolBatch(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()})


def _port(variables, **kw):
    return load_flax_params(create_model("gemnet_oc", device="cpu", **dict(KW, **kw)), variables)


def _without_quadruplets(variables):
    """The variables of the same model with quad_interaction=False."""
    return {c: {k: v for k, v in tree.items() if not k.startswith("quad_")}
            for c, tree in variables.items()}


@pytest.fixture(scope="module")
def arrays():
    return _arrays()


@pytest.fixture(scope="module")
def jax_ref(arrays):
    """The default model's variables (the port's seeded weights as the flax
    tree; `shapes`, JAX's `model.init` evaluated abstractly, holds its
    structure), its fitting-path outputs and statistics and the loss's
    gradients. The applies run eagerly: at these sizes that is faster than
    compiling each program (`fit_scale_factors` applies eagerly in any
    case)."""
    model = jax_create_model("gemnet_oc", **KW, remat=False)
    batch = JaxBatch(**arrays)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), batch)
    variables = flax_params_of(create_model("gemnet_oc", device="cpu",
                                            generator=torch.Generator().manual_seed(0), **KW))
    variables = {**variables,
                 "scales": jax.tree_util.tree_map(lambda s: s * SCALE, variables["scales"])}
    out_fit, mut = model.apply(variables, batch, mutable=["scale_stats"])

    def loss(v):
        return jax_multitask_loss(model.apply(v, batch), batch, **LOSS)["total"]

    grads = jax.jit(jax.grad(loss))(variables)
    stats = {".".join(p.key for p in path): np.asarray(v) for path, v in
             jax.tree_util.tree_flatten_with_path(jax.device_get(mut["scale_stats"]))[0]}
    return dict(variables=variables, out_fit=jax.device_get(out_fit), stats=stats,
                grads=jax.device_get(grads),
                shapes={c: shapes[c] for c in ("params", "scales")})


def test_triplet_gather_and_angles_match_jax(arrays):
    pos, mask = arrays["pos"], arrays["node_mask"]
    nl_j = jax_graph.neighbor_list(pos, mask, 12.0, 7)
    nl = graph.neighbor_list(torch.from_numpy(pos), torch.from_numpy(mask), 12.0, 7)
    np.testing.assert_array_equal(nl.idx.numpy(), np.asarray(nl_j.idx))
    np.testing.assert_array_equal(nl.mask.numpy(), np.asarray(nl_j.mask))
    feat = np.random.default_rng(1).normal(size=(*nl.idx.shape, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        graph.gather_neighbor_edges(torch.from_numpy(feat), nl.idx).numpy(),
        np.asarray(jax_graph.gather_neighbor_edges(feat, nl_j.idx)))
    cos, trip_mask = graph.triplet_angles(nl)
    cos_j, trip_mask_j = jax_graph.triplet_angles(nl_j)
    np.testing.assert_array_equal(trip_mask.numpy(), np.asarray(trip_mask_j))
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_j), rtol=0, atol=1e-6)
    assert trip_mask.any() and not trip_mask.all()


@pytest.mark.parametrize("forces_coupled,quad_interaction",
                         [(True, True), (False, True), (True, False), (False, False)])
def test_energy_and_forces_match_jax(arrays, jax_ref, forces_coupled, quad_interaction):
    kw = dict(forces_coupled=forces_coupled, quad_interaction=quad_interaction)
    model = jax_create_model("gemnet_oc", **KW, **kw, remat=False)
    variables = jax_ref["variables"]
    if not quad_interaction:
        variables = _without_quadruplets(variables)
    want = jax.device_get(model.apply(variables, JaxBatch(**arrays)))
    with torch.no_grad():
        got = _port(variables, **kw)(_tb(arrays))
    for k in ("energy", "forces"):
        np.testing.assert_allclose(got[k].numpy(), want[k], **TOL, err_msg=k)
    assert np.all(got["forces"].numpy()[~arrays["node_mask"]] == 0.0)


def test_fitting_path_and_its_statistics_match_jax(arrays, jax_ref):
    model = _port(jax_ref["variables"])
    stats = {}
    with torch.no_grad():
        out = model(_tb(arrays), stats=stats)
        factorised = model(_tb(arrays))
    for k in ("energy", "forces"):
        np.testing.assert_allclose(out[k].numpy(), jax_ref["out_fit"][k], **TOL, err_msg=k)
        # the two triplet paths, as tests/models/test_gemnet_factored.py holds them
        np.testing.assert_allclose(factorised[k].numpy(), out[k].numpy(), rtol=2e-4, atol=2e-5)
    assert sorted(stats) == sorted(jax_ref["stats"]) == sorted(model.scale_factors())
    for name, pair in jax_ref["stats"].items():
        np.testing.assert_allclose(stats[name].numpy(), pair, rtol=1e-4, atol=1e-9,
                                   err_msg=name)


def test_fit_scale_factors_matches_jax(jax_ref):
    model = jax_create_model("gemnet_oc", **KW, remat=False)
    arrs = [_arrays(seed=2), _arrays(seed=3)]
    want = jax.device_get(jax_fit_scale_factors(model, jax_ref["variables"],
                                                [JaxBatch(**a) for a in arrs], rounds=2))
    port = fit_scale_factors(_port(jax_ref["variables"]), [_tb(a) for a in arrs], rounds=2)
    fitted = {n: p.item() for n, p in port.scale_factors().items()}
    flat = jax.tree_util.tree_flatten_with_path(want["scales"])[0]
    assert len(flat) == len(fitted)
    for path, v in flat:
        name = ".".join(p.key for p in path)
        assert fitted[name] == pytest.approx(float(v), rel=1e-4), name
        assert fitted[name] != pytest.approx(SCALE, rel=1e-3), name


def test_loss_gradients_of_params_and_scales_match_jax(arrays, jax_ref):
    model = _port(jax_ref["variables"])
    batch = _tb(arrays)
    multitask_loss(model(batch), batch, **LOSS)["total"].backward()
    twin = _port(jax_ref["grads"])
    want = dict(twin.named_parameters())
    scales = model.scale_factors()
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)
        assert np.abs(w).max() > 0.0 or name in scales, name
    assert any(float(scales[n].grad) != 0.0 for n in scales)


def test_the_whole_tree_loads_with_no_leaf_left(jax_ref):
    """JAX's init tree (its structure and shapes) is the port's, and every
    leaf of it loads."""
    shape_of = lambda tree: jax.tree_util.tree_map(lambda x: tuple(np.shape(x)), tree)  # noqa: E731
    assert shape_of({c: jax_ref["variables"][c] for c in ("params", "scales")}) == shape_of(
        jax_ref["shapes"])
    model = _port(jax_ref["variables"])
    n_leaves = sum(len(jax.tree_util.tree_leaves(jax_ref["shapes"][c]))
                   for c in ("params", "scales"))
    assert n_leaves == len(list(model.parameters()))
    assert all(s.item() == pytest.approx(SCALE) for s in model.scale_factors().values())
    bad = copy.deepcopy(jax_ref["variables"])
    bad["scales"]["unused"] = np.ones((), np.float32)
    with pytest.raises(KeyError, match="unused"):
        _port(bad)


def test_bf16_raises():
    """bf16 is ported (tests/test_torch_zoo_bf16.py); a dtype the port does
    not take still raises, naming the ones it does."""
    with pytest.raises(NotImplementedError, match="float32, bfloat16"):
        create_model("gemnet_oc", device="cpu", compute_dtype="float16", **KW)


def test_a_neighbour_tie_keeps_the_lower_indices(jax_ref):
    """Atom 0 of molecule 2 at the origin and its eight other atoms at
    distance 1: with K = 7 it keeps atoms 1-7, as lax.top_k does, and E and
    F equal JAX's (the batch's shapes are the fixture's)."""
    arrs = _arrays()
    u = np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                  [0.6, 0.8, 0], [0, 0.6, -0.8]], np.float32)
    arrs["pos"][2] = np.concatenate([np.zeros((1, 3), np.float32), u])
    nl = graph.neighbor_list(torch.from_numpy(arrs["pos"]), torch.from_numpy(arrs["node_mask"]),
                             12.0, 7)
    assert nl.idx[2, 0].tolist() == [1, 2, 3, 4, 5, 6, 7]
    model = jax_create_model("gemnet_oc", **KW, remat=False)
    want = jax.device_get(model.apply(jax_ref["variables"], JaxBatch(**arrs)))
    with torch.no_grad():
        got = _port(jax_ref["variables"])(_tb(arrs))
    for k in ("energy", "forces"):
        np.testing.assert_allclose(got[k].numpy(), want[k], **TOL, err_msg=k)


class _Logged(Logger):
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append(dict(metrics))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_fits_freezes_and_steps_as_jax(tmp_path, jax_ref, dtype):
    """One fit batch, two AdamW steps clipped at 0.5, against the JAX
    Trainer on the same DB, split and batches. In bf16 the port's trainer
    runs the same job and its fit is held against the JAX Trainer's fit
    (`fit_scale_factors` over its first scale_fit_batches batches, the same
    call in bf16), within BF16_FIT_REL, below JAX's own bf16-vs-float32 gap
    of that fit; JAX's bf16 train steps are not compiled there."""
    db = write_random_db(tmp_path / "in.db", n_mols=12, min_atoms=4, max_atoms=9, seed=5)
    cfg = dict(max_epochs=1, max_steps=2, optimizer="adamw", lr=1e-3, weight_decay=0.01,
               grad_clip=0.5, schedule="constant", scale_fit_batches=1, log_every_n_steps=1,
               **LOSS)
    dm_kw = dict(batch_size=4, val_fraction=0.25, seed=1)
    jdm = JaxDataModule(JaxEnergyDataset(str(db), bucket_boundaries=(9,)), **dm_kw)
    dm = DataModule(EnergyDataset(str(db), bucket_boundaries=(9,)), **dm_kw)
    params0 = jax_ref["variables"]
    jax_loader = jdm.train_dataloader()
    if dtype == "float32":
        jt = JaxTrainer(jax_create_model("gemnet_oc", **KW, remat=False),
                        JaxConfig(n_dp=1, **cfg))
        jt.state = JaxTrainState.create(params0, jt.tx)  # fit then takes no batch for an init
        jdm.train_dataloader = lambda: jax_loader
        jt.fit(jdm)
        assert jax_loader._epoch == 2
        want = dict(_port(jax.device_get(jt.state.params)).named_parameters())
    else:
        first = [next(iter(jax_loader))]
        jax_fit = {dt: dict(_port(jax_fit_scale_factors(
            jax_create_model("gemnet_oc", **KW, remat=False, compute_dtype=dt), params0,
            first)).scale_factors()) for dt in ("float32", "bfloat16")}

    model = _port(params0, compute_dtype=dtype)
    logged = _Logged()
    trainer = Trainer(model, "cpu", TrainerConfig(**cfg), loggers=logged)
    assert not any(p is s for g in trainer.optimizer.param_groups for p in g["params"]
                   for s in model.scale_factors().values())
    train_loader = dm.train_dataloader()
    dm.train_dataloader = lambda: train_loader
    trainer.fit(dm)
    assert trainer.step == 2
    norms = [m["grad_norm"] for m in logged.rows if "grad_norm" in m]
    assert len(norms) == 2 and min(norms) > cfg["grad_clip"]  # the clip acted
    assert train_loader._epoch == 2
    # the scales hold the values a fit of the first batch of epoch 0 gives
    refit = _port(params0, compute_dtype=dtype)
    train_loader._epoch = 0
    fit_scale_factors(refit, [next(iter(train_loader))])
    scales = model.scale_factors()
    for name, s in refit.scale_factors().items():
        assert scales[name].item() == s.item(), name
        assert s.item() != pytest.approx(SCALE, rel=1e-3), name
    if dtype == "float32":
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
        return
    # bf16: the fit (float32 variances of bf16 activations) against JAX's
    f16, f32 = jax_fit["bfloat16"], jax_fit["float32"]
    rel = {n: abs(scales[n].item() / f16[n].item() - 1.0) for n in scales}
    gap = {n: abs(f16[n].item() / f32[n].item() - 1.0) for n in f16}
    assert scales.keys() == f16.keys()
    assert max(rel.values()) <= BF16_FIT_REL < max(gap.values()), (rel, gap)
