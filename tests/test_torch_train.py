"""The port's trainer against the JAX engine on the same weights and batches.

* One train step's parameter gradients: the port's `pallas` route (kernels
  A/B in the force pass, C/D in the dual pass, their plain versions on the
  CPU) and its `surrogate` and `direct` routes against JAX
  `Trainer._surrogate_grads` with force_grads="pallas" (Pallas kernels in
  interpret mode). JAX's gradient tree is read into a twin module with
  `load_flax_params`. Tolerance as tests/train/test_surrogate_grads.py
  (rtol 5e-3, atol 1e-5); losses within rel 1e-4 as
  tests/train/test_engine.py.
* Two AdamW steps with weight decay (rank ≥ 2 only) and a global-norm clip
  that triggers, against JAX's parameters after the same two steps.
* The plateau state, the checkpoint layout and a resume round trip, the
  non-finite skip guard, EMA evaluation, keep-best / restore-best, and a toy
  overfit (as test_overfit_energy).
JAX reference trainers use n_dp=1 (one device), as tests/train do.
"""

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.parallel.mesh import replicated
from nabladft_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from nabladft_tpu.train.schedulers import PlateauState as JaxPlateau
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models.convert import load_flax_params
from nabladft_tpu_torch.train import Trainer, TrainerConfig
from nabladft_tpu_torch.train.schedulers import PlateauState


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(hidden=16, n_interactions=2, n_rbf=8, max_neighbors=7)
GRAD_TOL = dict(rtol=5e-3, atol=1e-5)
LOSSES = dict(loss_specs={"energy": "l1", "forces": "l2norm"},
              loss_coefs={"energy": 1.0, "forces": 2.0})


def _arrays(seed=0, b=4, a=9):
    rng = np.random.default_rng(seed)
    z = rng.integers(1, 9, (b, a)).astype(np.int32)
    pos = rng.uniform(-2, 2, (b, a, 3)).astype(np.float32)
    node_mask = np.ones((b, a), bool)
    node_mask[1, 6:] = False
    node_mask[3, 4:] = False
    z[~node_mask] = 0
    pos[~node_mask] = 0.0
    graph_mask = np.ones((b,), bool)
    graph_mask[3] = False  # a padding molecule
    forces = (rng.normal(size=(b, a, 3)) * node_mask[..., None]).astype(np.float32)
    return dict(z=z, pos=pos, node_mask=node_mask, graph_mask=graph_mask,
                energy=rng.normal(size=b).astype(np.float32), forces=forces,
                mol_id=np.arange(b, dtype=np.int32))


def _tb(arrs):
    return MolBatch(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()})


def _port_model(params, mode="off", **kw):
    return load_flax_params(create_model("painn", device="cpu", use_pallas=mode, **(kw or KW)),
                            params)


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def arrays():
    return _arrays()


@pytest.fixture(scope="module")
def jax_surrogate(arrays):
    """JAX pallas-route gradients, losses and initial params on one batch."""
    model = jax_create_model("painn", **KW, remat=False)
    trainer = JaxTrainer(model, JaxConfig(schedule="constant", n_dp=1, force_grads="pallas",
                                          **LOSSES))
    batch = JaxBatch(**arrays)
    trainer.init_state(batch)
    params = jax.device_get(trainer.state.params)
    # jitted once: the interpret-mode kernels run op by op otherwise
    grads, losses, _ = jax.jit(lambda p, b: trainer._surrogate_grads(p, b, None))(
        trainer.state.params, batch)
    twin = _port_model(params)
    load_flax_params(twin, jax.device_get(grads))
    return params, {n: p.detach().clone() for n, p in twin.named_parameters()}, {
        k: float(v) for k, v in losses.items()}


@pytest.mark.parametrize("route,mode", [("pallas", "fused"), ("surrogate", "off"),
                                        ("surrogate", "fused"), ("direct", "off")])
def test_train_step_grads_match_jax_surrogate(arrays, jax_surrogate, route, mode):
    params, g_jax, l_jax = jax_surrogate
    model = _port_model(params, mode)
    trainer = Trainer(model, "cpu", TrainerConfig(schedule="constant", force_grads=route,
                                                  **LOSSES))
    losses = trainer._compute_grads(_tb(arrays))
    for k in ("energy", "forces", "total"):
        assert float(losses[k]) == pytest.approx(l_jax[k], rel=1e-4), k
    for name, g in _grads(model).items():
        np.testing.assert_allclose(g.numpy(), g_jax[name].numpy(), **GRAD_TOL, err_msg=name)


def test_pallas_route_runs_the_dual_kernels_without_b_weight_gradient(
        arrays, jax_surrogate, monkeypatch):
    """Per layer: C and D once each (the dual pass), B once and never with
    its weight-gradient stage (the force pass holds the weights fixed)."""
    from nabladft_tpu_torch.ops import painn_fused as pf

    calls = []
    for name in ("painn_fwd", "painn_bwd", "painn_dual_fwd", "painn_dual_bwd"):
        real = getattr(pf, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("need_gw")))
            return _real(*args, **kw)

        monkeypatch.setattr(pf, name, spy)
    model = _port_model(jax_surrogate[0], "fused")
    Trainer(model, "cpu", TrainerConfig(force_grads="pallas", **LOSSES))._compute_grads(
        _tb(arrays))
    n = KW["n_interactions"]
    assert calls.count(("painn_fwd", None)) == n
    assert calls.count(("painn_bwd", False)) == n
    assert calls.count(("painn_dual_fwd", None)) == n
    assert calls.count(("painn_dual_bwd", True)) == n
    assert len(calls) == 4 * n


def test_direct_route_refuses_the_fused_model(arrays, jax_surrogate):
    model = _port_model(jax_surrogate[0], "fused")
    trainer = Trainer(model, "cpu", TrainerConfig(force_grads="direct", **LOSSES))
    with pytest.raises(ValueError, match="pallas"):
        trainer._compute_grads(_tb(arrays))
    with pytest.raises(ValueError, match="use_pallas='fused'"):
        Trainer(_port_model(jax_surrogate[0]), "cpu", TrainerConfig(force_grads="pallas"))


def test_dual_message_refuses_a_weight_tangent(arrays, jax_surrogate):
    import torch.autograd.forward_ad as fwAD

    from nabladft_tpu_torch.models.painn import _dual_message

    model = _port_model(jax_surrogate[0], "fused")
    batch = _tb(arrays)
    with fwAD.dual_level():
        feats = model.features(batch.replace(pos=fwAD.make_dual(batch.pos,
                                                               torch.ones_like(batch.pos))))
        w = model.layers[0].message.filter_kernel
        w_dual = fwAD.make_dual(w.detach(), torch.ones_like(w))
        phi = torch.zeros(*batch.z.shape, 3 * KW["hidden"])
        with pytest.raises(ValueError, match="filter weights"):
            _dual_message(feats, phi, torch.zeros_like(phi), w_dual)


def test_two_adamw_steps_with_clip_match_jax(arrays):
    cfg = dict(optimizer="adamw", lr=1e-3, weight_decay=0.01, grad_clip=0.5,
               schedule="constant", force_grads="direct", log_every_n_steps=1000, **LOSSES)
    jt = JaxTrainer(jax_create_model("painn", **KW, remat=False), JaxConfig(n_dp=1, **cfg))
    batch = JaxBatch(**arrays)
    jt.init_state(batch)
    jt.state = jax.device_put(jt.state, replicated(jt.mesh))  # one trace of the step
    params0 = jax.device_get(jt.state.params)
    state, jm = jt._jit_train_step(jt.state, batch)
    state, jm2 = jt._jit_train_step(state, batch)
    want = {n: p.detach() for n, p in _port_model(jax.device_get(state.params)).named_parameters()}

    model = _port_model(params0)
    trainer = Trainer(model, "cpu", TrainerConfig(**cfg))
    m1 = trainer._train_step(_tb(arrays))
    m2 = trainer._train_step(_tb(arrays))
    assert float(jm["grad_norm"]) > cfg["grad_clip"]  # the clip triggered
    for m, j in ((m1, jm), (m2, jm2)):
        assert m["grad_norm"] == pytest.approx(float(j["grad_norm"]), rel=1e-4)
        assert float(m["train/total"]) == pytest.approx(float(j["train/total"]), rel=1e-4)
    # two updates of at most lr each: agreement to 1 % of lr absolute
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert trainer.step == 2


def test_plateau_state_matches_jax():
    seq = [1.0, 0.9, 0.95, 0.95, 0.97, 0.8, 0.85, 0.86, 0.87, 0.9]
    ours, ref = PlateauState(patience=1, factor=0.5), JaxPlateau(patience=1, factor=0.5)
    for x in seq:
        assert ours.step(x, 1e-3) == ref.step(x, 1e-3)
        assert (ours.best, ours.bad_epochs, ours.multiplier) == (
            ref.best, ref.bad_epochs, ref.multiplier)


class _Toy:
    def __init__(self, batches):
        self.batches = batches

    def train_dataloader(self):
        return list(self.batches)

    val_dataloader = test_dataloader = predict_dataloader = train_dataloader


def _toy_batches(n=2, b=8, a=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pos = rng.uniform(-2, 2, (b, a, 3)).astype(np.float32)
        d = np.linalg.norm(pos[:, :, None] - pos[:, None, :], axis=-1)
        out.append(_tb(dict(
            z=rng.integers(1, 9, (b, a)).astype(np.int32), pos=pos,
            node_mask=np.ones((b, a), bool), graph_mask=np.ones(b, bool),
            energy=(np.exp(-(d ** 2)).sum((1, 2)) * 0.1).astype(np.float32),
            forces=np.zeros((b, a, 3), np.float32), mol_id=np.arange(b, dtype=np.int32))))
    return out


def _toy_trainer(tmp_path=None, **kw):
    from nabladft_tpu_torch.train import seeded_generator

    model = create_model("painn", device="cpu", generator=seeded_generator(0), hidden=32,
                         n_interactions=2, n_rbf=16, max_neighbors=7)
    cfg = dict(lr=5e-3, schedule="constant", log_every_n_steps=1000,
               loss_specs={"energy": "mse"}, loss_coefs={"energy": 1.0})
    if tmp_path is not None:
        cfg.update(ckpt_dir=str(tmp_path / "ckpt"), save_top_k=2)
    cfg.update(kw)
    return Trainer(model, "cpu", TrainerConfig(**cfg))


def test_overfit_energy():
    dm = _Toy(_toy_batches())
    trainer = _toy_trainer(max_epochs=30)
    first = trainer.validate(dm.val_dataloader())
    final = trainer.fit(dm)
    assert final["val/loss"] < first["val/loss"] * 0.2, (first, final)
    assert trainer.step == 60
    outs = list(trainer.predict(dm.predict_dataloader()))
    assert outs[0]["energy"].shape == (8,) and outs[0]["forces"].shape == (8, 8, 3)


def test_checkpoints_and_resume(tmp_path):
    import json

    dm = _Toy(_toy_batches())
    trainer = _toy_trainer(tmp_path, max_epochs=3, schedule="plateau", plateau_patience=0)
    trainer.fit(dm)
    d = tmp_path / "ckpt"
    index = json.loads((d / "index.json").read_text())
    assert index["last"]["step"] == 6 and len(index["best"]) <= 2
    assert (d / "last.ckpt").exists() and (d / "last.ckpt.aux.json").exists()
    for e in index["best"]:
        assert (d / e["path"]).exists() and (d / (e["path"] + ".aux.json")).exists()
    assert trainer.ckpt.best_path() == d / index["best"][0]["path"]
    aux = trainer.ckpt.read_aux()
    assert aux["plateau"]["multiplier"] == trainer.plateau.multiplier

    resumed = _toy_trainer(tmp_path, max_epochs=3, schedule="plateau", plateau_patience=0)
    resumed.load_checkpoint(d / "last.ckpt", resume=True)
    assert resumed.step == trainer.step
    assert resumed.plateau.multiplier == trainer.plateau.multiplier
    assert resumed.optimizer.param_groups[0]["lr"] == trainer.optimizer.param_groups[0]["lr"]
    for (n, p), (_, q) in zip(resumed.model.named_parameters(), trainer.model.named_parameters()):
        assert torch.equal(p, q), n
    s1 = resumed.optimizer.state_dict()["state"]
    s0 = trainer.optimizer.state_dict()["state"]
    assert all(torch.equal(s1[k]["exp_avg"], s0[k]["exp_avg"]) for k in s0)
    # the next step agrees too
    batch = dm.batches[0]
    assert float(resumed._train_step(batch)["train/total"]) == float(
        trainer._train_step(batch)["train/total"])


def test_nonfinite_step_is_skipped():
    batches = _toy_batches()
    trainer = _toy_trainer()
    trainer._train_step(batches[0])
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    opt_before = {k: v["exp_avg"].clone() for k, v in trainer.optimizer.state_dict()["state"].items()}
    bad = batches[1].replace(energy=torch.full_like(batches[1].energy, float("nan")))
    m = trainer._train_step(bad)
    assert m["skipped_nonfinite"] == 1.0 and trainer.step == 2
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, before[n]), n
    for k, v in trainer.optimizer.state_dict()["state"].items():
        assert torch.equal(v["exp_avg"], opt_before[k])
    assert trainer._train_step(batches[1])["skipped_nonfinite"] == 0.0


def test_ema_evaluation_and_restore_best():
    dm = _Toy(_toy_batches())
    trainer = _toy_trainer(max_epochs=4, ema_decay=0.9)
    trainer.fit(dm)
    ema_metrics = trainer.validate(dm.val_dataloader())
    trainer.cfg.eval_with_ema = False
    raw_metrics = trainer.validate(dm.val_dataloader())
    assert ema_metrics["val/loss"] != raw_metrics["val/loss"]
    trainer.cfg.eval_with_ema = True
    # wreck the live weights: test() evaluates the best snapshot instead
    step, best_params, _ = trainer._best_snapshot
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=g))
    trainer.cfg.eval_with_ema = False
    wrecked = trainer.validate(dm.val_dataloader())["val/loss"]
    assert trainer.test(dm.test_dataloader())["test/loss"] < wrecked
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, best_params[n]), n


def test_trainer_keeps_the_model_trainable_through_predict():
    dm = _Toy(_toy_batches(n=1))
    trainer = _toy_trainer(max_epochs=1)
    list(trainer.predict(dm.predict_dataloader()))
    trainer.validate(dm.val_dataloader())
    assert all(p.requires_grad for p in trainer.model.parameters())
    trainer.fit(dm)
    assert all(p.requires_grad for p in trainer.model.parameters())


@pytest.mark.parametrize("kw", [dict(n_dp=2), dict(log_mfu=True), dict(profile_dir="profile")])
def test_trainer_options_build_and_n_dp_must_be_the_world_size(kw, tmp_path, monkeypatch):
    """n_dp=2 with no process group of two ranks raises, naming both numbers
    (the launcher sets the width; tests/test_torch_dp.py runs two ranks);
    profile_dir and log_mfu build (tests/test_torch_loggers_profiling.py
    runs them)."""
    monkeypatch.chdir(tmp_path)
    (key, value), = kw.items()
    if key == "n_dp":
        with pytest.raises(ValueError, match="n_dp=2 but the process group has world size 1"):
            _toy_trainer(**kw)
    else:
        assert getattr(_toy_trainer(**kw).cfg, key) == value


def test_amsgrad_matches_optax():
    """`optimizer: amsgrad` follows optax.amsgrad (the max of the
    bias-corrected second moment) over six steps of gradients whose scale
    jumps, so the running max matters."""
    import jax.numpy as jnp
    import optax

    from nabladft_tpu_torch.train.state import build_optimizer

    rng = np.random.default_rng(3)
    p0 = [rng.normal(size=(5, 4)).astype(np.float32), rng.normal(size=7).astype(np.float32)]
    grads = [[(rng.normal(size=p.shape) * s).astype(np.float32) for p in p0]
             for s in (1.0, 0.1, 3.0, 0.5, 2.0, 0.01)]
    tx = optax.amsgrad(1e-2)
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = build_optimizer([("a", tp[0]), ("b", tp[1])], "amsgrad", 1e-2)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, upd)
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        opt.step()
        for t, w in zip(tp, params):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_warmup_counts_applied_updates_as_jax(arrays):
    """A non-finite batch inside the warmup: the guard skips it and the
    warmup does not advance (the JAX guard reverts scale_by_schedule's
    count), so the rates of the steps after it, and the parameters, equal
    the JAX engine's."""
    import optax

    cfg = dict(optimizer="adam", lr=1e-3, warmup_steps=4, schedule="constant",
               force_grads="direct", log_every_n_steps=1000, **LOSSES)
    jt = JaxTrainer(jax_create_model("painn", **KW, remat=False), JaxConfig(n_dp=1, **cfg))
    bad_arrays = dict(arrays, energy=np.full_like(arrays["energy"], np.nan))
    seq = [arrays, bad_arrays, arrays, arrays]
    jt.init_state(JaxBatch(**arrays))
    jt.state = jax.device_put(jt.state, replicated(jt.mesh))  # one trace of the step
    params0 = jax.device_get(jt.state.params)
    state = jt.state
    for arrs in seq:
        state, _ = jt._jit_train_step(state, JaxBatch(**arrs))
    sched = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByScheduleState))
        if isinstance(s, optax.ScaleByScheduleState)]
    count = int(sched[0].count)
    want = {n: p.detach() for n, p in _port_model(jax.device_get(state.params)).named_parameters()}

    model = _port_model(params0)
    trainer = Trainer(model, "cpu", TrainerConfig(**cfg))
    skipped = [trainer._train_step(_tb(arrs))["skipped_nonfinite"] for arrs in seq]
    assert skipped == [0.0, 1.0, 0.0, 0.0]
    assert trainer.step == 4 and trainer.applied == count == 3
    # the last update ran at 3/4 of the rate, as the JAX schedule's
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(cfg["lr"] * count / 4)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
