"""Lookahead and PhiSNet's train step against the JAX package.

* `Lookahead` around AdamW (k = 3, α = 0.5) against
  `optax.chain(optax.adamw, schedulers.lookahead)` over seven gradient
  steps, parameters within 1e-6 after every step;
* the Trainer with `lookahead_k=3` against the JAX engine over seven train
  steps of a small PaiNN, the third batch non-finite: the guard skips it,
  so neither the optimizer nor Lookahead counts it (six updates, syncs
  after the third and the sixth, as the JAX state's count); the port
  checkpoints after four steps and a fresh Trainer resumes from the file
  (the slow copy and the count are in it) for the last three. Parameters
  within rtol 1e-5 / atol 1e-6 of JAX's;
* one PhiSNet train step (H + S loss, so the core head gets no gradient;
  AdamW with weight decay 0.5, ema_decay 0.999, grad_clip 0.001) against
  the JAX engine's step: parameters and EMA within 1e-6 absolute. optax
  gives the unreached core head a zero gradient, so its kernels still
  decay; the port's Trainer fills zeros for gradients autograd leaves
  unset, with the same result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.parallel.mesh import replicated
from nabladft_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from nabladft_tpu.train.schedulers import LookaheadState, lookahead
from nabladft_tpu.train.state import TrainState as JaxTrainState
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models.convert import flax_params_of, load_flax_params
from nabladft_tpu_torch.train import Trainer, TrainerConfig
from nabladft_tpu_torch.train.schedulers import Lookahead
from nabladft_tpu_torch.train.state import build_optimizer
from tests.test_torch_phisnet import KW as PHISNET_KW
from tests.test_torch_phisnet import hamiltonian_batch, torch_batch
from tests.test_torch_train import KW as PAINN_KW
from tests.test_torch_train import LOSSES, _arrays, _tb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lookahead_count(opt_state) -> int:
    states = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, LookaheadState))
        if isinstance(s, LookaheadState)]
    return int(states[0].count)


def test_lookahead_matches_the_optax_chain():
    rng = np.random.default_rng(4)
    p0 = [rng.normal(size=(5, 4)).astype(np.float32), rng.normal(size=7).astype(np.float32)]
    tx = optax.chain(optax.adamw(1e-2, weight_decay=0.1), lookahead(3, 0.5))
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = Lookahead(build_optimizer([("a", tp[0]), ("b", tp[1])], "adamw", 1e-2, 0.1,
                                    wd_skip_1d=False), k=3, alpha=0.5)
    for step in range(7):
        g = [(rng.normal(size=p.shape) * (1 + step)).astype(np.float32) for p in p0]
        upd, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, upd)
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        opt.step()
        for t, w in zip(tp, params):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert opt.count == _lookahead_count(state) == 7


def test_trainer_lookahead_skip_and_resume_match_jax(tmp_path):
    cfg = dict(optimizer="adamw", lr=1e-3, weight_decay=0.01, schedule="constant",
               force_grads="direct", log_every_n_steps=1000, lookahead_k=3,
               lookahead_alpha=0.5, **LOSSES)
    arrays = _arrays()
    bad = dict(arrays, energy=np.full_like(arrays["energy"], np.nan))
    seq = [arrays, arrays, bad] + [arrays] * 4
    jt = JaxTrainer(jax_create_model("painn", **PAINN_KW, remat=False), JaxConfig(n_dp=1, **cfg))
    jt.init_state(JaxBatch(**arrays))
    jt.state = jax.device_put(jt.state, replicated(jt.mesh))  # one trace of the step
    params0 = jax.device_get(jt.state.params)
    state = jt.state
    for arrs in seq:
        state, _ = jt._jit_train_step(state, JaxBatch(**arrs))
    want = {n: p.detach() for n, p in load_flax_params(
        create_model("painn", device="cpu", **PAINN_KW),
        jax.device_get(state.params)).named_parameters()}

    def trainer():
        model = load_flax_params(create_model("painn", device="cpu", **PAINN_KW), params0)
        return Trainer(model, "cpu", TrainerConfig(**cfg))

    first = trainer()
    skipped = [first._train_step(_tb(arrs))["skipped_nonfinite"] for arrs in seq[:4]]
    assert skipped == [0.0, 0.0, 1.0, 0.0]
    assert first.optimizer.count == first.applied == 3
    # synced after the third applied update: the slow copy is the weights
    for p, s in zip(first.optimizer.params, first.optimizer.slow):
        assert torch.equal(p, s)
    torch.save(first.state_dict(), tmp_path / "step4.ckpt")
    resumed = trainer()
    resumed.load_checkpoint(tmp_path / "step4.ckpt", resume=True)
    assert resumed.optimizer.count == 3 and resumed.step == 4
    for s, t in zip(resumed.optimizer.slow, first.optimizer.slow):
        assert torch.equal(s, t)
    for arrs in seq[4:]:
        resumed._train_step(_tb(arrs))
    assert resumed.optimizer.count == _lookahead_count(state.opt_state) == 6
    for name, p in resumed.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_phisnet_train_step_matches_jax():
    f = hamiltonian_batch(np.random.default_rng(0))
    f.pop("core")
    cfg = dict(optimizer="adamw", lr=1e-4, weight_decay=0.5, ema_decay=0.999, grad_clip=0.001,
               schedule="constant", log_every_n_steps=1000,
               loss_specs={"hamiltonian": "rmse_mae", "overlap": "rmse_mae"},
               loss_coefs={"hamiltonian": 1.0, "overlap": 1.0})
    kw = dict(PHISNET_KW, num_modules=1)
    jt = JaxTrainer(jax_create_model("phisnet", remat=False, **kw),
                    JaxConfig(n_dp=1, **cfg))
    jb = JaxBatch(**f)
    # the state from the port's seeded weights (no JAX init to compile), a
    # tree with the paths and shapes of JAX's init tree
    tree = flax_params_of(create_model("phisnet", device="cpu",
                                       generator=torch.Generator().manual_seed(0), **kw))
    init = jax.eval_shape(jt.model.init, jax.random.PRNGKey(0), jb)
    shapes = lambda t: {jax.tree_util.keystr(k): tuple(np.shape(x))  # noqa: E731
                        for k, x in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert shapes(tree) == shapes(dict(init))
    jt.state = JaxTrainState.create(tree, jt.tx, ema=True)
    jt.state = jax.device_put(jt.state, replicated(jt.mesh))  # one trace of the step
    params0 = jax.device_get(jt.state.params)
    state, jm = jt._jit_train_step(jt.state, jb)
    assert float(jm["grad_norm"]) > cfg["grad_clip"]  # the clip triggered
    twin = lambda tree: dict(load_flax_params(  # noqa: E731
        create_model("phisnet", device="cpu", **kw), tree).named_parameters())
    want, want_ema = twin(jax.device_get(state.params)), twin(jax.device_get(state.ema_params))

    model = load_flax_params(create_model("phisnet", device="cpu", **kw), params0)
    trainer = Trainer(model, "cpu", TrainerConfig(**cfg))
    m = trainer._train_step(torch_batch(f))
    assert m["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    assert float(m["train/total"]) == pytest.approx(float(jm["train/total"]), rel=1e-4)
    p0 = dict(load_flax_params(create_model("phisnet", device="cpu", **kw),
                               params0).named_parameters())
    core = "res_core_ii.lin_0_0.weight"
    # the unreached head decayed in JAX, by far more than the tolerance
    assert float((want[core] - p0[core]).detach().abs().max()) > 1e-5
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(trainer.ema[name].numpy(), want_ema[name].detach().numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
