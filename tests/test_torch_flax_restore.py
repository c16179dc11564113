"""The Trainer restoring the JAX package's flax checkpoints.

A small PaiNN trains three steps in the JAX engine (AdamW with weight decay
0.1 on the weights, global-norm clip 1, a 5-step warmup under the plateau
rate, EMA 0.9), and the JAX `CheckpointManager` writes the TrainState. The
port's Trainer then

* resumes from the file (step, applied count, learning rate, the Adam
  moments and count, EMA, plateau counters) and takes one more step, which
  matches the JAX engine's next step: parameters and EMA within rtol 1e-5 /
  atol 1e-6 (optax's adamw decays the weights inside the update, torch's
  AdamW before it; the two agree);
* loads the file for evaluation: its predictions with the EMA equal JAX's
  forward on ema_params (E rtol 2e-4 / atol 1e-5, F rtol 2e-3 / atol 2e-4);
* resumes each other optimizer of the JAX engine (adam, amsgrad, sgd with
  momentum 0.9, and AdamW under lookahead with k 3, whose resumed step is a
  sync) from the JAX TrainState after two steps, through the same chain
  (clip 1, a 5-step warmup), on an energy loss: the port's next step
  matches the JAX engine's, every parameter within 1e-6 x the largest |p|,
  and lookahead's slow weights likewise;
* refuses to resume another optimizer's state, naming both, and still loads
  the weights for evaluation.
"""

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models.base import forward as jax_forward
from nabladft_tpu.parallel.mesh import replicated
from nabladft_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.train import Trainer, TrainerConfig
from tests.test_torch_train import KW, LOSSES, _arrays, _tb

CFG = dict(optimizer="adamw", lr=1e-3, weight_decay=0.1, grad_clip=1.0, schedule="plateau",
           warmup_steps=5, ema_decay=0.9, force_grads="direct", log_every_n_steps=1000,
           **LOSSES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(checkpoint path, JAX state after 3 steps, after a 4th)."""
    d = tmp_path_factory.mktemp("flax_restore")
    jt = JaxTrainer(jax_create_model("painn", **KW, remat=False),
                    JaxConfig(n_dp=1, ckpt_dir=str(d), **CFG))
    jt.init_state(JaxBatch(**_arrays(0)))
    jt.state = jax.device_put(jt.state, replicated(jt.mesh))  # one trace of the step
    state = jt.state
    for seed in (0, 1, 2):
        state, _ = jt._jit_train_step(state, JaxBatch(**_arrays(seed)))
    jt.plateau.bad_epochs = 2
    jt.ckpt.save(state, 3, {"val/loss": 1.0}, aux=jt._ckpt_aux())
    saved = jax.device_get(state)  # the step donates `state`
    after, _ = jt._jit_train_step(state, JaxBatch(**_arrays(3)))
    return d / "last.ckpt", saved, jax.device_get(after), jt.model


def _trainer(**kw):
    model = create_model("painn", device="cpu", generator=torch.Generator().manual_seed(5), **KW)
    return Trainer(model, "cpu", TrainerConfig(**dict(CFG, **kw)))


def _tree_tensors(trainer, tree):
    from nabladft_tpu_torch.models.convert import flax_tensors

    return flax_tensors(trainer.model, tree)


def test_resume_matches_the_jax_engines_next_step(jax_run):
    path, state, after, _ = jax_run
    t = _trainer()
    t.load_checkpoint(path, resume=True)
    assert t.step == 3 and t.applied == 3 and t.plateau.bad_epochs == 2
    assert t._lr == pytest.approx(1e-3)
    t._train_step(_tb(_arrays(3)))
    want, want_ema = _tree_tensors(t, after.params), _tree_tensors(t, after.ema_params)
    for name, p in t.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(t.ema[name].numpy(), want_ema[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    moved = max(float((want[n] - w).abs().max())
                for n, w in _tree_tensors(t, state.params).items())
    assert moved > 1e-5  # the step did something


def test_evaluation_uses_the_checkpoints_ema(jax_run):
    path, state, _, jax_model = jax_run
    t = _trainer()
    t.load_checkpoint(path)
    assert t.step == 0  # not resumed
    arrays = _arrays(4)
    got = t._predict_step(_tb(arrays))
    want = jax.jit(lambda p, b: jax_forward(jax_model, p, b))(state.ema_params, JaxBatch(**arrays))
    np.testing.assert_allclose(got["energy"].numpy(), np.asarray(want["energy"]), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["forces"].numpy(), np.asarray(want["forces"]), rtol=2e-3,
                               atol=2e-4)


@pytest.mark.parametrize("kw", [dict(optimizer="amsgrad"), dict(lookahead_k=3)])
def test_other_optimizer_states_are_refused(jax_run, kw):
    path, state, _, _ = jax_run
    t = _trainer(**kw)
    want = "adamw with lookahead" if "lookahead_k" in kw else kw["optimizer"]
    with pytest.raises(ValueError, match=f"holds adamw state; this trainer runs {want}$"):
        t.load_checkpoint(path, resume=True)
    t.load_checkpoint(path)  # the weights still load for evaluation
    want = _tree_tensors(t, state.params)
    assert all(torch.equal(p.detach(), want[n]) for n, p in t.model.named_parameters())


OPTIMIZERS = {"adam": dict(optimizer="adam"), "amsgrad": dict(optimizer="amsgrad"),
              "sgd": dict(optimizer="sgd"),
              "lookahead": dict(optimizer="adamw", weight_decay=0.1, lookahead_k=3)}
OPT_CFG = dict(lr=1e-3, grad_clip=1.0, schedule="plateau", warmup_steps=5,
               log_every_n_steps=1000, loss_specs={"energy": "l1"},
               loss_coefs={"energy": 1.0}, force_grads="direct")
P_REL = 1e-6
KW1 = dict(KW, n_interactions=1)  # one interaction: a quicker JAX compile


@pytest.fixture(scope="module", params=sorted(OPTIMIZERS))
def optimizer_run(request, tmp_path_factory):
    """(optimizer, checkpoint path, JAX state after 2 steps, after a 3rd)."""
    from nabladft_tpu.train.state import TrainState
    from nabladft_tpu_torch.models.convert import flax_params_of

    kw = dict(OPT_CFG, **OPTIMIZERS[request.param])
    d = tmp_path_factory.mktemp(f"flax_restore_{request.param}")
    jt = JaxTrainer(jax_create_model("painn", **KW1, remat=False),
                    JaxConfig(n_dp=1, ckpt_dir=str(d), **kw))
    # the port's seeded weights as the initial flax tree (no JAX init to
    # compile), which has the paths and shapes of JAX's init
    params = flax_params_of(create_model("painn", device="cpu",
                                         generator=torch.Generator().manual_seed(3), **KW1))
    abstract = jax.eval_shape(jt.model.init, jax.random.PRNGKey(0), JaxBatch(**_arrays(0)))
    assert (jax.tree_util.tree_structure(abstract) == jax.tree_util.tree_structure(params)
            and [a.shape for a in jax.tree_util.tree_leaves(abstract)]
            == [np.shape(x) for x in jax.tree_util.tree_leaves(params)])
    jt.state = TrainState.create(params, jt.tx, ema=False)
    jt.state = jax.device_put(jt.state, replicated(jt.mesh))  # one trace of the step
    state = jt.state
    for seed in (0, 1):
        state, _ = jt._jit_train_step(state, JaxBatch(**_arrays(seed)))
    jt.ckpt.save(state, 2, {"val/loss": 1.0}, aux=jt._ckpt_aux())
    saved = jax.device_get(state)
    after, _ = jt._jit_train_step(state, JaxBatch(**_arrays(2)))
    return request.param, d / "last.ckpt", saved, jax.device_get(after)


def test_each_optimizer_resumes_to_the_jax_engines_next_step(optimizer_run):
    name, path, state, after = optimizer_run
    model = create_model("painn", device="cpu", generator=torch.Generator().manual_seed(5), **KW1)
    t = Trainer(model, "cpu", TrainerConfig(**dict(OPT_CFG, **OPTIMIZERS[name])))
    t.load_checkpoint(path, resume=True)
    assert t.step == 2 and t.applied == 2 and t._lr == pytest.approx(1e-3)
    t._train_step(_tb(_arrays(2)))
    want = _tree_tensors(t, after.params)
    scale = max(float(w.abs().max()) for w in want.values())
    for n, p in t.model.named_parameters():
        err = float((p.detach() - want[n]).abs().max())
        assert err <= P_REL * scale, (name, n, err / scale)
    moved = max(float((want[n] - w).abs().max()) for n, w in _tree_tensors(t, state.params).items())
    assert moved > 1e-5  # the step did something
    if name == "lookahead":
        assert t.optimizer.count == 3
        slow = _tree_tensors(t, after.opt_state[-1].slow)
        names = {id(p): n for n, p in t.model.named_parameters()}
        for s, p in zip(t.optimizer.slow, t.optimizer.params):
            n = names[id(p)]
            assert float((s - slow[n]).abs().max()) <= P_REL * scale, n
