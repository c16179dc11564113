"""The port's step-indexed LR schedules against the JAX package's.

* linear, polynomial, cosine and multistep, with and without warmup, at
  steps 0…N against JAX's `build_schedule` at the int32 count (rtol 1e-6);
* the Trainer's rates over five steps with a non-finite one among them,
  against the JAX engine's injected `learning_rate`: each update reads the
  schedule at the count of applied updates, so the skipped step does not
  advance it, and the parameters after the steps equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.parallel.mesh import replicated
from nabladft_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from nabladft_tpu.train.schedulers import build_schedule as jax_build_schedule
from nabladft_tpu.train.state import current_learning_rate as jax_current_learning_rate
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models.convert import load_flax_params
from nabladft_tpu_torch.train import Trainer, TrainerConfig
from nabladft_tpu_torch.train.schedulers import build_schedule


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KWARGS = {"linear": {}, "polynomial": {"lr_end": 1e-5, "power": 2.0},
          "cosine": {"min_lr_factor": 0.05}, "multistep": {"milestones": [9, 5, 9], "gamma": 0.5}}
KW = dict(hidden=16, n_interactions=2, n_rbf=8, max_neighbors=7)


@pytest.mark.parametrize("warmup", [0, 4])
@pytest.mark.parametrize("kind", sorted(KWARGS))
def test_schedule_matches_jax(kind, warmup):
    total = 12
    ours = build_schedule(kind, 1e-3, total, warmup, **KWARGS[kind])
    want = jax_build_schedule(kind, 1e-3, total, warmup, **KWARGS[kind])
    got = [ours(s) for s in range(total + 4)]
    # at the int32 update count, as optax.inject_hyperparams calls it
    np.testing.assert_allclose(got, [float(want(jnp.int32(s))) for s in range(total + 4)],
                               rtol=1e-6, atol=0)
    assert len(set(got)) > 2


def test_constant_and_plateau_have_no_schedule_and_others_raise():
    assert build_schedule("constant", 1e-3, 10) is None
    assert build_schedule("plateau", 1e-3, 10) is None
    with pytest.raises(KeyError, match="unknown schedule"):
        build_schedule("exponential", 1e-3, 10)
    with pytest.raises(ValueError, match="total_steps"):
        build_schedule("cosine", 1e-3, 3, 4)


def _arrays(seed=0, b=4, a=9):
    rng = np.random.default_rng(seed)
    z = rng.integers(1, 9, (b, a)).astype(np.int32)
    pos = rng.uniform(-2, 2, (b, a, 3)).astype(np.float32)
    mask = np.ones((b, a), bool)
    mask[1, 6:] = False
    z[~mask], pos[~mask] = 0, 0.0
    return dict(z=z, pos=pos, node_mask=mask, graph_mask=np.ones((b,), bool),
                energy=rng.normal(size=b).astype(np.float32),
                forces=np.zeros((b, a, 3), np.float32), mol_id=np.arange(b, dtype=np.int32))


@pytest.mark.parametrize("kind", ["cosine", "linear"])
def test_trainer_rates_count_applied_updates_as_jax(kind):
    """Steps ok, non-finite, ok, ok, ok with warmup 2 over 6 steps: the
    rates logged after each step and the final parameters equal the JAX
    engine's."""
    arrays = _arrays()
    cfg = dict(optimizer="adam", lr=1e-3, schedule=kind, warmup_steps=2, total_steps=6,
               loss_specs={"energy": "l1"}, loss_coefs={"energy": 1.0}, log_every_n_steps=1000)
    seq = [arrays, dict(arrays, energy=np.full_like(arrays["energy"], np.nan)),
           arrays, arrays, arrays]
    jt = JaxTrainer(jax_create_model("painn", **KW, remat=False), JaxConfig(n_dp=1, **cfg))
    jt.init_state(JaxBatch(**arrays))
    jt.state = jax.device_put(jt.state, replicated(jt.mesh))  # one trace of the step
    params0 = jax.device_get(jt.state.params)
    state, want = jt.state, []
    for arrs in seq:
        state, _ = jt._jit_train_step(state, JaxBatch(**arrs))
        want.append(jax_current_learning_rate(state.opt_state))
    want_params = dict(load_flax_params(create_model("painn", device="cpu", **KW),
                                        jax.device_get(state.params)).named_parameters())

    model = load_flax_params(create_model("painn", device="cpu", **KW), params0)
    trainer = Trainer(model, "cpu", TrainerConfig(**cfg))
    got, skipped = [], []
    for arrs in seq:
        m = trainer._train_step(MolBatch(**{k: torch.from_numpy(v) for k, v in arrs.items()}))
        skipped.append(m["skipped_nonfinite"])
        got.append(trainer.optimizer.param_groups[0]["lr"])
    assert skipped == [0.0, 1.0, 0.0, 0.0, 0.0] and trainer.applied == 4
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == got[1]  # the skipped step left the rate where it was
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
