"""The port's data parallelism (`parallel/dist.py`, the trainer's `n_dp`) in
a two-rank gloo group on the CPU, against JAX's dp mesh and the port's
n_dp=1.

The two ranks are CPU processes started once for the module (`spawn`;
tests/torch_dp_ranks.py, which imports no JAX, runs every scenario in
them); while they run, this process computes the same scenarios with no
group (the port's n_dp=1) and the JAX references on the 8-device virtual
mesh (tests/conftest.py). Each check is a test of its own:

* (1) `multitask_loss` of each rank's share, for every loss kind, the
  RMSE + MAE matrix loss and a max-error gate that drops a target, on a
  five-row batch split 3 / 2 (uneven, and with rank 1's rows all padding):
  each rank reports the global batch's values, and the gradients with
  respect to the predictions, concatenated over the ranks, are `jax.grad`'s
  of the JAX `multitask_loss` on the whole batch (relative 1e-6).
* (2) the first step's gradients and three AdamW steps (clipped) of a
  narrow PaiNN through A-D's plain versions (force_grads "pallas"), on
  batches whose shards hold unequal atom counts, the last with three
  molecules: against the JAX Trainer with n_dp=2 (GRAD_TOL; the parameters
  rtol 1e-5, atol 1e-5, as tests/test_torch_train.py) on the port's seeded
  weights (`convert.flax_params_of`, its tree held against JAX's
  `model.init` evaluated abstractly), and against the port's n_dp=1
  (relative 1e-6).
* (3) validate and test metrics, (4) the predict job's rows and their
  order, (5) checkpoints and CSV rows written by rank 0 alone and a
  two-rank resume, (6) GemNet-OC's scale fit, all against n_dp=1; (7) n_dp
  that is not the world size and (8) the optimize job in a world of two
  raise, naming what they wait for.
"""

import multiprocessing
import pickle

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.parallel.mesh import batch_sharding, replicated
from nabladft_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from nabladft_tpu.train.losses import multitask_loss as jax_multitask_loss
from nabladft_tpu.train.state import TrainState as JaxTrainState
from nabladft_tpu_torch.data.ase_codec import AseDatabase
from nabladft_tpu_torch.data.synthetic import write_random_db
from nabladft_tpu_torch.models.convert import flax_params_of, load_flax_params
from tests import torch_dp_ranks as R

pytestmark = pytest.mark.parallel

GRAD_TOL = dict(rtol=5e-3, atol=1e-5)  # tests/test_torch_train.py
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-6  # the losses against JAX, relative
ONE_RTOL = 1e-6  # two ranks against n_dp=1, relative
RANK_TIMEOUT = 300  # s, both ranks' scenarios (about 20 s)


def _jax_refs():
    """JAX's losses and gradients for scenario (1); the JAX Trainer with
    n_dp=2 for (2): its first gradients, per-step metrics and parameters."""
    losses = {}
    for layout in R.LOSS_LAYOUTS:
        arrays, preds = R.loss_arrays(layout)
        batch = JaxBatch(**arrays)
        for case, (specs, coefs, max_errors) in R.LOSS_CASES.items():
            def total(p):
                return jax_multitask_loss(p, batch, specs, coefs, max_errors)["total"]

            values = jax_multitask_loss(preds, batch, specs, coefs, max_errors)
            losses[layout, case] = dict(values={k: float(v) for k, v in values.items()},
                                        grads=jax.device_get(jax.grad(total)(preds)))

    model = jax_create_model("painn", **R.PAINN_KW, remat=False)
    batches = [JaxBatch(**b) for b in R.train_batches()]
    params = flax_params_of(R.painn("off"))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), batches[0])
    jt = JaxTrainer(model, JaxConfig(n_dp=2, force_grads="direct", **R.TRAIN))
    assert jt.n_dp == 2
    jt.state = JaxTrainState.create(jax.tree_util.tree_map(np.asarray, params), jt.tx)
    jt.state = jax.device_put(jt.state, replicated(jt.mesh))  # one trace of the step
    grad_fn = jax.jit(jax.grad(lambda p, b: jt._loss_and_out(p, b, jt.model)[0]["total"]),
                      in_shardings=(replicated(jt.mesh), batch_sharding(jt.mesh)))
    grads = jax.device_get(grad_fn(jt.state.params, batches[0]))
    metrics = []
    for b in batches:
        jt.state, m = jt._jit_train_step(jt.state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(losses=losses, shapes=shapes, params0=params, grads=grads, metrics=metrics,
                params=jax.device_get(jt.state.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results, this process's n_dp=1 results and the JAX
    references."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("dp")
    db = write_random_db(tmp / "in.db", n_mols=11, min_atoms=4, max_atoms=12, seed=3)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=R.rank_main, args=(r, R.WORLD, str(tmp / "store"), str(tmp),
                                                   str(db))) for r in range(R.WORLD)]
    for p in procs:
        p.start()
    try:
        single = {name: fn(tmp, db) for name, fn in R.SCENARIOS.items() if name != "refusals"}
        jax_refs = _jax_refs()
    finally:
        for p in procs:
            p.join(timeout=RANK_TIMEOUT)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        torch.set_num_threads(n_threads)
    ranks = []
    for r in range(R.WORLD):
        path = tmp / f"rank{r}.pkl"
        assert path.exists(), f"rank {r} wrote no results (exit code {procs[r].exitcode})"
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
    return dict(single=single, ranks=ranks, jax=jax_refs, tmp=tmp)


def _scenario(runs, name):
    """Each rank's results of one scenario; a rank's failure fails the test
    with its traceback."""
    out = []
    for r, res in enumerate(runs["ranks"]):
        assert name in res, f"rank {r} did not reach scenario {name!r}: {res}"
        assert "error" not in res[name], f"rank {r}, {name}:\n{res[name]['error']}"
        out.append(res[name])
    return out


def _port_named(tree):
    """A flax tree as the port's named tensors (numpy)."""
    model = load_flax_params(R.painn("off"), jax.tree_util.tree_map(np.asarray, tree))
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def _rel_close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=what)


@pytest.mark.parametrize("layout", list(R.LOSS_LAYOUTS))
@pytest.mark.parametrize("case", list(R.LOSS_CASES))
def test_losses_of_uneven_shards_match_jax_on_the_whole_batch(runs, layout, case):
    ranks = [res[layout, case] for res in _scenario(runs, "losses")]
    want = runs["jax"]["losses"][layout, case]
    for r, res in enumerate(ranks):
        assert set(res["values"]) == set(want["values"])
        for k, v in want["values"].items():
            assert res["values"][k] == pytest.approx(v, rel=LOSS_RTOL), (r, k)
    for k, g in want["grads"].items():
        parts = [res["grads"][k] for res in ranks if k in res["grads"]]
        _rel_close(np.concatenate(parts) if parts else np.zeros_like(g), g, LOSS_RTOL, k)
    if case == "gate":  # the gate dropped the energy: no gradient reaches it
        assert not np.any(want["grads"]["energy"])
    # n_dp=1 reports the same values
    for k, v in runs["single"]["losses"][layout, case]["values"].items():
        assert ranks[0]["values"][k] == pytest.approx(v, rel=LOSS_RTOL), k


def test_the_seeded_weights_are_jax_init_tree(runs):
    shapes, params = runs["jax"]["shapes"], runs["jax"]["params0"]
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(params)
    for s, p in zip(jax.tree_util.tree_leaves(shapes), jax.tree_util.tree_leaves(params)):
        assert s.shape == p.shape


def test_first_step_gradients_match_jax_dp_mesh_and_n_dp_1(runs):
    ranks = _scenario(runs, "train")
    want = _port_named(runs["jax"]["grads"])
    single = runs["single"]["train"]["grads"]
    for r, res in enumerate(ranks):
        for name, g in res["grads"].items():
            np.testing.assert_allclose(g, want[name], **GRAD_TOL, err_msg=f"rank {r} {name}")
            _rel_close(g, single[name], ONE_RTOL, f"rank {r} {name} vs n_dp=1")


def test_three_train_steps_match_jax_dp_mesh_and_n_dp_1(runs):
    ranks = _scenario(runs, "train")
    want = _port_named(runs["jax"]["params"])
    single = runs["single"]["train"]
    for r, res in enumerate(ranks):
        for m, j, s in zip(res["metrics"], runs["jax"]["metrics"], single["metrics"]):
            assert m["grad_norm"] > R.TRAIN["grad_clip"]  # the clip acted
            for k in ("grad_norm", "train/total", "train/energy", "train/forces"):
                assert m[k] == pytest.approx(j[k], rel=1e-4), (r, k)
                assert m[k] == pytest.approx(s[k], rel=ONE_RTOL), (r, k)
        for name, p in res["params"].items():
            np.testing.assert_allclose(p, want[name], **PARAM_TOL, err_msg=f"rank {r} {name}")
            _rel_close(p, single["params"][name], ONE_RTOL, f"rank {r} {name} vs n_dp=1")
    for name, p in ranks[0]["params"].items():  # every rank applies the same update
        np.testing.assert_array_equal(p, ranks[1]["params"][name], err_msg=name)


def test_validate_and_test_metrics_match_n_dp_1(runs):
    single = runs["single"]["train"]
    for res in _scenario(runs, "train"):
        for key in ("val", "test"):
            assert set(res[key]) == set(single[key]) and res[key]
            for k, v in single[key].items():
                assert res[key][k] == pytest.approx(v, rel=ONE_RTOL), k


def _rows(path):
    db = AseDatabase(path)
    try:
        return list(db.select_all())
    finally:
        db.close()


def test_predict_writes_the_rows_of_n_dp_1_in_their_order(runs):
    rank0, rank1 = _scenario(runs, "predict")
    assert rank0["wrote"] and not rank1["wrote"]
    single = runs["single"]["predict"]
    got, want = _rows(rank0["db"]), _rows(single["db"])
    assert rank0["res"]["rows"] == single["res"]["rows"] == len(want) == len(got) == 11
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numbers, w.numbers)
        np.testing.assert_array_equal(g.positions, w.positions)
        _rel_close(g.data["energy_pred"], w.data["energy_pred"], 1e-5, "energy_pred")
        _rel_close(g.data["forces_pred"], w.data["forces_pred"], 1e-5, "forces_pred")


def test_rank_0_alone_writes_checkpoints_and_csv_rows(runs):
    rank0, rank1 = _scenario(runs, "checkpoints")
    assert "ckpt_rank0/last.ckpt" in rank0["files"]["ckpt_rank0"]
    assert "ckpt_rank0/index.json" in rank0["files"]["ckpt_rank0"]
    assert "out_rank0/painn-dp/metrics.csv" in rank0["files"]["out_rank0"]
    assert rank1["files"] == {d: [] for d in rank1["files"]}, rank1["files"]
    single = runs["single"]["checkpoints"]["res"]
    for res in (rank0, rank1):
        assert res["res"]["step"] == single["step"]
        for k, v in single.items():
            assert res["res"][k] == pytest.approx(v, rel=ONE_RTOL), k


def test_two_rank_resume_steps_as_n_dp_1(runs):
    """Both ranks resume from rank 0's last checkpoint; n_dp=1 from its own
    (the same step and, to ONE_RTOL, the same weights): one more epoch."""
    rank0, rank1 = _scenario(runs, "checkpoints")
    single = runs["single"]["checkpoints"]
    tmp = runs["tmp"]
    assert rank0["resumed"]["step"] > rank0["res"]["step"]
    for res in (rank0, rank1):
        assert res["resumed"]["step"] == single["resumed"]["step"]
        for k, v in single["resumed"].items():
            assert res["resumed"][k] == pytest.approx(v, rel=ONE_RTOL), k
    got = torch.load(tmp / "ckpt_resume_rank0" / "last.ckpt", weights_only=True)
    want = torch.load(tmp / "ckpt_resume_single" / "last.ckpt", weights_only=True)
    assert got["step"] == want["step"]
    for name, t in want["model"].items():
        _rel_close(got["model"][name].numpy(), t.numpy(), 1e-5, name)


def test_gemnet_scale_fit_is_the_same_on_both_ranks_and_n_dp_1(runs):
    rank0, rank1 = _scenario(runs, "gemnet")
    single = runs["single"]["gemnet"]
    assert rank0 == rank1 and set(rank0) == set(single) and rank0
    for name, s in single.items():
        assert rank0[name] == pytest.approx(s, rel=ONE_RTOL), name


def test_n_dp_that_is_not_the_world_size_names_both(runs):
    for res in _scenario(runs, "refusals"):
        assert "n_dp=3" in res["n_dp"] and "world size 2" in res["n_dp"], res


def test_the_optimize_job_refuses_a_world_of_two(runs):
    for r, res in enumerate(_scenario(runs, "refusals")):
        assert "runs in one process, as the JAX package's does" in res["optimize"], res
        assert f"rank {r} of 2" in res["optimize"], res
