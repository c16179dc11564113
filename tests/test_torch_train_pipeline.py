"""The port's train and test jobs end to end, against the JAX package.

`job_type: train` on a seeded DB in both packages, from the same initial
weights (JAX's seeded init carried across with load_flax_params) over the
same batches (both datamodules split and shuffle with the same seeds), for
two epochs of AdamW with the plateau LR on configs/painn-oc.yaml shrunk to a
small width; then `job_type: test` from the port's best checkpoint against
JAX's `Trainer.test` (which restores its best-val parameters). Validation
and test metrics agree within rel 1e-4, the loss tolerance of
tests/train/test_engine.py (float32 sums in another order; a few Adam
steps, whose first updates are ±lr per component, carry them on).
"""

import csv
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu import pipelines as jax_pipelines
from nabladft_tpu.parallel.mesh import replicated
from nabladft_tpu_torch import pipelines
from nabladft_tpu_torch.config import load_config
from nabladft_tpu_torch.data.synthetic import write_random_db


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parent.parent
SMALL = dict(hidden=16, n_interactions=2, n_rbf=8, max_neighbors=7)
METRIC_REL = 1e-4


def _cfg(db: Path, root: Path, job: str, sub: str) -> dict:
    return load_config(
        REPO / "configs" / "painn-oc.yaml",
        overrides={
            "job_type": job,
            "model": {"kwargs": SMALL},
            "datamodule": {"source": str(db), "root": str(root), "batch_size": 8,
                           "bucket_boundaries": [32]},
            "ckpt_dir": str(root / sub / "ckpt"),
            "output_dir": str(root / sub / "outputs"),
            "trainer": {"max_epochs": 2, "n_dp": 1, "log_every_n_steps": 1},
        },
    )


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
    return root, write_random_db(root / "train.db", n_mols=24, min_atoms=5, max_atoms=30, seed=2)


@pytest.fixture(scope="module")
def runs(db):
    root, src = db
    jcfg = _cfg(src, root, "train", "jax")
    dm = jax_pipelines.build_datamodule(jcfg)
    jt = jax_pipelines.build_trainer(jcfg, dm)
    jt.init_state(next(iter(dm.val_dataloader())))
    jt.state = jax.device_put(jt.state, replicated(jt.mesh))  # one trace of the step
    params = jax.device_get(jt.state.params)
    jax_val = jt.fit(dm)
    jax_test = jt.test(dm.test_dataloader())
    jt.loggers.finalize()

    tcfg = _cfg(src, root, "train", "torch")
    train = pipelines.run(tcfg, device="cpu", params=params)
    index = json.loads((root / "torch" / "ckpt" / "index.json").read_text())
    best = root / "torch" / "ckpt" / index["best"][0]["path"]
    test = pipelines.run(dict(_cfg(src, root, "test", "torch"), ckpt_path=str(best)), device="cpu")
    return dict(jax_val=jax_val, jax_test=jax_test, jax_steps=int(jt.state.step), train=train,
                test=test, index=index, cfg=tcfg)


@pytest.mark.parametrize("key", ["val/loss", "val/energy/mae", "val/forces/mae"])
def test_train_job_val_metrics_match_jax(runs, key):
    assert runs["train"][key] == pytest.approx(runs["jax_val"][key], rel=METRIC_REL)


def test_train_job_takes_the_same_steps(runs):
    assert runs["train"]["step"] == runs["jax_steps"] > 0
    assert runs["train"]["epoch"] == 1


@pytest.mark.parametrize("key", ["test/loss", "test/energy/mae", "test/forces/mae"])
def test_test_job_from_best_checkpoint_matches_jax(runs, key):
    assert runs["test"][key] == pytest.approx(runs["jax_test"][key], rel=METRIC_REL)


def test_train_job_writes_checkpoints_and_metrics(runs, db):
    root, _ = db
    ckpt = root / "torch" / "ckpt"
    assert (ckpt / "last.ckpt").exists() and runs["index"]["last"]["step"] == runs["train"]["step"]
    assert all((ckpt / e["path"]).exists() for e in runs["index"]["best"])
    rows = (root / "torch" / "outputs" / "painn-oc" / "metrics.csv").read_text().splitlines()
    header = rows[0].split(",")
    assert {"train/total", "grad_norm", "mols_per_sec", "val/loss", "lr"} <= set(header)
    assert len(rows) - 1 == runs["train"]["step"] + 2  # a row per step and per epoch's val


def test_cli_train_on_cpu(db, tmp_path):
    from nabladft_tpu_torch import cli

    root, src = db
    assert cli.main([
        "--config", str(REPO / "configs" / "painn-oc.yaml"), "--device", "cpu",
        "job_type=train", f"datamodule.source={src}", f"datamodule.root={root}",
        f"ckpt_dir={tmp_path / 'ckpt'}", f"output_dir={tmp_path / 'out'}",
        "model.kwargs.hidden=16", "model.kwargs.n_interactions=1", "model.kwargs.n_rbf=8",
        "trainer.max_epochs=1",
    ]) == 0
    assert (tmp_path / "ckpt" / "last.ckpt").exists()
    with open(tmp_path / "out" / "painn-oc" / "metrics.csv") as f:
        last = list(csv.DictReader(f))[-1]
    assert np.isfinite(float(last["val/loss"]))


def test_flax_checkpoint_and_missing_card_raise(db, runs, tmp_path):
    """The JAX trainer's checkpoints as ckpt_path: `test` from its best one
    gives JAX's test metrics (JAX's test restores the same best-val
    parameters), and `train` resumes from its last one at JAX's step count.
    Without a card and without a named device, entry points raise."""
    root, src = db
    jax_ckpt = root / "jax" / "ckpt"  # written by the JAX trainer's CheckpointManager
    best = jax_ckpt / json.loads((jax_ckpt / "index.json").read_text())["best"][0]["path"]
    test = pipelines.run(dict(_cfg(src, root, "test", "resumed"), ckpt_path=str(best)),
                         device="cpu")
    for key in ("test/loss", "test/energy/mae", "test/forces/mae"):
        assert test[key] == pytest.approx(runs["jax_test"][key], rel=METRIC_REL), key
    cfg = _cfg(src, root, "train", "resumed")
    cfg["trainer"] = dict(cfg["trainer"], max_epochs=1)
    train = pipelines.run(dict(cfg, ckpt_path=str(jax_ckpt / "last.ckpt")), device="cpu")
    assert train["step"] == runs["jax_steps"] + runs["jax_steps"] // 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pipelines.run(_cfg(src, tmp_path, "train", "torch"))
        assert not (tmp_path / "torch").exists()
