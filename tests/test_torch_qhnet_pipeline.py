"""The port's QHNet jobs end to end on the CPU.

configs/qhnet.yaml shrunk to a small width (hidden 8, bottle_hidden 4, two
layers, start_layer 0, 8 RBF) over a seeded synthetic Hamiltonian DB:
* `job_type: train` (two epochs, AdamW, plateau LR, EMA 0.99) gives finite
  losses and metrics with `val/hamiltonian/mae`, a CSV row per step and
  epoch, and checkpoints; the best checkpoint restores, and `job_type: test`
  from it gives the metrics `Trainer.test` gives on the restored weights;
* `job_type: predict` raises ValueError, as in the JAX package;
* chip_smoke.py's QHNet config equals configs/qhnet.yaml composed by
  load_config with its overrides.
The optimizer and EMA were held against JAX by tests/test_torch_train*.py,
and the model by tests/test_torch_qhnet.py; no JAX fit runs here.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nabladft_tpu_torch import pipelines
from nabladft_tpu_torch.config import load_config
from nabladft_tpu_torch.data.synthetic import write_random_hamiltonian_db


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parent.parent
SMALL = dict(hidden=8, bottle_hidden=4, num_layers=2, start_layer=0, rbf_dim=8)


def _cfg(db: Path, root: Path, job: str) -> dict:
    return load_config(
        REPO / "configs" / "qhnet.yaml",
        overrides={
            "job_type": job,
            "model": {"kwargs": SMALL},
            "datamodule": {"source": str(db), "root": str(root), "batch_size": 4,
                           "val_fraction": 0.25, "atom_boundaries": [8, 12],
                           "orbital_boundaries": [64, 128, 160]},
            "ckpt_dir": str(root / "ckpt"),
            "output_dir": str(root / "outputs"),
            "trainer": {"max_epochs": 2, "log_every_n_steps": 1},
        },
    )


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_qhnet_jobs")
    db = write_random_hamiltonian_db(root / "ham.db", n_mols=12, min_atoms=3, max_atoms=10,
                                     seed=5)
    train = pipelines.run(_cfg(db, root, "train"), device="cpu")
    index = json.loads((root / "ckpt" / "index.json").read_text())
    best = root / "ckpt" / index["best"][0]["path"]
    test = pipelines.run(dict(_cfg(db, root, "test"), ckpt_path=str(best)), device="cpu")
    return dict(root=root, db=db, train=train, test=test, best=best, index=index)


def test_train_job_metrics_are_finite(jobs):
    train = jobs["train"]
    assert {"val/loss", "val/hamiltonian/mae"} <= set(train)
    assert all(np.isfinite(v) for v in train.values())
    assert train["step"] > 0 and train["epoch"] == 1


def test_train_job_writes_checkpoints_and_csv(jobs):
    ckpt = jobs["root"] / "ckpt"
    assert (ckpt / "last.ckpt").exists() and jobs["best"].exists()
    rows = (jobs["root"] / "outputs" / "qhnet" / "metrics.csv").read_text().splitlines()
    header = rows[0].split(",")
    assert {"train/total", "train/hamiltonian", "grad_norm", "val/hamiltonian/mae"} <= set(header)
    assert len(rows) - 1 == jobs["train"]["step"] + 2


def test_test_job_from_best_checkpoint_equals_trainer_test(jobs):
    cfg = dict(_cfg(jobs["db"], jobs["root"], "test"), log_csv=False, ckpt_dir=None)
    trainer = pipelines.build_trainer(cfg, torch.device("cpu"))
    trainer.load_checkpoint(jobs["best"])
    want = trainer.test(pipelines.build_datamodule(cfg).test_dataloader())
    assert {"test/loss", "test/hamiltonian/mae"} <= set(jobs["test"])
    for k, v in want.items():
        assert jobs["test"][k] == pytest.approx(v, rel=1e-6), k


def test_predict_job_raises(jobs):
    with pytest.raises(ValueError, match="Hamiltonian"):
        pipelines.run(_cfg(jobs["db"], jobs["root"], "predict"), device="cpu")


def test_model_reads_the_db_basis(jobs):
    model = pipelines.build_model(_cfg(jobs["db"], jobs["root"], "train"), torch.device("cpu"))
    assert model.layout.orbitals[17] == (0, 0, 0, 0, 1, 1, 1, 2)
    assert model.use_pallas == "off"


def test_chip_smoke_qhnet_config_is_the_composed_yaml():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    want = load_config(
        REPO / "configs" / "qhnet.yaml",
        overrides={"job_type": "train",
                   "datamodule": {"source": "/db/in.db", "root": "/db"},
                   "ckpt_dir": "/db/ckpt", "output_dir": "/db/out",
                   "trainer": {"max_epochs": chip_smoke.TRAIN_EPOCHS, "log_every_n_steps": 1}},
    )
    got = chip_smoke.train_config("/db/in.db", "/db", "/db/ckpt", "/db/out", config="qhnet")
    assert got == want
