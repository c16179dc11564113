"""The port's PhiSNet jobs end to end on the CPU, and the `core` loss that
neither package can train.

configs/phisnet.yaml shrunk to a small width (order 2, 8 features, 8 basis
functions, one module) over a seeded synthetic Hamiltonian DB (H and S, no
core matrix, as the nablaDFT schema's readers give it):
* the config's own loss specs ask for `core`, which the Hamiltonian
  datamodule never reads (neither package passes include_core): the JAX
  package's train job fails inside the loss with a TypeError, the port's
  with a ValueError that names `core`;
* with `trainer.loss_specs={hamiltonian: rmse_mae, overlap: rmse_mae}`
  (the override README gives; it replaces the model group's specs in both
  packages),
  `job_type: train` (two epochs, AdamW, EMA 0.999 from the model's
  trainer_overrides; grad_clip stays the trainer group's 10.0, since
  overrides fill only unset keys, as in the JAX package) gives finite
  losses and H and S metrics, a CSV row per step and epoch, and
  checkpoints; `job_type: test` from the best checkpoint gives what
  `Trainer.test` gives on the restored weights; `job_type: predict` raises;
* the model reads the DB's basis; chip_smoke.py's PhiSNet config equals
  the composed yaml with its overrides.
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
SMALL = dict(order=2, num_features=8, num_basis_functions=8, num_modules=1)
H_AND_S = {"hamiltonian": "rmse_mae", "overlap": "rmse_mae"}


def _overrides(db: Path, root: Path, job: str, loss_specs=None) -> dict:
    trainer = {"max_epochs": 2, "log_every_n_steps": 1}
    if loss_specs is not None:
        trainer["loss_specs"] = loss_specs
    return {
        "job_type": job,
        "model": {"kwargs": SMALL},
        "datamodule": {"source": str(db), "root": str(root), "batch_size": 4,
                       "val_fraction": 0.25, "atom_boundaries": [8, 12],
                       "orbital_boundaries": [64, 128, 160]},
        "ckpt_dir": str(root / "ckpt"),
        "output_dir": str(root / "outputs"),
        "trainer": trainer,
    }


def _cfg(db: Path, root: Path, job: str, loss_specs=H_AND_S) -> dict:
    return load_config(REPO / "configs" / "phisnet.yaml",
                       overrides=_overrides(db, root, job, loss_specs))


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_phisnet_jobs")
    db = write_random_hamiltonian_db(root / "ham.db", n_mols=12, min_atoms=3, max_atoms=10,
                                     seed=5)
    train = pipelines.run(_cfg(db, root, "train"), device="cpu")
    index = json.loads((root / "ckpt" / "index.json").read_text())
    best = root / "ckpt" / index["best"][0]["path"]
    test = pipelines.run(dict(_cfg(db, root, "test"), ckpt_path=str(best)), device="cpu")
    return dict(root=root, db=db, train=train, test=test, best=best)


def test_core_loss_fails_in_both_packages(jobs, tmp_path):
    from nabladft_tpu import pipelines as jax_pipelines
    from nabladft_tpu.config import load_config as jax_load_config

    over = _overrides(jobs["db"], tmp_path, "train")
    with pytest.raises(ValueError, match="'core'"):
        pipelines.run(load_config(REPO / "configs" / "phisnet.yaml", overrides=over),
                      device="cpu")
    over["model"]["kwargs"] = dict(SMALL, remat=False)
    over["trainer"]["max_epochs"] = 1
    with pytest.raises(TypeError, match="NoneType"):
        jax_pipelines.run(jax_load_config(REPO / "configs" / "phisnet.yaml", overrides=over))


def test_train_job_metrics_are_finite(jobs):
    train = jobs["train"]
    assert {"val/loss", "val/hamiltonian/mae", "val/overlap/mae"} <= set(train)
    assert "val/core/mae" not in train
    assert all(np.isfinite(v) for v in train.values())
    assert train["step"] > 0 and train["epoch"] == 1


def test_trainer_settings_follow_the_jax_composition(jobs):
    trainer = pipelines.build_trainer(
        dict(_cfg(jobs["db"], jobs["root"], "train"), log_csv=False, ckpt_dir=None),
        torch.device("cpu"))
    assert trainer.cfg.loss_specs == {"hamiltonian": "rmse_mae", "overlap": "rmse_mae"}
    assert trainer.cfg.ema_decay == 0.999 and trainer.cfg.grad_clip == 10.0
    assert trainer.model.predict_core and trainer.model.layout.orbitals[17] == (
        0, 0, 0, 0, 1, 1, 1, 2)


def test_train_job_writes_checkpoints_and_csv(jobs):
    ckpt = jobs["root"] / "ckpt"
    assert (ckpt / "last.ckpt").exists() and jobs["best"].exists()
    rows = (jobs["root"] / "outputs" / "phisnet" / "metrics.csv").read_text().splitlines()
    header = rows[0].split(",")
    assert {"train/total", "train/hamiltonian", "train/overlap", "grad_norm"} <= set(header)
    assert len(rows) - 1 == jobs["train"]["step"] + 2


def test_test_job_from_best_checkpoint_equals_trainer_test(jobs):
    cfg = dict(_cfg(jobs["db"], jobs["root"], "test"), log_csv=False, ckpt_dir=None)
    trainer = pipelines.build_trainer(cfg, torch.device("cpu"))
    trainer.load_checkpoint(jobs["best"])
    want = trainer.test(pipelines.build_datamodule(cfg).test_dataloader())
    assert {"test/loss", "test/hamiltonian/mae", "test/overlap/mae"} <= set(jobs["test"])
    for k, v in want.items():
        assert jobs["test"][k] == pytest.approx(v, rel=1e-6), k


def test_predict_job_raises(jobs):
    with pytest.raises(ValueError, match="Hamiltonian"):
        pipelines.run(_cfg(jobs["db"], jobs["root"], "predict"), device="cpu")


def test_chip_smoke_phisnet_config_is_the_composed_yaml():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    want = load_config(
        REPO / "configs" / "phisnet.yaml",
        overrides={"job_type": "train",
                   "datamodule": {"source": "/db/in.db", "root": "/db"},
                   "ckpt_dir": "/db/ckpt", "output_dir": "/db/out",
                   "trainer": {"max_epochs": chip_smoke.TRAIN_EPOCHS, "log_every_n_steps": 1,
                               "loss_specs": H_AND_S}},
    )
    got = chip_smoke.train_config("/db/in.db", "/db", "/db/ckpt", "/db/out", config="phisnet")
    assert got == want


def test_cli_override_replaces_the_model_groups_specs():
    from nabladft_tpu_torch.cli import _parse_overrides

    over = _parse_overrides(["trainer.loss_specs={hamiltonian: rmse_mae, overlap: rmse_mae}"])
    assert over == {"trainer": {"loss_specs": H_AND_S}}
