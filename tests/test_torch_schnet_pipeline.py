"""The port's SchNet jobs end to end, against the JAX package.

configs/schnet.yaml shrunk to a small width (hidden 16, 2 interactions, 8
RBF), on seeded DBs, with the same initial weights (JAX's seeded init
carried across with load_flax_params):
* `job_type: predict`: the same rows, `energy_pred` and `forces_pred`
  within the parity tolerances of tests/test_torch_pipeline.py;
* `job_type: train` (two epochs of AdamW with the plateau LR, loss energy
  MSE + forces MSE) and then `job_type: test` from the port's best
  checkpoint, against JAX's fit and `Trainer.test`: metrics within rel 1e-4
  (tests/train/test_engine.py);
* chip_smoke.py's SchNet predict and train configs equal
  configs/schnet.yaml with their overrides.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu import pipelines as jax_pipelines
from nabladft_tpu_torch import pipelines
from nabladft_tpu_torch.config import load_config
from nabladft_tpu_torch.data.ase_codec import AseDatabase
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
E_TOL = dict(rtol=2e-4, atol=1e-5)
F_TOL = dict(rtol=2e-3, atol=2e-4)
METRIC_REL = 1e-4


def _cfg(db: Path, root: Path, job: str, sub: str) -> dict:
    return load_config(
        REPO / "configs" / "schnet.yaml",
        overrides={
            "job_type": job,
            "model": {"kwargs": SMALL},
            "datamodule": {"source": str(db), "root": str(root), "batch_size": 8,
                           "bucket_boundaries": [32]},
            "ckpt_dir": str(root / sub / "ckpt"),
            "output_dir": str(root / sub / "outputs"),
            "output_db": str(root / sub / "predictions.db"),
            "trainer": {"max_epochs": 2, "n_dp": 1, "log_every_n_steps": 1},
        },
    )


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_schnet")
    return root, write_random_db(root / "in.db", n_mols=24, min_atoms=5, max_atoms=30, seed=3)


@pytest.fixture(scope="module")
def runs(db):
    """The JAX and port runs of predict (initial weights) and train → test."""
    root, src = db
    jcfg = _cfg(src, root, "train", "jax")
    dm = jax_pipelines.build_datamodule(jcfg)
    jt = jax_pipelines.build_trainer(jcfg, dm)
    jt.init_state(next(iter(dm.val_dataloader())))
    params = jax.device_get(jt.state.params)
    jax_pipelines.run(dict(_cfg(src, root, "predict", "jax"), log_csv=False))
    jax_val = jt.fit(dm)
    jax_test = jt.test(dm.test_dataloader())
    jt.loggers.finalize()

    pred = pipelines.run(_cfg(src, root, "predict", "torch"), device="cpu", params=params)
    train = pipelines.run(_cfg(src, root, "train", "torch"), device="cpu", params=params)
    index = json.loads((root / "torch" / "ckpt" / "index.json").read_text())
    best = root / "torch" / "ckpt" / index["best"][0]["path"]
    test = pipelines.run(dict(_cfg(src, root, "test", "torch"), ckpt_path=str(best)),
                         device="cpu")
    rows = [list(AseDatabase(root / sub / "predictions.db").select_all())
            for sub in ("jax", "torch")]
    return dict(jax_val=jax_val, jax_test=jax_test, jax_steps=int(jt.state.step), pred=pred,
                rows=rows, train=train, test=test)


def test_predict_job_matches_jax(runs):
    jrows, trows = runs["rows"]
    assert runs["pred"]["rows"] == len(jrows) == len(trows) == 24
    for j, t in zip(jrows, trows):
        np.testing.assert_array_equal(t.numbers, j.numbers)
        assert t.data["forces_pred"].shape == (t.natoms, 3)
        np.testing.assert_allclose(t.data["forces_pred"], j.data["forces_pred"], **F_TOL)
    np.testing.assert_allclose([t.data["energy_pred"][0] for t in trows],
                               [j.data["energy_pred"][0] for j in jrows], **E_TOL)


@pytest.mark.parametrize("key", ["val/loss", "val/energy/mae", "val/forces/mae"])
def test_train_job_val_metrics_match_jax(runs, key):
    assert runs["train"]["step"] == runs["jax_steps"] > 0
    assert runs["train"][key] == pytest.approx(runs["jax_val"][key], rel=METRIC_REL)


@pytest.mark.parametrize("key", ["test/loss", "test/energy/mae", "test/forces/mae"])
def test_test_job_from_best_checkpoint_matches_jax(runs, key):
    assert runs["test"][key] == pytest.approx(runs["jax_test"][key], rel=METRIC_REL)


def test_chip_smoke_schnet_configs_are_the_composed_yaml():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    db = {"datamodule": {"source": "/db/in.db", "root": "/db"}}
    want = load_config(REPO / "configs" / "schnet.yaml",
                       overrides={"job_type": "predict", "output_db": "/db/out.db", **db})
    assert chip_smoke.smoke_config("/db/in.db", "/db/out.db", "/db", config="schnet") == want
    want_train = load_config(
        REPO / "configs" / "schnet.yaml",
        overrides={"job_type": "train", "ckpt_dir": "/db/ckpt", "output_dir": "/db/out",
                   "trainer": {"max_epochs": chip_smoke.TRAIN_EPOCHS, "log_every_n_steps": 1},
                   **db},
    )
    got = chip_smoke.train_config("/db/in.db", "/db", "/db/ckpt", "/db/out", config="schnet")
    assert got == want_train


def test_fused_schnet_trains_through_the_dual_kernels_by_default(db):
    """A SchNet config left unpinned runs the plain module on the CPU; pinned
    to the fused message (the card's default, FUSED_ON_CARD), its trainer
    takes the surrogate force gradient through kernels G and H."""
    root, src = db
    cfg = dict(_cfg(src, root, "train", "pinned"), log_csv=False)
    assert "schnet" in pipelines.FUSED_ON_CARD
    assert pipelines.build_model(cfg, torch.device("cpu")).use_pallas == "off"
    fused = dict(cfg, model=dict(cfg["model"], kwargs=dict(SMALL, use_pallas="fused")))
    trainer = pipelines.build_trainer(fused, torch.device("cpu"))
    assert trainer.model.use_pallas == "fused" and trainer._force_grads == "pallas"
