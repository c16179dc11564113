"""The port's EquiformerV2 jobs end to end on the CPU.

configs/equiformer_v2.yaml shrunk to a small width (2 layers, l_max 2, m_max
1, 8 sphere channels, 2 heads × 4 value and 8 alpha channels, FFN 8, 8 edge
channels, 8 Gaussians, 8 neighbours) over a seeded synthetic energy DB, the
port's seeded weights passed as a flax tree in the Pallas layout:
* `job_type: predict` writes every row with `energy_pred` and
  `forces_pred` from the direct heads; one batch of them equals the JAX
  model on the same weights (its XLA path, the tree converted by
  `param_convert.eqv2_params`) within E rtol 2e-4 / atol 1e-5 and F rtol
  2e-3 / atol 2e-4 (tests/test_torch_pipeline.py's tolerances);
* `job_type: train` (two epochs, AdamW, plateau LR, energy L1 + 100 ×
  forces L2-norm) gives finite losses and metrics, a CSV row per step and
  epoch, and checkpoints; `job_type: test` from the best checkpoint gives
  what `Trainer.test` gives on the restored weights;
* dropout is drawn on train steps only (one alpha mask per attention call
  and two drop-path masks per block each step), never in validation, test
  or predict;
* EquiformerV2 is fused on the card by default and trains by one backward;
  chip_smoke.py's EquiformerV2 configs are the composed yaml with their
  overrides.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxMolBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models.param_convert import eqv2_params
from nabladft_tpu_torch import pipelines
from nabladft_tpu_torch.config import load_config
from nabladft_tpu_torch.data.ase_codec import AseDatabase
from nabladft_tpu_torch.data.synthetic import write_random_db
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.train import seeded_generator
from tests.test_torch_eqv2 import count_dropout_draws
from tests.test_torch_escn import _flax_tree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parent.parent
SMALL = dict(num_layers=2, l_max=2, m_max=1, sphere_channels=8, attn_alpha_channels=8,
             num_heads=2, attn_value_channels=4, ffn_hidden_channels=8, edge_channels=8,
             num_distance_basis=8, max_neighbors=8)
E_TOL = dict(rtol=2e-4, atol=1e-5)
F_TOL = dict(rtol=2e-3, atol=2e-4)


def _cfg(db: Path, root: Path, job: str) -> dict:
    return load_config(
        REPO / "configs" / "equiformer_v2.yaml",
        overrides={
            "job_type": job,
            "model": {"kwargs": SMALL},
            "datamodule": {"source": str(db), "root": str(root), "batch_size": 8,
                           "val_fraction": 0.25, "bucket_boundaries": [16]},
            "ckpt_dir": str(root / "ckpt"),
            "output_dir": str(root / "outputs"),
            "output_db": str(root / "predictions.db"),
            "trainer": {"max_epochs": 2, "log_every_n_steps": 1},
        },
    )


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eqv2_jobs")
    db = write_random_db(root / "in.db", n_mols=16, min_atoms=4, max_atoms=12, seed=7)
    params = _flax_tree(create_model("equiformer_v2", device="cpu",
                                     generator=seeded_generator(1), **SMALL))
    draws = {}

    def run(job, cfg, **kw):
        with pytest.MonkeyPatch.context() as mp:
            counts = count_dropout_draws(mp)
            out = pipelines.run(cfg, device="cpu", **kw)
        draws[job] = dict(counts)
        return out

    pred = run("predict", _cfg(db, root, "predict"), params=params)
    train = run("train", _cfg(db, root, "train"))
    index = json.loads((root / "ckpt" / "index.json").read_text())
    best = root / "ckpt" / index["best"][0]["path"]
    test = run("test", dict(_cfg(db, root, "test"), ckpt_path=str(best)))
    return dict(root=root, db=db, params=params, pred=pred, train=train, test=test, best=best,
                draws=draws)


def test_predict_job_writes_every_row(jobs):
    rows = list(AseDatabase(jobs["root"] / "predictions.db").select_all())
    assert jobs["pred"]["rows"] == len(rows) == 16
    for r in rows:
        assert r.data["forces_pred"].shape == (r.natoms, 3)
        assert np.isfinite(r.data["forces_pred"]).all() and np.isfinite(r.data["energy_pred"]).all()


def test_predictions_match_jax_on_one_batch(jobs):
    cfg = _cfg(jobs["db"], jobs["root"], "predict")
    batch = next(iter(pipelines.build_datamodule(cfg).predict_dataloader()))
    fields = {k: getattr(batch, k).numpy() for k in
              ("z", "pos", "node_mask", "graph_mask", "energy", "forces", "mol_id")}
    kw = dict(SMALL, cutoff=12.0)
    model = jax_create_model("equiformer_v2", use_pallas=False, remat=False, **kw)
    co = SMALL["num_heads"] * SMALL["attn_value_channels"]
    xla = eqv2_params(jobs["params"], "xla", SMALL["l_max"], SMALL["m_max"], co)
    out = jax.jit(model.apply)(xla, JaxMolBatch(**fields))
    by_id = {r.id: r for r in AseDatabase(jobs["root"] / "predictions.db").select_all()}
    n = 0
    for i, mol_id in enumerate(fields["mol_id"]):
        if not fields["graph_mask"][i]:
            continue
        rec = by_id[int(mol_id)]
        np.testing.assert_allclose(rec.data["energy_pred"][0], np.asarray(out["energy"])[i],
                                   **E_TOL)
        np.testing.assert_allclose(rec.data["forces_pred"],
                                   np.asarray(out["forces"])[i, :rec.natoms], **F_TOL)
        n += 1
    assert n > 0


def test_train_job_metrics_checkpoints_and_csv(jobs):
    train = jobs["train"]
    assert {"val/loss", "val/energy/mae", "val/forces/mae"} <= set(train)
    assert all(np.isfinite(v) for v in train.values())
    assert train["step"] > 0 and (jobs["root"] / "ckpt" / "last.ckpt").exists()
    rows = (jobs["root"] / "outputs" / "equiformer_v2" / "metrics.csv").read_text().splitlines()
    assert {"train/total", "train/energy", "train/forces", "grad_norm"} <= set(rows[0].split(","))
    assert len(rows) - 1 == train["step"] + 2


def test_test_job_from_best_checkpoint_equals_trainer_test(jobs):
    cfg = dict(_cfg(jobs["db"], jobs["root"], "test"), log_csv=False, ckpt_dir=None)
    trainer = pipelines.build_trainer(cfg, torch.device("cpu"))
    trainer.load_checkpoint(jobs["best"])
    want = trainer.test(pipelines.build_datamodule(cfg).test_dataloader())
    assert {"test/loss", "test/energy/mae", "test/forces/mae"} <= set(jobs["test"])
    for k, v in want.items():
        assert jobs["test"][k] == pytest.approx(v, rel=1e-6), k


def test_dropout_is_drawn_on_train_steps_only(jobs):
    n, steps = SMALL["num_layers"], jobs["train"]["step"]
    assert jobs["draws"]["train"] == {"alpha": steps * (n + 1), "drop_path": steps * 2 * n}
    assert jobs["draws"]["predict"] == jobs["draws"]["test"] == {"alpha": 0, "drop_path": 0}


def test_fused_eqv2_trains_by_one_backward(jobs):
    """Unpinned, EquiformerV2 runs the plain attention on the CPU; pinned to
    the fused attention (the card's default, FUSED_ON_CARD) its trainer
    takes the loss's plain backward: the forces are a direct head."""
    cfg = dict(_cfg(jobs["db"], jobs["root"], "train"), log_csv=False, ckpt_dir=None)
    assert "equiformer_v2" in pipelines.FUSED_ON_CARD
    assert pipelines.build_model(cfg, torch.device("cpu")).use_pallas == "off"
    fused = dict(cfg, model=dict(cfg["model"], kwargs=dict(SMALL, use_pallas="fused")))
    trainer = pipelines.build_trainer(fused, torch.device("cpu"))
    assert trainer.model.use_pallas == "fused" and trainer._force_grads == "direct"
    assert not trainer._uses_forces()
    assert trainer._dropout_gen is not None


def test_chip_smoke_eqv2_configs_are_the_composed_yaml():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    dm = {"source": "/db/in.db", "root": "/db"}
    want = load_config(REPO / "configs" / "equiformer_v2.yaml",
                       overrides={"job_type": "predict", "output_db": "/db/out.db",
                                  "datamodule": dm})
    got = chip_smoke.smoke_config("/db/in.db", "/db/out.db", "/db", config="equiformer_v2")
    assert got == want
    want_train = load_config(
        REPO / "configs" / "equiformer_v2.yaml",
        overrides={"job_type": "train", "ckpt_dir": "/db/ckpt", "output_dir": "/db/out",
                   "trainer": {"max_epochs": chip_smoke.TRAIN_EPOCHS, "log_every_n_steps": 1},
                   "datamodule": dm},
    )
    got = chip_smoke.train_config("/db/in.db", "/db", "/db/ckpt", "/db/out",
                                  config="equiformer_v2")
    assert got == want_train
