"""The port's DimeNet++, Graphormer3D and GemNet-OC jobs end to end on the CPU.

configs/dimenetplusplus.yaml, configs/graphormer3d.yaml and
configs/gemnet-oc.yaml shrunk to small widths (DimeNet++ hidden 16, two
blocks; Graphormer3D one block of two layers, 32 dim, 4 heads; GemNet-OC one
block, emb 16 / 32) over one seeded synthetic energy DB, per family:
* `job_type: predict` writes every row with `energy_pred` and
  `forces_pred`, finite;
* `job_type: train` (two epochs) gives finite losses and metrics, a CSV
  row per step and epoch, and checkpoints; `job_type: test` from the best
  checkpoint gives what `Trainer.test` gives on the restored weights;
* DimeNet++ trains its derivative forces by the double backward
  (force_grads "direct"); Graphormer3D's forces are a direct head and its
  dropout is drawn on train steps only (2 + 3 × layer calls + 2 masks a
  step at these rates, counted as the `torch.rand` calls on the trainer's
  generator), never in validation, test or predict; GemNet-OC's forces are
  a direct head too, and its checkpoints hold the scale factors the train
  job fitted (the other families have none);
* chip_smoke.py's configs are the composed yaml with its overrides.
"""

import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

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
FAMILIES = {
    "dimenetplusplus": dict(hidden=16, num_blocks=2, int_emb_size=8, basis_emb_size=4,
                            out_emb_channels=16, num_spherical=3, num_radial=3,
                            max_neighbors=6, node_latent_dim=8),
    "graphormer3d": dict(blocks=1, layers=2, embed_dim=32, ffn_embed_dim=32, attention_heads=4,
                         num_kernel=8),
    "gemnet-oc": dict(num_blocks=1, emb_size_atom=16, emb_size_edge=32, emb_size_trip_in=8,
                      emb_size_trip_out=8, emb_size_quad_in=8, emb_size_quad_out=8,
                      emb_size_cbf=8, num_radial=16, num_spherical=4, num_spherical_quad=3,
                      max_neighbors=7, max_neighbors_qint=4),
}


def _cfg(config: str, db: Path, root: Path, job: str) -> dict:
    return load_config(
        REPO / "configs" / f"{config}.yaml",
        overrides={
            "job_type": job,
            "model": {"kwargs": FAMILIES[config]},
            "datamodule": {"source": str(db), "root": str(root), "batch_size": 4,
                           "val_fraction": 0.25, "bucket_boundaries": [12]},
            "ckpt_dir": str(root / "ckpt"),
            "output_dir": str(root / "outputs"),
            "output_db": str(root / "predictions.db"),
            "trainer": {"max_epochs": 2, "log_every_n_steps": 1},
        },
    )


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def jobs(request, tmp_path_factory):
    config = request.param
    root = tmp_path_factory.mktemp(f"torch_{config}_jobs")
    db = write_random_db(root / "in.db", n_mols=12, min_atoms=4, max_atoms=10, seed=7)
    draws, calls, rand = {}, [], torch.rand

    def counting(*args, generator=None, **kwargs):
        calls.append(generator)
        return rand(*args, generator=generator, **kwargs)

    def run(job, cfg):
        calls.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch, "rand", counting)
            out = pipelines.run(cfg, device="cpu")
        assert all(isinstance(g, torch.Generator) for g in calls)
        draws[job] = len(calls)
        return out

    pred = run("predict", _cfg(config, db, root, "predict"))
    train = run("train", _cfg(config, db, root, "train"))
    index = json.loads((root / "ckpt" / "index.json").read_text())
    best = root / "ckpt" / index["best"][0]["path"]
    test = run("test", dict(_cfg(config, db, root, "test"), ckpt_path=str(best)))
    return dict(config=config, root=root, db=db, pred=pred, train=train, test=test, best=best,
                draws=draws)


def test_predict_job_writes_every_row(jobs):
    rows = list(AseDatabase(jobs["root"] / "predictions.db").select_all())
    assert jobs["pred"]["rows"] == len(rows) == 12
    for r in rows:
        assert r.data["forces_pred"].shape == (r.natoms, 3)
        assert np.isfinite(r.data["forces_pred"]).all() and np.isfinite(r.data["energy_pred"]).all()


def test_train_job_metrics_checkpoints_and_csv(jobs):
    train = jobs["train"]
    assert {"val/loss", "val/energy/mae", "val/forces/mae"} <= set(train)
    assert all(np.isfinite(v) for v in train.values())
    assert train["step"] > 0 and (jobs["root"] / "ckpt" / "last.ckpt").exists()
    name = load_config(REPO / "configs" / f"{jobs['config']}.yaml")["name"]
    rows = (jobs["root"] / "outputs" / name / "metrics.csv").read_text().splitlines()
    assert {"train/total", "train/energy", "train/forces", "grad_norm"} <= set(rows[0].split(","))
    assert len(rows) - 1 == train["step"] + 2


def test_test_job_from_best_checkpoint_equals_trainer_test(jobs):
    cfg = dict(_cfg(jobs["config"], jobs["db"], jobs["root"], "test"), log_csv=False,
               ckpt_dir=None)
    trainer = pipelines.build_trainer(cfg, torch.device("cpu"))
    trainer.load_checkpoint(jobs["best"])
    want = trainer.test(pipelines.build_datamodule(cfg).test_dataloader())
    assert {"test/loss", "test/energy/mae", "test/forces/mae"} <= set(jobs["test"])
    for k, v in want.items():
        assert jobs["test"][k] == pytest.approx(v, rel=1e-6), k


def test_force_training_route_and_dropout(jobs):
    cfg = dict(_cfg(jobs["config"], jobs["db"], jobs["root"], "train"), log_csv=False,
               ckpt_dir=None)
    trainer = pipelines.build_trainer(cfg, torch.device("cpu"))
    assert trainer._force_grads == "direct"
    if jobs["config"] in ("dimenetplusplus", "gemnet-oc"):
        assert trainer._uses_forces() == (jobs["config"] == "dimenetplusplus")
        assert trainer._dropout_gen is None
        assert jobs["draws"] == {"predict": 0, "train": 0, "test": 0}
        return
    assert not trainer._uses_forces() and trainer._dropout_gen is not None
    kw = FAMILIES["graphormer3d"]
    per_step = 1 + 3 * kw["blocks"] * kw["layers"] + 2
    assert jobs["draws"] == {"predict": 0, "train": per_step * jobs["train"]["step"], "test": 0}


def test_checkpoints_hold_the_fitted_scale_factors(jobs):
    """Every checkpoint of the train job holds the same scale factors: for
    GemNet-OC the values its fit gave (not 1), which a fresh refit of the
    first train batches from the seeded weights reproduces."""
    cfg = dict(_cfg(jobs["config"], jobs["db"], jobs["root"], "train"), log_csv=False,
               ckpt_dir=None)
    model = pipelines.build_model(cfg, torch.device("cpu"))
    names = sorted(model.scale_factors()) if hasattr(model, "scale_factors") else []
    assert bool(names) == (jobs["config"] == "gemnet-oc")
    ckpts = sorted((jobs["root"] / "ckpt").glob("*.ckpt"))
    assert jobs["best"] in ckpts and len(ckpts) >= 2
    saved = [torch.load(p, weights_only=True)["model"] for p in ckpts]
    if not names:
        return
    from nabladft_tpu_torch.models.gemnet_oc import fit_scale_factors

    dm = pipelines.build_datamodule(cfg)
    n_fit = pipelines.build_trainer(cfg, torch.device("cpu")).cfg.scale_fit_batches
    batches = list(itertools.islice(dm.train_dataloader(), n_fit))
    want = fit_scale_factors(model, batches).scale_factors()
    for state in saved:
        for n in names:
            assert state[n].item() == want[n].item() != 1.0, n


def test_gemnet_oc_cli_runs_train_test_and_predict(tmp_path):
    """`python -m nabladft_tpu_torch.cli --config configs/gemnet-oc.yaml`:
    train, test from the best checkpoint and predict on the CPU when asked
    for; without a card and without `--device` it raises."""
    from nabladft_tpu_torch import cli

    db = write_random_db(tmp_path / "in.db", n_mols=8, min_atoms=4, max_atoms=8, seed=3)
    small = [f"model.kwargs.{k}={v}" for k, v in FAMILIES["gemnet-oc"].items()]
    config = ["--config", str(REPO / "configs" / "gemnet-oc.yaml")]
    common = [f"datamodule.source={db}", f"datamodule.root={tmp_path}",
              "datamodule.batch_size=4", "datamodule.val_fraction=0.25",
              "datamodule.bucket_boundaries=[8]", f"ckpt_dir={tmp_path / 'ckpt'}",
              f"output_dir={tmp_path / 'outputs'}", *small]
    cpu = [*config, "--device", "cpu", *common]
    assert cli.main([*cpu, "job_type=train", "trainer.max_epochs=1"]) == 0
    index = json.loads((tmp_path / "ckpt" / "index.json").read_text())
    best = tmp_path / "ckpt" / index["best"][0]["path"]
    assert cli.main([*cpu, "job_type=test", f"ckpt_path={best}"]) == 0
    out = tmp_path / "predictions.db"
    assert cli.main([*cpu, "job_type=predict", f"ckpt_path={best}", f"output_db={out}"]) == 0
    rows = list(AseDatabase(out).select_all())
    assert len(rows) == 8 and all(np.isfinite(r.data["forces_pred"]).all() for r in rows)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([*config, *common, "job_type=test", f"ckpt_path={best}"])


@pytest.mark.parametrize("config", sorted(FAMILIES))
def test_chip_smoke_configs_are_the_composed_yaml(config):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    dm = {"source": "/db/in.db", "root": "/db"}
    want = load_config(REPO / "configs" / f"{config}.yaml",
                       overrides={"job_type": "predict", "output_db": "/db/out.db",
                                  "datamodule": dm})
    assert chip_smoke.smoke_config("/db/in.db", "/db/out.db", "/db", config=config) == want
    want_train = load_config(
        REPO / "configs" / f"{config}.yaml",
        overrides={"job_type": "train", "ckpt_dir": "/db/ckpt", "output_dir": "/db/out",
                   "trainer": {"max_epochs": chip_smoke.TRAIN_EPOCHS, "log_every_n_steps": 1},
                   "datamodule": dm},
    )
    got = chip_smoke.train_config("/db/in.db", "/db", "/db/ckpt", "/db/out", config=config)
    assert got == want_train
