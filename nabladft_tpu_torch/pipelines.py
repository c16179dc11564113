"""Job pipelines from one config: ``job_type`` train, test, predict and optimize.

The port of ``nabladft_tpu/pipelines.py``: one `run(cfg)` with config
validation, seeding, the datamodule, the model, the trainer, and the
prediction writer (the output database mirrors the input rows plus
`energy_pred` / `forces_pred` in the data blob). ``optimize`` relaxes every
molecule of ``datamodule.source`` with batched L-BFGS on the device
(`optimize/task.py`) and writes the relaxed rows to ``output_db``. `run`
executes on the card unless the caller passes ``device``; without a card
and without ``device`` it raises. On the card PaiNN, SchNet, QHNet, eSCN and
EquiformerV2 run their fused kernels unless the config pins `use_pallas`;
PaiNN and SchNet then train with the surrogate force gradient through them
(``force_grads="pallas"``); eSCN's and EquiformerV2's forces are a direct
head, trained by one backward pass. DimeNet++, Graphormer3D, GemNet-OC
and PhiSNet have no kernel of their own: DimeNet++ trains its derivative
forces by the double backward (``force_grads="direct"``), Graphormer3D's
and GemNet-OC's forces are a direct head; GemNet-OC's train job fits its
scale factors first, and its checkpoints keep them. Hamiltonian configs (``datamodule.kind: hamiltonian``; QHNet,
PhiSNet) read a local Hamiltonian DB and take the orbital basis from its
``basisset`` table; they have no predict job. `ckpt_path` takes a
checkpoint this package wrote or a flax checkpoint of the JAX package (a
TrainState: ``train`` resumes it, the other jobs take its weights and EMA).
``pretrained: <Model>_<split>`` names one of the reference's published
checkpoints: it is read from ``pretrained_dir`` (default
``checkpoints/pretrained``, as ``<name>.ckpt``) when a file whose MD5 is the
registry's etag is there, else downloaded, then converted into the
configured model (`models/pretrained.py`), whose seeded weights it replaces
in every job. ``datamodule.source`` may name a registry split, fetched into
``datamodule.root``. ``links_path`` names another registry file for both
(offline use: a file of one's own whose etags are the MD5s of the cached
files).

Under a launcher (``torchrun --nproc_per_node N -m nabladft_tpu_torch.cli
...``) `run` starts the process group the environment describes (nccl on
the card, `parallel.dist.init_from_env`) and tears it down after the job;
a group the caller started is used as it is. ``train``, ``test`` and
``predict`` then run data-parallel (TrainerConfig ``n_dp``): rank 0 writes
the checkpoints, the logs and the predictions. ``optimize`` runs in one
process only.
"""

from __future__ import annotations

import logging
import random
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from nabladft_tpu_torch.data import DataModule, EnergyDataset, HamiltonianDataset
from nabladft_tpu_torch.data.ase_codec import AseDatabase
from nabladft_tpu_torch.data.dataset import resolve_split
from nabladft_tpu_torch.data.hamiltonian_db import HamiltonianDatabase
from nabladft_tpu_torch.data.registry import CheckpointRegistry, DatasetRegistry
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models.convert import load_flax_params
from nabladft_tpu_torch.models.pretrained import get_pretrained_params
from nabladft_tpu_torch.parallel import dist
from nabladft_tpu_torch.train import (
    CSVLogger, MultiLogger, StdoutLogger, TensorBoardLogger, Trainer, TrainerConfig, WandbLogger,
    seeded_generator,
)
from nabladft_tpu_torch.utils import resolve_device

logger = logging.getLogger(__name__)

JOB_TYPES = ("train", "test", "predict", "optimize")
# the families that run fused message kernels on the card by default
FUSED_ON_CARD = ("painn", "schnet", "qhnet", "escn", "equiformer_v2")
# the families that read the orbital basis of a Hamiltonian DB
HAMILTONIAN_MODELS = ("qhnet", "phisnet")


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def check_cfg(cfg: Dict[str, Any]) -> None:
    job = cfg.get("job_type")
    if job not in JOB_TYPES:
        raise ValueError(f"job_type must be one of {JOB_TYPES}, got {job!r}")
    if cfg.get("ckpt_path") and cfg.get("pretrained"):
        raise ValueError("ckpt_path and pretrained are mutually exclusive")
    is_ham = (
        cfg.get("task", "energy") == "hamiltonian"
        or cfg.get("datamodule", {}).get("kind") == "hamiltonian"
    )
    if job == "predict" and is_ham:
        raise ValueError("predict job is not supported for Hamiltonian models")


def _dataset_registry(cfg: Dict[str, Any]) -> Optional[DatasetRegistry]:
    """The registry of `links_path`, if set, for named splits (else the
    package's)."""
    return DatasetRegistry(Path(cfg["links_path"])) if cfg.get("links_path") else None


def build_datamodule(cfg: Dict[str, Any]) -> DataModule:
    d = cfg["datamodule"]
    kind = d.get("kind", "energy")
    reg = _dataset_registry(cfg)
    if kind == "energy":
        ds = EnergyDataset(
            d["source"],
            root=d.get("root"),
            bucket_boundaries=tuple(d.get("bucket_boundaries", (32, 48, 64))),
            registry=reg,
        )
    elif kind == "hamiltonian":
        ds = HamiltonianDataset(
            d["source"],
            root=d.get("root"),
            atom_boundaries=tuple(d.get("atom_boundaries", (32, 48, 64))),
            orbital_boundaries=tuple(d.get("orbital_boundaries", (256, 384, 512, 640))),
            registry=reg,
        )
    else:
        raise ValueError(f"unknown datamodule kind {kind!r}")
    return DataModule(
        ds,
        batch_size=d.get("batch_size", 32),
        val_fraction=d.get("val_fraction", 0.1),
        seed=cfg.get("seed", 42),
        num_workers=d.get("num_workers", 1),
    )


def build_model(cfg: Dict[str, Any], device: torch.device,
                params: Optional[Mapping[str, Any]] = None):
    """The configured model on `device`: weights from the trainer seed, or
    `params` (a flax parameter tree) carried across from the JAX package, or
    the converted checkpoint that ``pretrained`` names.
    On the card the FUSED_ON_CARD families run their fused message kernels
    unless the config pins `use_pallas`. A Hamiltonian model reads the
    orbital basis from the DB's basisset table unless the config gives one."""
    m = cfg["model"]
    kwargs = dict(m.get("kwargs", {}))
    # the reference-compatible EquiformerV2 (m_share_rad False) has no kernel
    has_kernels = kwargs.get("m_share_rad", True)
    if m["name"].lower() in FUSED_ON_CARD and device.type == "cuda" and has_kernels:
        kwargs.setdefault("use_pallas", "fused")
    d = cfg.get("datamodule", {})
    if (m["name"].lower() in HAMILTONIAN_MODELS and "orbitals" not in kwargs
            and d.get("kind") == "hamiltonian"):
        src = Path(d["source"])
        if not src.exists():
            src = resolve_split("hamiltonian", d["source"], d.get("root"), _dataset_registry(cfg))
        db = HamiltonianDatabase(src)
        try:
            if db.elements():
                kwargs["orbitals"] = {z: tuple(int(l) for l in db.get_orbitals(z))
                                      for z in db.elements()}
        finally:
            db.close()
    seed = cfg.get("trainer", {}).get("seed", cfg.get("seed", 42))
    model = create_model(m["name"], device=device, generator=seeded_generator(seed), **kwargs)
    if cfg.get("pretrained"):
        links = cfg.get("links_path")
        params = get_pretrained_params(cfg["pretrained"], model,
                                       Path(cfg.get("pretrained_dir", "checkpoints/pretrained")),
                                       CheckpointRegistry(Path(links)) if links else None)
    if params is not None:
        load_flax_params(model, params)
    return model


def build_trainer(cfg: Dict[str, Any], device: torch.device,
                  params: Optional[Mapping[str, Any]] = None) -> Trainer:
    """The configured model (`build_model`) in a Trainer: the trainer group
    with the model's `trainer_overrides` (where the group leaves the key
    unset, as the JAX package), loss specs and coefficients, and stdout plus CSV loggers
    (``<output_dir>/<name>/metrics.csv``), with Wandb (``wandb.enable``, project
    ``wandb.project``) and TensorBoard (``tensorboard.enable``: ``<output_dir>/<name>/tb``)
    where the config enables them; under data parallelism rank 0 alone
    builds the loggers."""
    m = cfg["model"]
    model = build_model(cfg, device, params)
    t = dict(cfg.get("trainer", {}))
    for k, v in m.get("trainer_overrides", {}).items():
        t.setdefault(k, v)
    t.setdefault("loss_specs", m.get("loss_specs", {"energy": "l1", "forces": "l2norm"}))
    t.setdefault("loss_coefs", m.get("loss_coefs", {"energy": 1.0, "forces": 1.0}))
    if cfg.get("ckpt_dir"):
        t.setdefault("ckpt_dir", cfg["ckpt_dir"])
    if getattr(model, "use_pallas", "off") == "fused" and model.derivative_forces:
        # the fused kernels' backward is first-order: train through C and D
        t.setdefault("force_grads", "pallas")
    main = dist.is_main()
    loggers = [StdoutLogger()] if main else []
    if main and cfg.get("log_csv", True):
        out_dir = Path(cfg.get("output_dir", "outputs")) / cfg.get("name", m["name"])
        loggers.append(CSVLogger(out_dir / "metrics.csv"))
    if main and cfg.get("wandb", {}).get("enable"):
        loggers.append(WandbLogger(cfg["wandb"].get("project", "nablaDFT-tpu"),
                                   name=cfg.get("name")))
    if main and cfg.get("tensorboard", {}).get("enable"):
        out_dir = Path(cfg.get("output_dir", "outputs")) / cfg.get("name", m["name"])
        loggers.append(TensorBoardLogger(out_dir / "tb"))
    return Trainer(model, device, TrainerConfig(**t), loggers=MultiLogger(loggers))


def write_predictions_to_db(input_db: Path, output_db: Path, predictions) -> int:
    """Stream input rows to the output db with prediction fields added.

    `predictions` iterates dicts with mol_id / n_atoms / energy / forces
    (Trainer.predict output). Returns row count written.
    """
    src = AseDatabase(input_db)
    out = AseDatabase(output_db, create=True)
    n = 0
    try:
        for batch in predictions:
            energies = np.asarray(batch["energy"])
            forces = np.asarray(batch["forces"]) if "forces" in batch else None
            for i, mol_id in enumerate(np.asarray(batch["mol_id"])):
                rec = src.get(int(mol_id))
                rec.data["energy_pred"] = [float(energies[i])]
                if forces is not None:
                    na = int(batch["n_atoms"][i])
                    rec.data["forces_pred"] = forces[i][:na].astype(np.float64)
                out.write(rec)
                n += 1
    finally:
        src.close()
        out.close()
    return n


def run(cfg: Dict[str, Any], device=None,
        params: Optional[Mapping[str, Any]] = None) -> Dict[str, float]:
    """Entry point. `params` (a flax parameter tree) replaces the seeded
    initial weights. Returns, for ``train``, the last validation metrics
    plus ``step``; for ``test``, the test metrics; for ``predict``, {"rows",
    "batches", "seconds"}: rows written (by rank 0) and the wall time of the
    predict-and-write loop; for ``optimize``, the task's stats
    (`BatchwiseOptimizeTask.run`). Under a launcher, or in a process group
    the caller started, the jobs but ``optimize`` run data-parallel; a
    group this call started is torn down when it returns."""
    check_cfg(cfg)
    if cfg.get("pretrained") and params is not None:
        raise ValueError("pretrained and params are mutually exclusive")
    device = resolve_device(device)
    started = dist.init_from_env(device)
    try:
        return _run(cfg, device, params)
    finally:
        dist.destroy(started)


def _run(cfg: Dict[str, Any], device: torch.device,
         params: Optional[Mapping[str, Any]]) -> Dict[str, float]:
    job = cfg["job_type"]
    seed_everything(cfg.get("seed", 42))
    if job == "optimize":
        if dist.world_size() > 1:
            raise NotImplementedError(
                f"the optimize job runs in one process, as the JAX package's does; this one "
                f"is rank {dist.rank()} of {dist.world_size()} (a relaxation over a dp group "
                f"is optimize.lbfgs.lbfgs_relax on each rank's shard of the batch)")
        # imported here: the task builds its model through this module
        from nabladft_tpu_torch.optimize.task import run_optimize_job

        return run_optimize_job(cfg, device, params)

    dm = build_datamodule(cfg)
    trainer = build_trainer(cfg, device, params)
    ckpt_path = cfg.get("ckpt_path")
    if job == "train":
        try:
            metrics = trainer.fit(dm, ckpt_path=ckpt_path)
        finally:
            trainer.loggers.finalize()
        return dict(metrics, step=trainer.step)
    if ckpt_path:
        trainer.load_checkpoint(ckpt_path)
    if job == "test":
        try:
            metrics = trainer.test(dm.test_dataloader())
        finally:
            trainer.loggers.finalize()
        logger.info("test metrics: %s", metrics)
        return metrics
    out_db = Path(cfg.get("output_db", "predictions.db"))
    input_db = dm.dataset.path  # a named split's resolved file
    loader = dm.predict_dataloader()
    t0 = time.perf_counter()
    if dist.is_main():
        n = write_predictions_to_db(input_db, out_db, trainer.predict(loader))
    else:  # its share of every batch, gathered to rank 0, which writes
        for _ in trainer.predict(loader):
            pass
        n = 0
    dist.barrier()
    seconds = time.perf_counter() - t0
    logger.info("wrote %d prediction rows to %s", n, out_db)
    return {"rows": n, "batches": len(loader), "seconds": seconds}
