"""Job pipelines from one config: ``job_type: predict`` so far.

The port of ``nabladft_tpu/pipelines.py``: one `run(cfg)` with config
validation, seeding, the datamodule, the model, and the prediction writer
(the output database mirrors the input rows plus `energy_pred` /
`forces_pred` in the data blob). `run` executes on the card unless the
caller passes ``device``; without a card and without ``device`` it raises.
"""

from __future__ import annotations

import logging
import random
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from nabladft_tpu_torch.data import DataModule, EnergyDataset
from nabladft_tpu_torch.data.ase_codec import AseDatabase
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models.convert import load_flax_params
from nabladft_tpu_torch.train import Trainer, seeded_generator
from nabladft_tpu_torch.utils import resolve_device

logger = logging.getLogger(__name__)

JOB_TYPES = ("train", "test", "predict", "optimize")
_NOT_PORTED = {
    "train": "the trainer (ROADMAP queue 1, item 5)",
    "test": "the test job (ROADMAP queue 1, item 5)",
    "optimize": "the optimize job (ROADMAP queue 1, item 7)",
}


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


def build_datamodule(cfg: Dict[str, Any]) -> DataModule:
    d = cfg["datamodule"]
    kind = d.get("kind", "energy")
    if kind != "energy":
        raise NotImplementedError(f"datamodule kind {kind!r} is not ported yet (ROADMAP)")
    ds = EnergyDataset(
        d["source"],
        root=d.get("root"),
        bucket_boundaries=tuple(d.get("bucket_boundaries", (32, 48, 64))),
    )
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
    `params` (a flax parameter tree) carried across from the JAX package.
    On the card PaiNN runs its fused message kernels unless the config
    pins `use_pallas`."""
    m = cfg["model"]
    kwargs = dict(m.get("kwargs", {}))
    if m["name"].lower() == "painn" and device.type == "cuda":
        kwargs.setdefault("use_pallas", "fused")
    seed = cfg.get("trainer", {}).get("seed", cfg.get("seed", 42))
    model = create_model(m["name"], device=device, generator=seeded_generator(seed), **kwargs)
    if params is not None:
        load_flax_params(model, params)
    return model


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
    """Entry point. For ``predict`` returns {"rows", "batches", "seconds"}:
    rows written and the wall time of the predict-and-write loop."""
    check_cfg(cfg)
    job = cfg["job_type"]
    if job in _NOT_PORTED:
        raise NotImplementedError(
            f"job_type {job!r} is not ported to PyTorch yet: {_NOT_PORTED[job]}")
    if cfg.get("ckpt_path") or cfg.get("pretrained"):
        raise NotImplementedError(
            "checkpoint / pretrained restore is not ported yet (ROADMAP queue 1); "
            "pass flax params to run(cfg, params=...) instead")
    device = resolve_device(device)
    seed_everything(cfg.get("seed", 42))

    dm = build_datamodule(cfg)
    trainer = Trainer(build_model(cfg, device, params), device)
    out_db = Path(cfg.get("output_db", "predictions.db"))
    input_db = Path(cfg["datamodule"]["source"])
    loader = dm.predict_dataloader()
    t0 = time.perf_counter()
    n = write_predictions_to_db(input_db, out_db, trainer.predict(loader))
    seconds = time.perf_counter() - t0
    logger.info("wrote %d prediction rows to %s", n, out_db)
    return {"rows": n, "batches": len(loader), "seconds": seconds}
