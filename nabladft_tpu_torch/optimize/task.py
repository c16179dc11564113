"""Batchwise optimisation job: database → relaxation on the device → database.

The port of ``nabladft_tpu/optimize/task.py`` (the reference's
BatchwiseOptimizeTask, optimization/task.py:9-73): iterate the input ASE
database in atom-count buckets, relax each batch on the device, and write
the relaxed structures with the model's final energy and forces
(``data["model_energy"]`` / ``data["model_forces"]``) into the output
database in input-row order, every input row's key-value pairs and data
kept. Trajectories (extxyz) and the pickle restart follow the JAX package.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from nabladft_tpu_torch import pipelines
from nabladft_tpu_torch.data.ase_codec import AseDatabase, AtomsRecord
from nabladft_tpu_torch.data.dataset import BucketedLoader, EnergyDataset, LoaderConfig
from nabladft_tpu_torch.optimize.calculator import BatchwiseCalculator
from nabladft_tpu_torch.optimize.lbfgs import lbfgs_relax, load_state, relax_chunked, save_state
from nabladft_tpu_torch.models.convert import load_flax_params
from nabladft_tpu_torch.train.checkpoints import is_flax_state, load_state as load_checkpoint
from nabladft_tpu_torch.utils import resolve_device
from nabladft_tpu_torch.utils.xyz import write_extxyz

logger = logging.getLogger(__name__)


class BatchwiseOptimizeTask:
    def __init__(
        self,
        input_db: Path,
        output_db: Path,
        calculator: BatchwiseCalculator,
        batch_size: int = 32,
        fmax: float = 0.05,
        steps: int = 500,
        memory: int = 100,
        maxstep: float = 0.2,
        bucket_boundaries=(32, 48, 64),
        trajectory_dir: Optional[Path] = None,
        trajectory_interval: int = 0,
        restart_path: Optional[Path] = None,
        line_search: str = "off",
        device=None,
        root: Optional[Path] = None,
    ):
        # trajectory_dir: write per-molecule extxyz trajectories. With
        # trajectory_interval == 0 only endpoints are written (initial +
        # relaxed); with interval N > 0 the loop runs in N-step chunks and
        # every chunk's frame is appended (the reference's per-step dump,
        # optimizers.py:269-277, at a configurable stride).
        # restart_path: pickle of (batch index, solver state) after every
        # chunk; rerunning with the same path resumes mid-run (reference
        # optimizers.py:283-290). The batches run on `device` (the card
        # unless the caller names another); `root` is the datasets root
        # (where the input's column cache goes when the DB lies outside it
        # and the working directory).
        self.trajectory_dir = Path(trajectory_dir) if trajectory_dir else None
        self.trajectory_interval = int(trajectory_interval)
        self.restart_path = Path(restart_path) if restart_path else None
        self.input_db = Path(input_db)
        self.output_db = Path(output_db)
        self.calculator = calculator
        self.batch_size = batch_size
        self.fmax = fmax
        self.steps = steps
        self.kw = dict(memory=memory, maxstep=maxstep, line_search=line_search)
        self.bucket_boundaries = bucket_boundaries
        self.device = resolve_device(device)
        self.root = root

    def _relax_batch(self, host, batch, batch_index: int):
        """One relaxation of the device `batch`, or chunked with trajectory /
        restart; `host` is the same batch on the CPU."""
        if self.trajectory_interval <= 0 and self.restart_path is None:
            return lbfgs_relax(self.calculator, batch, fmax=self.fmax, max_steps=self.steps,
                               **self.kw)
        frames = {}
        real = np.flatnonzero(host.graph_mask.numpy())

        def on_chunk(it, st):
            pos = st.pos.cpu().numpy()
            e = st.energy.cpu().numpy()
            for slot in real:
                frames.setdefault(slot, []).append((pos[slot].copy(), float(e[slot])))
            if self.restart_path is not None:
                save_state(st, self.restart_path)
                self.restart_path.with_suffix(".meta").write_text(str(batch_index))

        resume = None
        if self.restart_path is not None and self.restart_path.exists():
            meta = self.restart_path.with_suffix(".meta")
            if meta.exists() and int(meta.read_text()) == batch_index:
                resume = load_state(self.restart_path, self.device)
        result, _ = relax_chunked(
            self.calculator, batch, fmax=self.fmax, max_steps=self.steps,
            interval=max(self.trajectory_interval, 1) if self.trajectory_interval
            else self.steps,
            on_chunk=on_chunk, resume_state=resume, **self.kw,
        )
        if self.trajectory_dir is not None and self.trajectory_interval > 0:
            self.trajectory_dir.mkdir(parents=True, exist_ok=True)
            for slot, frs in frames.items():
                n = int(host.node_mask[slot].sum())
                write_extxyz(
                    self.trajectory_dir / f"mol_{int(host.mol_id[slot])}.extxyz",
                    host.z[slot][:n].numpy(),
                    [f[0][:n] for f in frs],
                    energies=[f[1] for f in frs],
                )
        return result

    def run(self) -> Dict[str, Any]:
        """Relax every molecule; returns n_molecules, n_converged,
        converged_fraction, total_lbfgs_steps (summed over batches), and
        batches and seconds (the wall time of the relax-and-write loop)."""
        dataset = EnergyDataset(str(self.input_db), root=self.root,
                                bucket_boundaries=self.bucket_boundaries)
        loader = BucketedLoader(
            dataset,
            config=LoaderConfig(batch_size=self.batch_size, shuffle=False, drop_last=False),
        )
        src = AseDatabase(self.input_db)
        out = AseDatabase(self.output_db, create=True)
        n_done, n_converged, total_steps, n_batches = 0, 0, 0, 0
        results: Dict[int, AtomsRecord] = {}
        t0 = time.perf_counter()
        try:
            for batch_index, host in enumerate(loader):
                result = self._relax_batch(host, host.to(self.device), batch_index)
                pos = result.pos.cpu().numpy()
                energy = result.energy.cpu().numpy()
                forces = result.forces.cpu().numpy()
                converged = result.converged.cpu().numpy()
                total_steps += int(result.nsteps)
                n_batches += 1
                for slot in np.flatnonzero(host.graph_mask.numpy()):
                    mol_id = int(host.mol_id[slot])
                    n = int(host.node_mask[slot].sum())
                    rec = src.get(mol_id)
                    data = dict(rec.data)
                    data["model_energy"] = [float(energy[slot])]
                    data["model_forces"] = forces[slot][:n].astype(np.float64)
                    results[mol_id] = AtomsRecord(
                        numbers=rec.numbers,
                        positions=pos[slot][:n].astype(np.float64),
                        cell=rec.cell,
                        pbc=rec.pbc,
                        key_value_pairs=rec.key_value_pairs,
                        data=data,
                    )
                    if self.trajectory_dir is not None and self.trajectory_interval == 0:
                        self.trajectory_dir.mkdir(parents=True, exist_ok=True)
                        write_extxyz(
                            self.trajectory_dir / f"mol_{mol_id}.extxyz",
                            rec.numbers,
                            [rec.positions, pos[slot][:n]],
                            energies=[float("nan"), float(energy[slot])],
                        )
                    n_done += 1
                    n_converged += int(converged[slot])
            # write in input-row order (reference task.py iterates input order)
            for mol_id in sorted(results):
                out.write(results[mol_id])
        finally:
            src.close()
            out.close()
        stats = {
            "n_molecules": n_done,
            "n_converged": n_converged,
            "converged_fraction": n_converged / max(n_done, 1),
            "total_lbfgs_steps": total_steps,
            "batches": n_batches,
            "seconds": time.perf_counter() - t0,
        }
        logger.info("optimize finished: %s", stats)
        return stats


def build_optimize_model(cfg: Dict[str, Any], device: torch.device,
                         params: Optional[Mapping[str, Any]] = None) -> nn.Module:
    """The optimize job's model on `device`, in eval mode: the configured
    model (`pipelines.build_model`: on the card the fused kernels unless
    ``optimize.use_pallas: false`` pins the plain path; `params` a flax
    parameter tree carried across) with the parameters of `ckpt_path`: a
    checkpoint this package's trainer wrote (its "model" entry, not the
    EMA) or a flax checkpoint of the JAX package (a whole TrainState gives
    up its params, as the JAX job's restore). Float32 models only."""
    if cfg["model"].get("kwargs", {}).get("compute_dtype", "float32") != "float32":
        raise NotImplementedError("the optimize job relaxes a float32 model; a bf16 model's "
                                  "relaxation is not ported (ROADMAP queue 1: the bf16 optimize job)")
    if not cfg.get("optimize", {}).get("use_pallas", True):
        m = cfg["model"]
        cfg = dict(cfg, model=dict(m, kwargs=dict(m.get("kwargs", {}), use_pallas="off")))
    model = pipelines.build_model(cfg, device, params)
    ckpt_path = cfg.get("ckpt_path")
    if ckpt_path:
        state = load_checkpoint(Path(ckpt_path), device)
        if is_flax_state(state):
            load_flax_params(model, state["params"])
        else:
            model.load_state_dict(state["model"])
    return model.eval()


def run_optimize_job(cfg: Dict[str, Any], device=None,
                     params: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """Pipeline entry for ``job_type: optimize``: `build_optimize_model`
    relaxing the DB of ``datamodule.source`` into ``output_db``."""
    device = resolve_device(device)
    o = cfg.get("optimize", {})
    calc = BatchwiseCalculator(
        build_optimize_model(cfg, device, params),
        energy_unit=o.get("energy_unit", "Hartree"),
        position_unit=o.get("position_unit", "Ang"),
    )
    task = BatchwiseOptimizeTask(
        input_db=Path(cfg["datamodule"]["source"]),
        output_db=Path(cfg.get("output_db", "optimized.db")),
        calculator=calc,
        batch_size=o.get("batch_size", 32),
        fmax=o.get("fmax", 0.05),
        steps=o.get("steps", 500),
        memory=o.get("memory", 100),
        maxstep=o.get("maxstep", 0.2),
        bucket_boundaries=tuple(o.get("bucket_boundaries", (32, 48, 64))),
        trajectory_dir=o.get("trajectory_dir"),
        trajectory_interval=o.get("trajectory_interval", 0),
        restart_path=o.get("restart_path"),
        line_search=o.get("line_search", "off"),
        device=device,
        root=cfg["datamodule"].get("root"),
    )
    return task.run()
