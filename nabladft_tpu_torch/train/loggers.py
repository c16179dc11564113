"""Metric loggers (``nabladft_tpu/train/loggers.py``): stdout and CSV, and
the optional Wandb and TensorBoard backends (``wandb.enable`` /
``tensorboard.enable`` in a config), each importing its package only when
built. Metric names, steps and histogram tags are the JAX package's.
Under data parallelism only rank 0 logs (`pipelines.build_trainer` builds
the backends there alone; the Trainer gives other ranks a `NullLogger`).
"""

from __future__ import annotations

import csv
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

logger = logging.getLogger(__name__)


class Logger:
    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        raise NotImplementedError

    def log_hyperparams(self, params: Dict) -> None:
        pass

    def log_histograms(self, params, step: int) -> None:
        """Parameter histograms of a flax-layout tree (nested dicts of
        arrays, `convert.flax_params_of`); only TensorBoard renders them."""

    def finalize(self) -> None:
        pass


class NullLogger(Logger):
    """Logs nothing: the loggers of every rank but 0 under data parallelism."""

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        pass


class StdoutLogger(Logger):
    def __init__(self, every_n: int = 1):
        self.every_n = every_n
        self._n = 0

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        self._n += 1
        if self._n % self.every_n == 0:
            msg = "  ".join(f"{k}={v:.4e}" for k, v in sorted(metrics.items()))
            logger.info("[step %d] %s", step, msg)


class CSVLogger(Logger):
    """One row per call, columns the union of all keys seen (the file is
    rewritten with a wider header when a new key appears)."""

    def __init__(self, path: Path):
        self.path = Path(path)  # its directory is made at the first row
        self._fieldnames: Optional[List[str]] = None
        self._file = None
        self._writer = None

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        row = {"step": step, "time": time.time(), **metrics}
        if self._writer is None or any(k not in self._fieldnames for k in row):
            names = sorted(set(row) | set(self._fieldnames or []))
            old_rows = []
            if self._file is not None:
                self._file.close()
                with open(self.path) as f:
                    old_rows = list(csv.DictReader(f))
            self._fieldnames = names
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._file = open(self.path, "w", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=names, restval="")
            self._writer.writeheader()
            for r in old_rows:
                self._writer.writerow(r)
        self._writer.writerow(row)
        self._file.flush()

    def finalize(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
            self._writer = None


class WandbLogger(Logger):
    """The reference's default logger (config/loggers/wandb.yaml): one run,
    finished on `finalize`."""

    def __init__(self, project: str, name: Optional[str] = None, **kwargs):
        import wandb  # an optional dependency, imported when enabled

        self._run = wandb.init(project=project, name=name, **kwargs)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        self._run.log(metrics, step=step)

    def log_hyperparams(self, params: Dict) -> None:
        self._run.config.update(params, allow_val_change=True)

    def finalize(self) -> None:
        self._run.finish()


def _flat_tree(node, sep: str, prefix: str = "") -> Dict[str, Any]:
    """{"a<sep>b<sep>c": leaf} of a nested dict."""
    if not isinstance(node, Mapping):
        return {prefix: node}
    out: Dict[str, Any] = {}
    for k, v in node.items():
        out.update(_flat_tree(v, sep, f"{prefix}{sep}{k}" if prefix else str(k)))
    return out


class TensorBoardLogger(Logger):
    """Scalars, hyperparameters and parameter histograms in TensorBoard
    event files under `log_dir` (torch's SummaryWriter, which needs the
    `tensorboard` package): the JAX package's tags."""

    def __init__(self, log_dir: Path):
        from torch.utils.tensorboard import SummaryWriter  # needs `tensorboard`

        Path(log_dir).mkdir(parents=True, exist_ok=True)
        self._writer = SummaryWriter(log_dir=str(log_dir))

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for k, v in metrics.items():
            self._writer.add_scalar(k, float(v), global_step=step)

    def log_hyperparams(self, params: Dict) -> None:
        flat = {k: v if isinstance(v, (int, float, bool)) else str(v)
                for k, v in _flat_tree(params or {}, ".").items()}
        if flat:
            self._writer.add_hparams(flat, {"hparams/recorded": 1.0}, run_name=".")

    def log_histograms(self, params, step: int) -> None:
        for name, leaf in _flat_tree(params, "/").items():
            arr = np.asarray(leaf, dtype=np.float32)
            if arr.size:
                self._writer.add_histogram(f"params/{name}", arr, global_step=step)

    def finalize(self) -> None:
        self._writer.flush()
        self._writer.close()


class MultiLogger(Logger):
    def __init__(self, loggers: List[Logger]):
        self.loggers = loggers

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def log_hyperparams(self, params: Dict) -> None:
        for lg in self.loggers:
            lg.log_hyperparams(params)

    def log_histograms(self, params, step: int) -> None:
        for lg in self.loggers:
            lg.log_histograms(params, step)

    def finalize(self) -> None:
        for lg in self.loggers:
            lg.finalize()
