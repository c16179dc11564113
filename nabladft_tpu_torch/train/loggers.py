"""Metric loggers: stdout and CSV (``nabladft_tpu/train/loggers.py``).

The Wandb and TensorBoard backends are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import csv
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


class Logger:
    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        raise NotImplementedError

    def log_histograms(self, params, step: int) -> None:
        """Parameter histograms; only a TensorBoard backend renders them."""

    def finalize(self) -> None:
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


class MultiLogger(Logger):
    def __init__(self, loggers: List[Logger]):
        self.loggers = loggers

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def log_histograms(self, params, step: int) -> None:
        for lg in self.loggers:
            lg.log_histograms(params, step)

    def finalize(self) -> None:
        for lg in self.loggers:
            lg.finalize()
