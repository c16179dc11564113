"""Checkpointing: top-k on a monitored metric plus last, with resume.

The port of ``nabladft_tpu/train/checkpoints.py`` (ModelCheckpoint
semantics: save_top_k on val/loss plus save_last, resume from a path)
with the same directory layout: ``last.ckpt``, ``step<N>.ckpt`` for the top
k, ``index.json``, and ``<ckpt>.aux.json`` for the host-side scheduler state
(plateau counters). A state is a dict of tensors and plain values written
with `torch.save` and read back with ``weights_only=True``. Restoring the
JAX package's flax msgpack checkpoints is not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import json
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch


def load_state(path: Path, device=None) -> Dict[str, Any]:
    """A state this package saved. `torch.save` writes a zip archive; any
    other file (the JAX package's flax msgpack) is refused."""
    if not zipfile.is_zipfile(path):
        raise NotImplementedError(
            f"{path} is not a checkpoint of the PyTorch port; restoring the JAX package's "
            "flax msgpack checkpoints is not ported yet "
            "(ROADMAP queue 1: checkpoint and pretrained restore)")
    return torch.load(Path(path), map_location=device, weights_only=True)


def read_aux(path: Path) -> Optional[Dict[str, Any]]:
    """Host-side scheduler state saved alongside the checkpoint at `path`, if any."""
    paux = Path(path).parent / (Path(path).name + ".aux.json")
    return json.loads(paux.read_text()) if paux.exists() else None


class CheckpointManager:
    def __init__(self, directory: Path, top_k: int = 3, monitor: str = "val/loss",
                 mode: str = "min"):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.top_k = top_k
        self.monitor = monitor
        self.mode = mode
        self._index_path = self.dir / "index.json"
        self._index: Dict[str, Any] = {"best": [], "last": None}
        if self._index_path.exists():
            self._index = json.loads(self._index_path.read_text())

    def _write_index(self) -> None:
        self._index_path.write_text(json.dumps(self._index, indent=1))

    def save(self, state: Dict[str, Any], step: int, metrics: Dict[str, float],
             aux: Optional[Dict[str, Any]] = None) -> None:
        """`aux` carries host-side scheduler state (plateau counters)."""
        last_path = self.dir / "last.ckpt"
        torch.save(state, last_path)
        if aux is not None:
            (self.dir / "last.ckpt.aux.json").write_text(json.dumps(aux))
        self._index["last"] = {"path": last_path.name, "step": step, "metrics": metrics}

        score = metrics.get(self.monitor)
        if score is not None and self.top_k > 0:
            entry = {"path": f"step{step:09d}.ckpt", "step": step, "score": float(score),
                     "metrics": metrics}
            best: List[Dict] = self._index["best"]
            best.append(entry)
            best.sort(key=lambda e: e["score"], reverse=self.mode == "max")
            keep, drop = best[: self.top_k], best[self.top_k :]
            if entry in keep:
                torch.save(state, self.dir / entry["path"])
                if aux is not None:
                    (self.dir / (entry["path"] + ".aux.json")).write_text(json.dumps(aux))
            for e in drop:
                p = self.dir / e["path"]
                if p.exists() and e["path"] != entry["path"]:
                    p.unlink()
                    paux = self.dir / (e["path"] + ".aux.json")
                    if paux.exists():
                        paux.unlink()
            self._index["best"] = keep
        self._write_index()

    def read_aux(self, path: Optional[Path] = None) -> Optional[Dict[str, Any]]:
        """Host-side scheduler state saved alongside a checkpoint, if any."""
        path = Path(path) if path else self.last_path()
        return None if path is None else read_aux(path)

    def best_path(self) -> Optional[Path]:
        best = self._index.get("best") or []
        return self.dir / best[0]["path"] if best else None

    def last_path(self) -> Optional[Path]:
        last = self._index.get("last")
        return self.dir / last["path"] if last else None
