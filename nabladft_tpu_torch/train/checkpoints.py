"""Checkpointing: top-k on a monitored metric plus last, with resume.

The port of ``nabladft_tpu/train/checkpoints.py`` (ModelCheckpoint
semantics: save_top_k on val/loss plus save_last, resume from a path)
with the same directory layout: ``last.ckpt``, ``step<N>.ckpt`` for the top
k, ``index.json``, and ``<ckpt>.aux.json`` for the host-side scheduler state
(plateau counters). A state is a dict of tensors and plain values written
with `torch.save` and read back with ``weights_only=True``. `load_state`
also reads the JAX package's checkpoints (its `CheckpointManager` writes a
flax TrainState with ``flax.serialization.to_bytes``): `load_flax_state`
returns that TrainState as a dict of numpy trees, which the Trainer and the
optimize job map onto the module and its optimizer. The aux files are the
same JSON in both packages. Under data parallelism every rank keeps the
index, rank 0 alone writes the files, and every rank waits for them
(a barrier) before it goes on.
"""

from __future__ import annotations

import json
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from nabladft_tpu_torch.parallel import dist
from nabladft_tpu_torch.utils import msgpack


def load_flax_state(path: Path) -> Dict[str, Any]:
    """A flax TrainState the JAX package wrote, as a dict: ``step``,
    ``params`` (the variables: "params" and, for GemNet-OC, its fitted
    "scales"), ``opt_state`` (the optax chain's state, namedtuples as dicts
    of their fields, tuples as dicts keyed "0", "1", ...) and
    ``ema_params`` (None without EMA); numpy leaves. A bare variables dict
    (`save_params`) comes back as ``{"params": variables}``."""
    tree = msgpack.load(Path(path))
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path} is msgpack but holds no flax TrainState or variables")
    if "step" not in tree and "opt_state" not in tree:
        tree = {"params": tree}
    return tree


def is_flax_state(state: Dict[str, Any]) -> bool:
    """Whether a state from `load_state` came from a flax checkpoint."""
    return "model" not in state and "params" in state


def load_state(path: Path, device=None) -> Dict[str, Any]:
    """A checkpoint: one this package saved (a `torch.save` zip archive), or
    the JAX package's flax msgpack (`load_flax_state`; tell them apart with
    `is_flax_state`). Any other file is refused."""
    path = Path(path)
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location=device, weights_only=True)
    if msgpack.opens_a_map(path):
        return load_flax_state(path)
    raise ValueError(f"{path} is neither a checkpoint of this package (a torch.save zip archive) "
                     "nor a flax msgpack checkpoint of the JAX package")


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

    def save(self, state: Dict[str, Any], step: int, metrics: Dict[str, float],
             aux: Optional[Dict[str, Any]] = None) -> None:
        """`aux` carries host-side scheduler state (plateau counters)."""
        try:
            self._save(state, step, metrics, aux, write=dist.is_main())
        finally:
            dist.barrier()

    def _save(self, state, step, metrics, aux, write: bool) -> None:
        last_path = self.dir / "last.ckpt"
        if write:
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
            if write and entry in keep:
                torch.save(state, self.dir / entry["path"])
                if aux is not None:
                    (self.dir / (entry["path"] + ".aux.json")).write_text(json.dumps(aux))
            for e in drop if write else ():
                p = self.dir / e["path"]
                if p.exists() and e["path"] != entry["path"]:
                    p.unlink()
                    paux = self.dir / (e["path"] + ".aux.json")
                    if paux.exists():
                        paux.unlink()
            self._index["best"] = keep
        if write:
            self._index_path.write_text(json.dumps(self._index, indent=1))

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
