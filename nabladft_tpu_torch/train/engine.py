"""The predict engine.

The predict part of ``nabladft_tpu/train/engine.py``: one step runs the
model and takes forces by autograd (`models.base.forward`), and `predict`
yields per-batch host outputs with padding molecules dropped. Weights are
the model's own: drawn from a seeded ``torch.Generator`` when the model is
built, or carried across from the JAX package. Training, the EMA swap and
checkpoint restore are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator

import numpy as np
import torch
from torch import nn

from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models.base import ModelOutput, forward
from nabladft_tpu_torch.utils import resolve_device


def seeded_generator(seed: int) -> torch.Generator:
    """The CPU generator model weights are drawn from."""
    return torch.Generator(device="cpu").manual_seed(int(seed))


class Trainer:
    """predict over a model on one device (the card unless named)."""

    def __init__(self, model: nn.Module, device=None):
        self.device = resolve_device(device)
        # frozen weights: forces need d/dpos only, so the fused message's
        # backward skips its weight-gradient stage (needs_input_grad)
        self.model = model.to(self.device).eval().requires_grad_(False)

    def _predict_step(self, batch: MolBatch) -> ModelOutput:
        return forward(self.model, batch)

    def predict(self, loader: Iterable[MolBatch]) -> Iterator[Dict[str, np.ndarray]]:
        """Yields per-batch host outputs with padding molecules removed, plus
        `mol_id` and `n_atoms`."""
        for batch in loader:
            out = self._predict_step(batch.to(self.device))
            keep = batch.graph_mask.numpy()
            host = {name: t.cpu().numpy()[keep] for name, t in out.items()}
            host["mol_id"] = batch.mol_id.numpy()[keep]
            host["n_atoms"] = batch.n_atoms.numpy()[keep]
            yield host
