"""Batched calculator: model → (energy, forces) with unit conversion.

The port of ``nabladft_tpu/optimize/calculator.py`` (the reference's
BatchwiseCalculator, nablaDFT/optimization/calculator.py:15-134): a
`(MolBatch) -> (E, F)` callable over `models.base.forward`, converting the
model's output units to the task units (Hartree / Å). `forward` holds the
parameters fixed, so on the card PaiNN's fused backward skips its
weight-gradient stage.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models.base import forward

# conversion factors to atomic-ish task units
ENERGY_UNITS = {"Hartree": 1.0, "eV": 1.0 / 27.211386245988, "kcal/mol": 1.0 / 627.5094740631}
POSITION_UNITS = {"Ang": 1.0, "Bohr": 0.529177210903}


class BatchwiseCalculator:
    """Callable (MolBatch) -> (energy [B], forces [B,A,3]) in task units."""

    def __init__(self, model: nn.Module, energy_unit: str = "Hartree",
                 position_unit: str = "Ang"):
        self.model = model
        # model emits energy in `energy_unit` per `position_unit`;
        # convert to Hartree / Å task units (reference calculator.py:40-60)
        self.energy_scale = ENERGY_UNITS[energy_unit]
        self.force_scale = ENERGY_UNITS[energy_unit] / POSITION_UNITS[position_unit]

    def __call__(self, batch: MolBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        out = forward(self.model, batch)
        return out["energy"] * self.energy_scale, out["forces"] * self.force_scale
