"""Streaming metrics as (sum, count) accumulators (``nabladft_tpu/train/metrics.py``).

Each eval step returns per-batch absolute-error sums and element counts;
the host adds them up and `compute()` divides once at epoch end: a mean over
all elements, not a mean of batch means (torchmetrics' "global" averaging).
"""

from __future__ import annotations

from typing import Dict

import torch

from nabladft_tpu_torch.train.losses import matrix_target


def batch_metric_sums(out: Dict[str, torch.Tensor], batch) -> Dict[str, torch.Tensor]:
    """Per-batch absolute-error sums and element counts for energy, forces
    and the matrix targets the batch carries (full matrix or block space)."""
    sums: Dict[str, torch.Tensor] = {}
    if "energy" in out:
        err = torch.abs(out["energy"] - batch.energy)
        sums["energy/abs_sum"] = torch.where(batch.graph_mask, err, torch.zeros_like(err)).sum()
        sums["energy/count"] = batch.graph_mask.sum().float()
    if "forces" in out:
        err = torch.abs(out["forces"] - batch.forces) * batch.node_mask[..., None]
        sums["forces/abs_sum"] = err.sum()
        sums["forces/count"] = 3.0 * batch.node_mask.sum().float()
    for target in ("hamiltonian", "overlap", "core"):
        if getattr(batch, target, None) is None or not (
                target in out or f"{target}_blocks" in out):
            continue
        pred, tgt, pm = matrix_target(out, batch, target)
        err = torch.abs(pred - tgt)
        sums[f"{target}/abs_sum"] = torch.where(pm, err, torch.zeros_like(err)).sum()
        sums[f"{target}/count"] = pm.sum().float()
    return sums


class MetricAccumulator:
    """Host-side accumulation of the sums returned by the eval step."""

    def __init__(self):
        self._sums: Dict[str, float] = {}

    def update(self, sums: Dict[str, torch.Tensor]) -> None:
        for k, v in sums.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)

    def compute(self) -> Dict[str, float]:
        out = {}
        for k, v in self._sums.items():
            if k.endswith("/abs_sum"):
                target = k[: -len("/abs_sum")]
                out[f"{target}/mae"] = v / max(self._sums.get(f"{target}/count", 0.0), 1.0)
        return out
