"""Learning-rate schedules (``nabladft_tpu/train/schedulers.py``).

`constant` and `plateau` are ported. ReduceLROnPlateau is host-driven (it
depends on the validation metric): a multiplier the Trainer folds into the
optimizer's learning rate between epochs. The step-indexed schedules
(linear, polynomial, cosine, multistep) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PlateauState:
    """ReduceLROnPlateau bookkeeping (reference default: factor 0.8,
    patience 10, min_lr 1e-6)."""

    factor: float = 0.8
    patience: int = 10
    min_lr: float = 1e-6
    best: float = float("inf")
    bad_epochs: int = 0
    multiplier: float = 1.0

    def step(self, metric: float, base_lr: float) -> float:
        """Record a validation metric; returns the new effective LR."""
        if metric < self.best - 1e-12:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.multiplier *= self.factor
                self.bad_epochs = 0
        return max(base_lr * self.multiplier, self.min_lr)


def build_schedule(kind: str, base_lr: float, total_steps: int, warmup_steps: int = 0,
                   **kwargs) -> None:
    """None for 'constant' / 'plateau' (plateau is applied host-side)."""
    if kind in ("constant", "plateau"):
        return None
    if kind in ("linear", "polynomial", "cosine", "multistep"):
        raise NotImplementedError(
            f"the {kind!r} schedule is not ported yet (ROADMAP queue 1, item 5)")
    raise KeyError(f"unknown schedule {kind!r}")
