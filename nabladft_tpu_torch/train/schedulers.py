"""Learning-rate schedules (``nabladft_tpu/train/schedulers.py``).

`constant` and `plateau` are ported. ReduceLROnPlateau is host-driven (it
depends on the validation metric): a multiplier the Trainer folds into the
optimizer's learning rate between epochs. The step-indexed schedules
(linear, polynomial, cosine, multistep) are not ported yet. `Lookahead`
(PhiSNet's legacy trainer) wraps the optimizer the Trainer builds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch


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
            f"the {kind!r} schedule is not ported yet (ROADMAP queue 1: trainer remainders)")
    raise KeyError(f"unknown schedule {kind!r}")


class Lookahead:
    """Lookahead (Zhang et al. 2019) around a torch optimizer, as the JAX
    package's `lookahead(k, alpha)` chained after the inner optimizer: every
    k-th step of the inner optimizer the weights are pulled toward the slow
    copy, p <- slow + alpha (p - slow), and the slow copy syncs to p.

    The count is the inner optimizer's (optax's): a step the Trainer's
    non-finite guard skips never reaches `step`. The slow copy is part of
    `state_dict`, as it is of the JAX optimizer state. The learning rate is
    the inner optimizer's (`param_groups`).
    """

    def __init__(self, optimizer: torch.optim.Optimizer, k: int = 5, alpha: float = 0.5):
        if k < 1:
            raise ValueError(f"lookahead k must be >= 1, got {k}")
        self.optimizer, self.k, self.alpha = optimizer, int(k), float(alpha)
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.slow = [p.detach().clone() for p in self.params]
        self.count = 0

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @torch.no_grad()
    def step(self) -> None:
        self.optimizer.step()
        self.count += 1
        if self.count % self.k == 0:
            for p, s in zip(self.params, self.slow):
                s.add_(p - s, alpha=self.alpha)
                p.copy_(s)

    def state_dict(self) -> Dict[str, Any]:
        return {"inner": self.optimizer.state_dict(), "count": self.count,
                "slow": [s.clone() for s in self.slow]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state["inner"])
        self.count = int(state["count"])
        for s, t in zip(self.slow, state["slow"]):
            s.copy_(t)
