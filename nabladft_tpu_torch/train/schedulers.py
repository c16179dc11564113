"""Learning-rate schedules (``nabladft_tpu/train/schedulers.py``).

ReduceLROnPlateau is host-driven (it depends on the validation metric): a
multiplier the Trainer folds into the optimizer's learning rate between
epochs. The step-indexed schedules map the count of applied updates to a
rate: linear and polynomial warmup-decay (HF-style), cosine with warmup
(optax's `warmup_cosine_decay_schedule`) and multistep with warmup
(optax's `piecewise_constant_schedule` after a linear warmup), their
formulas written out as the JAX package evaluates them: in float32, at
the optimizer's int32 update count. `Lookahead` (PhiSNet's legacy trainer)
wraps the optimizer the Trainer builds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]


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


_f32 = np.float32


def linear_warmup_decay(base_lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """0 → base over the warmup, then linearly back to 0 at total_steps."""

    def schedule(step: int) -> float:
        warm = _f32(step) / _f32(max(1, warmup_steps))
        decay = _f32(total_steps - step) / _f32(max(1, total_steps - warmup_steps))
        return float(_f32(base_lr) * np.clip(min(warm, decay), _f32(0.0), _f32(1.0)))

    return schedule


def polynomial_warmup_decay(base_lr: float, warmup_steps: int, total_steps: int,
                            lr_end: float = 1e-7, power: float = 1.0) -> Schedule:
    """HF-style polynomial decay to lr_end after a linear warmup."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return _warm(base_lr, step, warmup_steps)
        frac = _f32(1.0) - _f32(step - warmup_steps) / _f32(max(1, total_steps - warmup_steps))
        frac = np.clip(frac, _f32(0.0), _f32(1.0))
        return float(_f32(base_lr - lr_end) * frac ** _f32(power) + _f32(lr_end))

    return schedule


def cosine_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                  min_lr_factor: float = 0.01) -> Schedule:
    """optax.warmup_cosine_decay_schedule: base·0.01 → base linearly over
    max(1, warmup_steps), then a cosine to base·min_lr_factor at
    max(2, total_steps)."""
    init, end = base_lr * 0.01, base_lr * min_lr_factor
    warm = max(1, warmup_steps)
    decay_steps = max(2, total_steps) - warm
    if decay_steps <= 0:
        raise ValueError(
            f"the cosine schedule needs total_steps > warmup_steps, got decay_steps={decay_steps}")
    alpha = 0.0 if base_lr == 0.0 else end / base_lr

    def schedule(step: int) -> float:
        if step < warm:  # optax.linear_schedule(init, base, warm)
            frac = _f32(1.0) - _f32(min(max(step, 0), warm)) / _f32(warm)
            return float(_f32(init - base_lr) * frac + _f32(base_lr))
        count = min(_f32(step - warm), _f32(decay_steps))
        cosine = _f32(0.5) * (_f32(1.0) + np.cos(_f32(math.pi) * count / _f32(decay_steps)))
        return float(_f32(base_lr) * (_f32(1.0 - alpha) * cosine + _f32(alpha)))

    return schedule


def multistep_warmup(base_lr: float, warmup_steps: int, milestones: Sequence[int],
                     gamma: float = 0.1) -> Schedule:
    """A linear warmup, then base × gamma per milestone reached
    (optax.piecewise_constant_schedule)."""
    bounds = sorted({int(m) for m in milestones})

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return _warm(base_lr, step, warmup_steps)
        v = _f32(base_lr)
        for threshold in bounds:
            if step >= threshold:
                v = _f32(gamma) * v
        return float(v)

    return schedule


def _warm(base_lr: float, step: int, warmup_steps: int) -> float:
    return float(_f32(base_lr) * _f32(step) / _f32(max(1, warmup_steps)))


def build_schedule(kind: str, base_lr: float, total_steps: int, warmup_steps: int = 0,
                   **kwargs) -> Optional[Schedule]:
    """None for 'constant' / 'plateau' (plateau is applied host-side)."""
    if kind in ("constant", "plateau"):
        return None
    if kind == "linear":
        return linear_warmup_decay(base_lr, warmup_steps, total_steps)
    if kind == "polynomial":
        return polynomial_warmup_decay(base_lr, warmup_steps, total_steps, **kwargs)
    if kind == "cosine":
        return cosine_warmup(base_lr, warmup_steps, total_steps, **kwargs)
    if kind == "multistep":
        return multistep_warmup(base_lr, warmup_steps, **kwargs)
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
