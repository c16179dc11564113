"""Optimizer, EMA and learning-rate access (``nabladft_tpu/train/state.py``).

The optax transforms become `torch.optim` optimizers with the same update
rules: adamw (decoupled decay, masked to rank ≥ 2 parameters with
`wd_skip_1d`), adam, amsgrad and sgd with momentum 0.9. The learning rate
lives in the optimizer's param groups, where the plateau control rewrites
it.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

NamedParams = Iterable[Tuple[str, torch.nn.Parameter]]


def build_optimizer(named_params: NamedParams, name: str, lr: float, weight_decay: float = 0.0,
                    wd_skip_1d: bool = True) -> torch.optim.Optimizer:
    params = [p for _, p in named_params if p.requires_grad]
    if name == "adamw":
        # optax.adamw(mask=...): decay only rank ≥ 2 parameters when
        # wd_skip_1d; torch's AdamW default decay (0.01) is not optax's
        decayed = [p for p in params if p.ndim > 1 or not wd_skip_1d]
        rest = [p for p in params if not (p.ndim > 1 or not wd_skip_1d)]
        groups = [{"params": decayed, "weight_decay": weight_decay}]
        if rest:
            groups.append({"params": rest, "weight_decay": 0.0})
        return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "amsgrad":
        # torch keeps the running max of the raw second moment, optax of the
        # bias-corrected one: the two differ while the correction is < 1
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, amsgrad=True)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    raise KeyError(f"unknown optimizer {name!r}")


def ema_init(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: torch.nn.Module, decay: float) -> None:
    """ema <- decay * ema + (1-decay) * params, in place (torch-ema semantics)."""
    for n, p in model.named_parameters():
        ema[n].mul_(decay).add_(p.detach(), alpha=1.0 - decay)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = float(lr)


def current_learning_rate(opt: torch.optim.Optimizer) -> Optional[float]:
    return float(opt.param_groups[0]["lr"]) if opt.param_groups else None
