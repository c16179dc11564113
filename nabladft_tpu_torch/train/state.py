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
        return AMSGrad(params, lr=lr)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    raise KeyError(f"unknown optimizer {name!r}")


class AMSGrad(torch.optim.Optimizer):
    """optax.amsgrad: Adam's moments with the running max of the
    bias-corrected second moment (torch's ``Adam(amsgrad=True)`` keeps the
    max of the raw one, which differs while the correction is < 1):

        mu = b1 mu + (1-b1) g,  nu = b2 nu + (1-b2) g²,  t = count + 1
        nu_max = max(nu_max, nu / (1 - b2^t))
        p -= lr (mu / (1 - b1^t)) / (sqrt(nu_max) + eps)
    """

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            (b1, b2), eps, lr = group["betas"], group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"], st["nu"], st["nu_max"] = (torch.zeros_like(p) for _ in range(3))
                st["step"] += 1
                t = st["step"]
                st["mu"].mul_(b1).add_(p.grad, alpha=1.0 - b1)
                st["nu"].mul_(b2).addcmul_(p.grad, p.grad, value=1.0 - b2)
                torch.maximum(st["nu_max"], st["nu"] / (1.0 - b2 ** t), out=st["nu_max"])
                p.sub_(lr * (st["mu"] / (1.0 - b1 ** t)) / (st["nu_max"].sqrt() + eps))


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
