"""Mask-aware energy and force losses (``nabladft_tpu/train/losses.py``).

  * energy L1 / MSE over real molecules;
  * forces L1 / MSE per component, and `l2norm`: the mean over real atoms
    of the per-atom force-error 2-norm (GemNet's `L2Loss`, not a squared
    loss).

Every function reduces over real elements only and returns a scalar;
`multitask_loss` combines them with weights and the optional max-error gate.
The Hamiltonian losses come with the Hamiltonian path (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

_EPS = 1e-12


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.clamp(den, min=1.0)


def energy_l1(pred, target, graph_mask) -> torch.Tensor:
    err = torch.abs(pred - target)
    return _safe_div(torch.where(graph_mask, err, torch.zeros_like(err)).sum(), graph_mask.sum())


def energy_mse(pred, target, graph_mask) -> torch.Tensor:
    err = (pred - target) ** 2
    return _safe_div(torch.where(graph_mask, err, torch.zeros_like(err)).sum(), graph_mask.sum())


def forces_l1(pred, target, node_mask) -> torch.Tensor:
    """Component-wise MAE over real atoms (torch.nn.L1Loss semantics)."""
    err = torch.abs(pred - target) * node_mask[..., None]
    return _safe_div(err.sum(), 3.0 * node_mask.sum())


def forces_mse(pred, target, node_mask) -> torch.Tensor:
    err = (pred - target) ** 2 * node_mask[..., None]
    return _safe_div(err.sum(), 3.0 * node_mask.sum())


def forces_l2norm(pred, target, node_mask) -> torch.Tensor:
    """Per-atom error-vector 2-norm, averaged over real atoms."""
    norm = torch.sqrt(((pred - target) ** 2).sum(dim=-1) + _EPS)
    return _safe_div(torch.where(node_mask, norm, torch.zeros_like(norm)).sum(), node_mask.sum())


LOSS_FNS = {
    "energy_l1": energy_l1,
    "energy_mse": energy_mse,
    "forces_l1": forces_l1,
    "forces_mse": forces_mse,
    "forces_l2norm": forces_l2norm,
}


def multitask_loss(
    out: Dict[str, torch.Tensor],
    batch,
    loss_specs: Dict[str, str],
    loss_coefs: Dict[str, float],
    max_errors: Optional[Dict[str, float]] = None,
) -> Dict[str, torch.Tensor]:
    """Weighted multi-task loss: {"total": scalar, "<target>": scalar}.

    loss_specs: target -> loss kind, e.g. {"energy": "l1", "forces": "l2norm"}.
    max_errors: optional per-target MAE clamp: a target whose batch MAE
    exceeds its clamp adds nothing to the total this step (its value is
    still reported).
    """
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for target, kind in loss_specs.items():
        if target == "energy":
            pred, tgt, mask, l1 = out["energy"], batch.energy, batch.graph_mask, energy_l1
        elif target == "forces":
            pred, tgt, mask, l1 = out["forces"], batch.forces, batch.node_mask, forces_l1
        elif target in ("hamiltonian", "overlap", "core"):
            raise NotImplementedError(
                f"the {target} loss is not ported yet (ROADMAP queue 1, item 9)")
        else:
            raise KeyError(f"unknown loss target {target!r}")
        val = LOSS_FNS[f"{target}_{kind}"](pred, tgt, mask)
        losses[target] = val
        coef = loss_coefs.get(target, 1.0)
        if max_errors and target in max_errors:
            # hard gate, no gradient through the comparison
            gate = (l1(pred, tgt, mask) <= max_errors[target]).to(val.dtype).detach()
            total = total + coef * gate * val
        else:
            total = total + coef * val
    losses["total"] = total if torch.is_tensor(total) else torch.tensor(total)
    return losses
