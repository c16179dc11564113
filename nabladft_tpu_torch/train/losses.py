"""Mask-aware losses (``nabladft_tpu/train/losses.py``).

  * energy L1 / MSE over real molecules;
  * forces L1 / MSE per component, and `l2norm`: the mean over real atoms
    of the per-atom force-error 2-norm (GemNet's `L2Loss`, not a squared
    loss).

  * Hamiltonian / overlap / core: RMSE + MAE over the masked matrix entries
    (qhnet/loss.py), on the full matrix or on the model's block space.

Every function reduces over real elements only and returns a scalar;
`multitask_loss` combines them with weights and the optional max-error gate.
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


def matrix_rmse_mae(pred, target, pair_mask) -> torch.Tensor:
    """RMSE + MAE over masked matrix entries (qhnet/loss.py:5-16)."""
    diff = torch.where(pair_mask, pred - target, torch.zeros_like(pred))
    n = torch.clamp(pair_mask.sum(), min=1.0)
    return torch.sqrt((diff * diff).sum() / n + _EPS) + diff.abs().sum() / n


def matrix_mae(pred, target, pair_mask) -> torch.Tensor:
    diff = torch.where(pair_mask, pred - target, torch.zeros_like(pred))
    return diff.abs().sum() / torch.clamp(pair_mask.sum(), min=1.0)


def block_target_matrix(target_mat, idx, valid, graph_mask):
    """The target matrix gathered into the model's block-space super-matrix
    form. idx / valid [B,A,R]: per (atom, generic slot) orbital index and
    validity. Returns (tgt [B,AR,AR], mask [B,AR,AR]); every valid orbital
    pair appears exactly once, so masked losses and metrics over this space
    equal the full-matrix ones."""
    b, a, r = idx.shape
    flat = idx.reshape(b, a * r)
    rows = torch.gather(target_mat, 1, flat[:, :, None].expand(b, a * r, target_mat.shape[2]))
    tgt = torch.gather(rows, 2, flat[:, None, :].expand(b, a * r, a * r))
    vm = valid.reshape(b, a * r)
    return tgt, vm[:, :, None] & vm[:, None, :] & graph_mask[:, None, None]


def matrix_target(out: Dict[str, torch.Tensor], batch, target: str):
    """(prediction, target, mask) of a matrix target, from the full matrix
    `out[target]` or the block space `out[target + "_blocks"]`."""
    if target not in out and f"{target}_blocks" in out:
        tgt, pm = block_target_matrix(getattr(batch, target), out["block_index"],
                                      out["block_valid"], batch.graph_mask)
        return out[f"{target}_blocks"], tgt, pm
    pm = batch.orb_mask[:, :, None] & batch.orb_mask[:, None, :] & batch.graph_mask[:, None, None]
    return out[target], getattr(batch, target), pm


LOSS_FNS = {
    "energy_l1": energy_l1,
    "energy_mse": energy_mse,
    "forces_l1": forces_l1,
    "forces_mse": forces_mse,
    "forces_l2norm": forces_l2norm,
    "matrix_rmse_mae": matrix_rmse_mae,
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
            (pred, tgt, mask), l1 = matrix_target(out, batch, target), matrix_mae
        else:
            raise KeyError(f"unknown loss target {target!r}")
        family = "matrix" if target in ("hamiltonian", "overlap", "core") else target
        val = LOSS_FNS[f"{family}_{kind}"](pred, tgt, mask)
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
