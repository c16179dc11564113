"""Mask-aware losses (``nabladft_tpu/train/losses.py``).

  * energy L1 / MSE over real molecules;
  * forces L1 / MSE per component, and `l2norm`: the mean over real atoms
    of the per-atom force-error 2-norm (GemNet's `L2Loss`, not a squared
    loss).

  * Hamiltonian / overlap / core: RMSE + MAE over the masked matrix entries
    (qhnet/loss.py), on the full matrix or on the model's block space.

Every function reduces over real elements only and returns a scalar;
`multitask_loss` combines them with weights and the optional max-error gate;
a matrix target the batch does not carry raises ValueError.

Each loss is built from sums over real elements and their count (`SUMS`).
Under data parallelism (`parallel.dist`, a world of more than one rank)
each rank holds a shard of the global batch, and `multitask_loss` /
`global_loss` add those sums and counts over the ranks (one collective,
without gradient), so that (a) the value is the global batch's loss on
every rank, and (b) the parameter gradients, summed over the ranks, are the
gradient of that loss, as JAX's jit over a dp-sharded batch computes. The
value is the global one, the gradient that of the rank's own share: the
sums that are linear in the predictions over the global count, and for
RMSE + MAE S_r / (2 n sqrt(S / n + eps)) + A_r / n with the global S, whose
gradients add up to that of sqrt(S / n + eps) + A / n. The max-error gate
compares the global MAE. In a world of one the losses are computed as
before, to the bit.

Over a dp×mp grid (`dist.make_grid`; `multitask_loss`'s `grid`) each rank
holds the molecules of its dp index, as every other rank of its mp group
does, and takes its mp index's block of orbital rows of each matrix
target (prediction, target and pair mask: `dist.shard_orbital_rows`), as
JAX shards the dense [B, O, O] matrices P("dp", "mp"). The matrix sums
and counts are then added over the whole grid. A molecule or atom sum
(energy, forces) is the same on every mp rank of a dp index, so it counts
once: mp index 0 contributes it and the other mp ranks a zero (times the
sum, so that its gradient share is zero there too), and the same
collective over the grid adds it over the dp axis alone. The parameter
gradients summed over the grid (`dist.all_reduce_grads`) are then the
global batch's. `dist.ALONE` computes the plain loss inside a group.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from nabladft_tpu_torch.parallel import dist

_EPS = 1e-12


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.clamp(den, min=1.0)


def _masked(err, mask):
    return torch.where(mask, err, torch.zeros_like(err))


# each loss's sums over real elements, its count last
def _energy_l1_sums(pred, target, graph_mask):
    return _masked(torch.abs(pred - target), graph_mask).sum(), graph_mask.sum()


def _energy_mse_sums(pred, target, graph_mask):
    return _masked((pred - target) ** 2, graph_mask).sum(), graph_mask.sum()


def _forces_l1_sums(pred, target, node_mask):
    return (torch.abs(pred - target) * node_mask[..., None]).sum(), 3.0 * node_mask.sum()


def _forces_mse_sums(pred, target, node_mask):
    return ((pred - target) ** 2 * node_mask[..., None]).sum(), 3.0 * node_mask.sum()


def _forces_l2norm_sums(pred, target, node_mask):
    norm = torch.sqrt(((pred - target) ** 2).sum(dim=-1) + _EPS)
    return _masked(norm, node_mask).sum(), node_mask.sum()


def _matrix_rmse_mae_sums(pred, target, pair_mask):
    diff = _masked(pred - target, pair_mask)
    return (diff * diff).sum(), diff.abs().sum(), pair_mask.sum()


def _matrix_mae_sums(pred, target, pair_mask):
    return _masked(pred - target, pair_mask).abs().sum(), pair_mask.sum()


def _rmse_mae(sq, ab, n):
    n = torch.clamp(n, min=1.0)
    return torch.sqrt(sq / n + _EPS) + ab / n


def _rmse_mae_share(local, glob):
    """A rank's share of RMSE + MAE: its gradient is that of the global
    loss with respect to the rank's predictions."""
    (sq_r, ab_r, _), (sq, _, n) = local, glob
    n = torch.clamp(n, min=1.0)
    return sq_r / (2.0 * n * torch.sqrt(sq / n + _EPS)) + ab_r / n


def _mean_share(local, glob):
    return _safe_div(local[0], glob[-1])


SUMS: Dict[str, Callable] = {
    "energy_l1": _energy_l1_sums,
    "energy_mse": _energy_mse_sums,
    "forces_l1": _forces_l1_sums,
    "forces_mse": _forces_mse_sums,
    "forces_l2norm": _forces_l2norm_sums,
    "matrix_rmse_mae": _matrix_rmse_mae_sums,
    "matrix_mae": _matrix_mae_sums,
}


def _value(name: str, sums: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    return _rmse_mae(*sums) if name == "matrix_rmse_mae" else _safe_div(*sums)


def _share(name: str, local, glob) -> torch.Tensor:
    return (_rmse_mae_share if name == "matrix_rmse_mae" else _mean_share)(local, glob)


def energy_l1(pred, target, graph_mask) -> torch.Tensor:
    return _value("energy_l1", _energy_l1_sums(pred, target, graph_mask))


def energy_mse(pred, target, graph_mask) -> torch.Tensor:
    return _value("energy_mse", _energy_mse_sums(pred, target, graph_mask))


def forces_l1(pred, target, node_mask) -> torch.Tensor:
    """Component-wise MAE over real atoms (torch.nn.L1Loss semantics)."""
    return _value("forces_l1", _forces_l1_sums(pred, target, node_mask))


def forces_mse(pred, target, node_mask) -> torch.Tensor:
    return _value("forces_mse", _forces_mse_sums(pred, target, node_mask))


def forces_l2norm(pred, target, node_mask) -> torch.Tensor:
    """Per-atom error-vector 2-norm, averaged over real atoms."""
    return _value("forces_l2norm", _forces_l2norm_sums(pred, target, node_mask))


def matrix_rmse_mae(pred, target, pair_mask) -> torch.Tensor:
    """RMSE + MAE over masked matrix entries (qhnet/loss.py:5-16)."""
    return _value("matrix_rmse_mae", _matrix_rmse_mae_sums(pred, target, pair_mask))


def matrix_mae(pred, target, pair_mask) -> torch.Tensor:
    return _value("matrix_mae", _matrix_mae_sums(pred, target, pair_mask))


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


def _shared(names, local, grid=None):
    """Each loss's value from its sums over the world or `grid` (see the
    module docstring): the plain value in a world of one."""
    if (dist.world_size() if grid is None else grid.size) == 1:
        return [_value(n, sums) for n, sums in zip(names, local)]
    if grid is not None and grid.mp_index > 0:  # molecule sums: mp index 0's
        local = [sums if n.startswith("matrix") else tuple(t * 0 for t in sums)
                 for n, sums in zip(names, local)]
    flat = dist.all_reduce_sums([t for sums in local for t in sums])
    out = []
    for n, sums in zip(names, local):
        glob, flat = tuple(flat[:len(sums)]), flat[len(sums):]
        share = _share(n, sums, glob)
        out.append(_value(n, glob) + (share - share.detach()))
    return out


def global_loss(name: str, pred, target, mask) -> torch.Tensor:
    """`LOSS_FNS[name]` of the global batch, of which this rank holds a
    shard (the plain loss in a world of one)."""
    return _shared([name], [SUMS[name](pred, target, mask)])[0]


def multitask_loss(
    out: Dict[str, torch.Tensor],
    batch,
    loss_specs: Dict[str, str],
    loss_coefs: Dict[str, float],
    max_errors: Optional[Dict[str, float]] = None,
    grid: Optional[dist.Grid] = None,
) -> Dict[str, torch.Tensor]:
    """Weighted multi-task loss: {"total": scalar, "<target>": scalar}.

    loss_specs: target -> loss kind, e.g. {"energy": "l1", "forces": "l2norm"}.
    max_errors: optional per-target MAE clamp: a target whose batch MAE
    exceeds its clamp adds nothing to the total this step (its value is
    still reported). Under data parallelism every value, and the gate, is
    the global batch's (one collective for all of them). grid: the dp×mp
    grid whose mp axis splits the matrix targets' rows (see the module
    docstring); None: every rank of the world is a dp rank.
    """
    split_rows = grid is not None and grid.n_mp > 1
    names, local, coefs = [], [], []
    for target, kind in loss_specs.items():
        if target == "energy":
            pred, tgt, mask, l1 = out["energy"], batch.energy, batch.graph_mask, "energy_l1"
        elif target == "forces":
            pred, tgt, mask, l1 = out["forces"], batch.forces, batch.node_mask, "forces_l1"
        elif target in ("hamiltonian", "overlap", "core"):
            if getattr(batch, target, None) is None:
                raise ValueError(
                    f"loss target {target!r}: the batch carries no {target} matrix, since the "
                    f"datamodule does not read it from the database (the Hamiltonian dataset "
                    f"reads the core matrix only when built with include_core=True, which "
                    f"the pipeline's datamodule never asks for); drop {target!r} from loss_specs")
            (pred, tgt, mask), l1 = matrix_target(out, batch, target), "matrix_mae"
            if split_rows:  # this rank's block of orbital rows
                sl = dist.shard_orbital_rows(pred.shape[1], grid)
                pred, tgt, mask = pred[:, sl], tgt[:, sl], mask[:, sl]
        else:
            raise KeyError(f"unknown loss target {target!r}")
        family = "matrix" if target in ("hamiltonian", "overlap", "core") else target
        name = f"{family}_{kind}"
        if name not in LOSS_FNS:
            raise KeyError(name)
        names.append(name)
        local.append(SUMS[name](pred, tgt, mask))
        coefs.append(loss_coefs.get(target, 1.0))
        if max_errors and target in max_errors:
            names.append(l1)
            local.append(tuple(t.detach() for t in SUMS[l1](pred, tgt, mask)))
    values = iter(_shared(names, local, grid))
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for target, coef in zip(loss_specs, coefs):
        val = losses[target] = next(values)
        if max_errors and target in max_errors:
            # hard gate, no gradient through the comparison
            gate = (next(values) <= max_errors[target]).to(val.dtype).detach()
            total = total + coef * gate * val
        else:
            total = total + coef * val
    losses["total"] = total if torch.is_tensor(total) else torch.tensor(total)
    return losses
