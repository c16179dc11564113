"""Masked aggregation for padded batches (``nabladft_tpu/ops/segment.py``)."""

from __future__ import annotations

import torch


def masked_sum(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim`, treating mask==False entries as 0.

    mask is broadcast against x from the left (mask [B,A] vs x [B,A,F]).
    """
    while mask.dim() < x.dim():
        mask = mask[..., None]
    return torch.where(mask, x, torch.zeros_like(x)).sum(dim=dim)
