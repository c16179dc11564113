"""Dense molecular graph construction over padded batches.

The molecular half of ``nabladft_tpu/ops/graph.py``: molecules here are
≤ 62 atoms, so the all-pairs distance matrix is built densely on the device
every step and neighbour caps are masks, not ragged lists. Conventions kept
from the JAX package: diff[b,i,j] = pos[j] - pos[i], masked distances are
`_BIG`, and `dense_topk_mask` keeps every edge within 1e-7 of the k-th
distance. eSCN's and EquiformerV2's fixed-K `neighbor_list` (strict top-k,
ties to the lower index as `lax.top_k`, K = min(max_neighbors, A) unpadded),
its scatter back onto the dense pair lattice, the node gather along it and
the edge frames' axis vectors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_EPS = 1e-10
_BIG = 1e10


class DenseGraph(NamedTuple):
    """All-pairs view. diff[b,i,j] = pos[j] - pos[i]."""

    diff: torch.Tensor  # [B, A, A, 3]
    dist: torch.Tensor  # [B, A, A]   (= _BIG on masked pairs)
    adj: torch.Tensor  # [B, A, A] bool: within cutoff, i != j, both real


def pairwise(
    pos: torch.Tensor, node_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pairwise displacement/distance with padding masked out.

    Returns (diff [B,A,A,3], dist [B,A,A], pair_mask [B,A,A]) where
    pair_mask excludes self-pairs and any pair touching a padded atom.
    Masked entries of dist are _BIG (not 0) so top-k ordering is trivial.
    """
    diff = pos[:, None, :, :] - pos[:, :, None, :]
    a = pos.shape[1]
    eye = torch.eye(a, dtype=torch.bool, device=pos.device)
    pair_mask = node_mask[:, :, None] & node_mask[:, None, :] & ~eye
    d2 = (diff * diff).sum(dim=-1)
    dist = torch.sqrt(torch.clamp(d2, min=_EPS))
    dist = torch.where(pair_mask, dist, torch.full_like(dist, _BIG))
    return diff, dist, pair_mask


def dense_graph(pos: torch.Tensor, node_mask: torch.Tensor, cutoff: float) -> DenseGraph:
    diff, dist, pair_mask = pairwise(pos, node_mask)
    adj = pair_mask & (dist < cutoff)
    return DenseGraph(diff=diff, dist=dist, adj=adj)


def dense_topk_mask(dist: torch.Tensor, adj: torch.Tensor, k: int) -> torch.Tensor:
    """Restrict a dense adjacency to each row's k nearest neighbours.

    Tie rule (as in the JAX package): every edge within 1e-7 of the k-th
    distance is kept, so exactly degenerate geometries can keep MORE than
    k edges in a row.
    """
    a = dist.shape[-1]
    if k >= a:
        return adj
    neg = torch.where(adj, -dist, torch.full_like(dist, -float("inf")))
    kth = torch.topk(neg, k, dim=-1).values[..., -1:]  # [B,A,1] k-th smallest
    return adj & (dist <= -kth + 1e-7)


class NeighborList(NamedTuple):
    """Fixed-K nearest-neighbour view. Neighbour n of atom i is j = idx[b,i,n]."""

    idx: torch.Tensor  # [B, A, K] int64
    mask: torch.Tensor  # [B, A, K] bool
    dist: torch.Tensor  # [B, A, K]     (0 where masked)
    unit: torch.Tensor  # [B, A, K, 3]  (0 where masked)


def neighbor_list(pos: torch.Tensor, node_mask: torch.Tensor, cutoff: float,
                  max_neighbors: int) -> NeighborList:
    """The K = min(max_neighbors, A) nearest in-cutoff neighbours of each
    atom, by distance. Equal distances keep the lower index first, as
    `lax.top_k` does (a stable descending sort of the negated distances)."""
    g = dense_graph(pos, node_mask, cutoff)
    k = min(max_neighbors, pos.shape[1])
    neg = torch.where(g.adj, -g.dist, torch.full_like(g.dist, -_BIG))
    vals, idx = torch.sort(neg, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    mask = vals > -_BIG * 0.5
    diff = torch.gather(g.diff, 2, idx[..., None].expand(*idx.shape, 3))
    dist = torch.where(mask, -vals, torch.zeros_like(vals))
    unit = diff / torch.clamp(dist, min=_EPS)[..., None]
    unit = torch.where(mask[..., None], unit, torch.zeros_like(unit))
    return NeighborList(idx=idx, mask=mask, dist=dist, unit=unit)


def dense_from_neighbor_list(nl: NeighborList, a_dim: int):
    """Scatter a top-K neighbour list onto the dense [B, A, A] pair lattice:
    (mask_d float 0/1, unit_d [B,A,A,3], dist_d [B,A,A]), zero off the list.
    A plain scatter (the JAX package contracts a one-hot); neighbour indices
    within one row are distinct, so nothing is summed."""
    b, a, k = nl.idx.shape
    m = nl.mask.to(nl.dist.dtype)
    mask_d = nl.dist.new_zeros((b, a, a_dim)).scatter_(2, nl.idx, m)
    dist_d = nl.dist.new_zeros((b, a, a_dim)).scatter_(2, nl.idx, nl.dist * m)
    unit_d = nl.unit.new_zeros((b, a, a_dim, 3)).scatter_(
        2, nl.idx[..., None].expand(b, a, k, 3), nl.unit * m[..., None])
    return mask_d, unit_d, dist_d


def gather_nodes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-node features at node indices: x [B, A, ...feat], idx [B, ...index]
    -> [B, ...index, ...feat]."""
    xf = x.flatten(2)
    flat = idx.reshape(x.shape[0], -1).long()
    out = torch.gather(xf, 1, flat[..., None].expand(*flat.shape, xf.shape[-1]))
    return out.reshape(*idx.shape, *x.shape[2:])


def edge_rotation_vectors(unit: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The edges' unit vectors with masked rows replaced by ẑ (the axis the
    edge-aligned Wigner rotations are built from)."""
    zhat = torch.zeros_like(unit)
    zhat[..., 2] = 1.0
    return torch.where(mask[..., None], unit, zhat)
