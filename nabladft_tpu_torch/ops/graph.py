"""Dense molecular graph construction over padded batches.

The molecular half of ``nabladft_tpu/ops/graph.py``: molecules here are
≤ 62 atoms, so the all-pairs distance matrix is built densely on the device
every step and neighbour caps are masks, not ragged lists. Conventions kept
from the JAX package: diff[b,i,j] = pos[j] - pos[i], masked distances are
`_BIG`, and `dense_topk_mask` keeps every edge within 1e-7 of the k-th
distance. eSCN's and EquiformerV2's fixed-K `neighbor_list` (strict top-k,
ties to the lower index as `lax.top_k`, K = min(max_neighbors, A) unpadded),
its scatter back onto the dense pair lattice, the node gather along it and
the edge frames' axis vectors. The periodic neighbour list
(`pbc_neighbor_list`): candidates on a static [B, A, A, O] lattice of the
(2·n_images+1)^3 periodic images, one strict top-k over them, and the
reference's counter-edge symmetrisation.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Tuple

import numpy as np
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


def _nearest(adj: torch.Tensor, dist: torch.Tensor, k: int):
    """The k nearest along the last axis among the slots `adj` keeps:
    (indices, their mask, their negated distances). Equal distances keep the
    lower index first, as `lax.top_k` does (a stable descending sort of the
    negated distances)."""
    neg = torch.where(adj, -dist, torch.full_like(dist, -_BIG))
    vals, idx = torch.sort(neg, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return idx, vals > -_BIG * 0.5, vals


def neighbor_list(pos: torch.Tensor, node_mask: torch.Tensor, cutoff: float,
                  max_neighbors: int, dense: Optional[DenseGraph] = None) -> NeighborList:
    """The K = min(max_neighbors, A) nearest in-cutoff neighbours of each
    atom, by distance, equal distances in index order (`_nearest`).
    `dense`: a `dense_graph(pos, node_mask, cutoff)` the caller already
    built, so the all-pairs distances are computed once."""
    g = dense if dense is not None else dense_graph(pos, node_mask, cutoff)
    k = min(max_neighbors, pos.shape[1])
    idx, mask, vals = _nearest(g.adj, g.dist, k)
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


def gather_neighbor_edges(edge_feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """For each edge (j→i) the feature rows of all edges into j:
    edge_feat [B, A, K, ...F] (edge idx[b,i,n] → i stored at [b,i,n]) ->
    [B, A, K, K, ...F], out[b,i,n,m] = edge_feat[b, idx[b,i,n], m]."""
    return gather_nodes(edge_feat, idx)


def triplet_angles(nl: NeighborList) -> Tuple[torch.Tensor, torch.Tensor]:
    """Angles of the triplets k→j→i over the neighbour list: for edge
    (j→i) at [b,i,n] and edge (k→j) at [b,j,m], the cosine between
    pos_i - pos_j and pos_k - pos_j, clipped to [-1, 1] ([B,A,K,K]), and
    trip_mask: both edges real and k != i (the back edge)."""
    a = nl.idx.shape[1]
    u_jk = gather_nodes(nl.unit, nl.idx)  # [B,A,K,K,3]: unit j→k
    cos = torch.einsum("bikc,bikmc->bikm", -nl.unit, u_jk).clamp(-1.0, 1.0)
    e2_mask = gather_nodes(nl.mask, nl.idx)
    k_idx = gather_nodes(nl.idx, nl.idx)
    i_idx = torch.arange(a, device=nl.idx.device)[None, :, None, None]
    return cos, nl.mask[..., None] & e2_mask & (k_idx != i_idx)


def edge_rotation_vectors(unit: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The edges' unit vectors with masked rows replaced by ẑ (the axis the
    edge-aligned Wigner rotations are built from)."""
    zhat = torch.zeros_like(unit)
    zhat[..., 2] = 1.0
    return torch.where(mask[..., None], unit, zhat)


class PBCNeighborList(NamedTuple):
    """Fixed-K neighbour view under periodic boundary conditions: neighbour n
    of atom i is the sender atom j = idx[b,i,n] in the lattice image
    offset[b,i,n]; diff already holds that image's lattice shift."""

    idx: torch.Tensor  # [B, A, K] int64 sender atom
    mask: torch.Tensor  # [B, A, K] bool
    diff: torch.Tensor  # [B, A, K, 3]  pos[j] + offset @ cell - pos[i] (0 where masked)
    dist: torch.Tensor  # [B, A, K]     (0 where masked)
    unit: torch.Tensor  # [B, A, K, 3]  (0 where masked)
    offset: torch.Tensor  # [B, A, K, 3] int32 lattice image of the sender


def pbc_image_offsets(n_images: int = 1) -> np.ndarray:
    """Integer lattice offsets of the periodic images, lexicographic over
    range(-n, n+1)^3, so offsets[o] == -offsets[O-1-o]: negating an offset
    (the counter-edge) reverses the image axis."""
    r = range(-n_images, n_images + 1)
    return np.array(list(itertools.product(r, r, r)), dtype=np.int32)


def pbc_neighbor_list(pos: torch.Tensor, node_mask: torch.Tensor, cell: torch.Tensor,
                      cutoff: float, max_neighbors: int, n_images: int = 1,
                      pbc: Tuple[bool, bool, bool] = (True, True, True),
                      symmetrize: bool = True) -> PBCNeighborList:
    """Strict top-k in-cutoff neighbours under periodic boundary conditions
    (the reference's radius_graph_pbc + symmetrize_edges,
    painn_pyg/utils.py:318, painn_pyg/painn.py:157-304).

    `cell` [B, 3, 3] holds the lattice vectors as rows. Self-pairs are
    excluded in the home image only (an atom neighbours its own periodic
    copies); an axis with pbc False admits offset 0 only (the image axis
    keeps its length: disallowed images are masked). K = min(max_neighbors,
    A·O). With `symmetrize`, every kept edge (j→i, S) gains its mirror
    (i→j, -S) and the list is taken again with a budget of 2K, nearest
    first (the reference grows its ragged list instead)."""
    b, a = pos.shape[:2]
    offsets = pbc_image_offsets(n_images)
    keep = np.ones(len(offsets), dtype=bool)
    for ax in range(3):
        if not pbc[ax]:
            keep &= offsets[:, ax] == 0
    dev = pos.device
    allowed = torch.from_numpy(keep).to(dev)
    offs = torch.from_numpy(offsets).to(dev)
    n_off = len(offsets)
    center = n_off // 2  # the (0,0,0) image
    shifts = torch.einsum("ox,bxy->boy", offs.to(pos.dtype), cell.to(pos.dtype))  # [B,O,3]
    # diff[b,i,j,o] = pos[j] + shift[o] - pos[i]
    diff = pos[:, None, :, None, :] + shifts[:, None, None, :, :] - pos[:, :, None, None, :]
    pair = node_mask[:, :, None] & node_mask[:, None, :]
    self_home = (torch.eye(a, dtype=torch.bool, device=dev)[None, :, :, None]
                 & (torch.arange(n_off, device=dev) == center)[None, None, None, :])
    cand = pair[..., None] & allowed[None, None, None, :] & ~self_home
    dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=_EPS))
    adj = cand & (dist < cutoff)
    k = min(max_neighbors, a * n_off)

    def select(adj_mask, kk):
        flat, mask, _ = _nearest(adj_mask.reshape(b, a, a * n_off),
                                 dist.reshape(b, a, a * n_off), kk)
        return flat // n_off, flat % n_off, mask, flat

    j_idx, o_idx, mask, flat = select(adj, k)
    if symmetrize:
        sel = torch.zeros((b, a, a * n_off), dtype=torch.bool, device=dev)
        sel = sel.scatter(2, flat, mask).reshape(b, a, a, n_off)
        # the counter-edge of (receiver i, sender j, image o) is
        # (receiver j, sender i, image O-1-o)
        sel_t = torch.flip(sel.transpose(1, 2), dims=(-1,))
        j_idx, o_idx, mask, flat = select((sel | sel_t) & adj, min(2 * k, a * n_off))
    bi = torch.arange(b, device=dev)[:, None, None]
    ii = torch.arange(a, device=dev)[None, :, None]
    zero = pos.new_zeros(())
    dsel = diff[bi, ii, j_idx, o_idx]  # [B,A,K,3]
    dd = torch.where(mask, dist[bi, ii, j_idx, o_idx], zero)
    unit = torch.where(mask[..., None], dsel / torch.clamp(dd, min=_EPS)[..., None], zero)
    dsel = torch.where(mask[..., None], dsel, zero)
    return PBCNeighborList(idx=j_idx, mask=mask, diff=dsel, dist=dd, unit=unit,
                           offset=offs[o_idx] * mask[..., None].to(torch.int32))
