"""DimeNet++: directional message passing with triplet angular bases.

The port of ``nabladft_tpu/models/dimenetpp.py`` (torch_geometric's
DimeNetPlusPlus with the reference's potential head, nablaDFT
dimenetplusplus.py:22-116; forces -∂E/∂pos by autograd). Bases follow
torch_geometric: trainable Bessel frequencies `rbf_freq`, the 1/x envelope
on the radial and spherical bases.

Edges live in one of the JAX package's two layouts, which share one
parameter tree:

  * compact (`compact=True`, the default): the message of edge j→i at
    [b, i, n], n < K = min(max_neighbors, A), j = idx[b, i, n] from
    `graph.neighbor_list` (strict top-K, ties to the lower index). Per block
    one pair-shaped contraction over k, one closing contraction over the
    dense j axis, a gather of its K needed rows, and the back-triplet
    (k == i) correction through the reverse-edge map rev(b, i, n) = the
    slot of i in j's list. Both gathers are `torch.gather`, whose backward
    is a scatter-add that autograd differentiates again: training
    differentiates the forces.
  * dense (`compact=False`): the message of edge j→i at [b, i, j] under
    `graph.dense_topk_mask` (which keeps every edge tied at the K-th
    distance); the reverse edge is the transpose, so no gather.

The triplet sum uses the Legendre addition theorem in both, so no
[B, A, K, K, ·] triplet lattice exists. `gather_mode="onehot"` names the
compact layout's computation in the JAX package's 0/1 matmul form.
``compute_dtype="bfloat16"`` runs as the JAX model's: the bases computed in
float32 and cast after their masks, the merged weights (rbf1·rbf2,
sbf1·sbf2) cast after their product, every block in bf16, and the per-graph
latent summed in float32 for the float32 head. The JAX package's
``remat`` / ``remat_basis`` (memory for recomputation) are not taken: a
full-width train step keeps its activations on the card (PERF.md §5).
Parameters are named as the flax tree (`models/convert.load_flax_params`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models.base import (
    DenseParams, Linear, ModelOutput, compute_dtype_of, embed, init_linear_, lecun_normal_,
    register_model, silu,
)
from nabladft_tpu_torch.ops import graph, so3
from nabladft_tpu_torch.ops.radial import dimenet_bessel_rbf
from nabladft_tpu_torch.ops.spherical import dimenet_radial_part
from nabladft_tpu_torch.utils import resolve_device


class ResidualLayer(nn.Module):
    def __init__(self, hidden: int, cdt: torch.dtype):
        super().__init__()
        self.dense_0 = Linear(hidden, hidden, compute_dtype=cdt)
        self.dense_1 = Linear(hidden, hidden, compute_dtype=cdt)

    def forward(self, x):
        return x + silu(self.dense_1(silu(self.dense_0(x))))


class InteractionPPBlock(nn.Module):
    def __init__(self, hidden: int, int_emb_size: int, basis_emb_size: int,
                 num_before_skip: int, num_after_skip: int, num_spherical: int,
                 num_radial: int, agg_norm: float, cdt: torch.dtype = torch.float32):
        super().__init__()
        self.hidden, self.agg_norm, self.cdt = hidden, agg_norm, cdt
        self.num_spherical, self.num_radial = num_spherical, num_radial
        self.lin_ji = Linear(hidden, hidden, compute_dtype=cdt)
        self.lin_kj = Linear(hidden, hidden, compute_dtype=cdt)
        self.rbf1 = nn.Linear(num_radial, basis_emb_size, bias=False)
        self.rbf2 = nn.Linear(basis_emb_size, hidden, bias=False)
        self.down = Linear(hidden, int_emb_size, bias=False, compute_dtype=cdt)
        # the two spherical-basis Denses, raw [in, out] as the flax params
        self.sbf1_kernel = nn.Parameter(torch.empty(num_spherical * num_radial, basis_emb_size))
        self.sbf2_kernel = nn.Parameter(torch.empty(basis_emb_size, int_emb_size))
        self.up = Linear(int_emb_size, hidden, bias=False, compute_dtype=cdt)
        self.num_before_skip, self.num_after_skip = num_before_skip, num_after_skip
        for k in range(num_before_skip):
            setattr(self, f"before_skip_{k}", ResidualLayer(hidden, cdt))
        self.skip = Linear(hidden, hidden, compute_dtype=cdt)
        for k in range(num_after_skip):
            setattr(self, f"after_skip_{k}", ResidualLayer(hidden, cdt))
        L1, R = num_spherical, num_radial
        # q[(lm)] = Σ_n qm[(lmn)] · w12[(ln)]: a gather of w12's rows and a
        # 0/1 projection onto (lm)
        lmn_to_ln = np.concatenate([np.tile(np.arange(l * R, (l + 1) * R), 2 * l + 1)
                                    for l in range(L1)])
        lmn_to_lm = np.concatenate([np.repeat(l * l + np.arange(2 * l + 1), R)
                                    for l in range(L1)])
        proj = np.zeros((len(lmn_to_lm), L1 * L1), np.float32)
        proj[np.arange(len(lmn_to_lm)), lmn_to_lm] = 1.0
        self.register_buffer("lmn_to_ln", torch.from_numpy(lmn_to_ln), persistent=False)
        self.register_buffer("proj", torch.from_numpy(proj), persistent=False)

    def forward(self, m, rbf, feats, adj, compact: bool):
        """m [B,A,E,H]: the message of edge j→i at [b, i, n] (`compact`, E =
        K) or [b, i, j] (dense, E = A); rbf likewise; feats: the
        block-independent pair features (DimeNetPP._features)."""
        L1, R, cdt = self.num_spherical, self.num_radial, self.cdt
        x_ji = silu(self.lin_ji(m))
        x_kj = silu(self.lin_kj(m))
        # the merged weights cast after their product
        x_kj = x_kj * (rbf @ (self.rbf1.weight.t() @ self.rbf2.weight.t()).to(cdt))
        x_kj = silu(self.down(x_kj))
        w12 = (self.sbf1_kernel @ self.sbf2_kernel).to(cdt)  # [(L)·R, E]
        # Q[b,j,(lmn),e] = Σ_k G[b,j,k,(lmn)] x_kj[b,j,k,e], then gated by w12
        qm = torch.einsum("bjkq,bjke->bjqe", feats["G"], x_kj)
        q = torch.einsum("bjqe,qp->bjpe", qm * w12[self.lmn_to_ln], self.proj.to(cdt))
        if compact:
            # close the triplet over the dense j axis, then gather the K rows
            agg_d = torch.einsum("bijq,bjqe->bije", feats["Yc_dense"], q)
            idx = feats["idx"]
            bsz, a_ax, k_ax, e_ax = x_kj.shape
            agg = torch.gather(agg_d, 2, idx[..., None].expand(bsz, a_ax, k_ax, e_ax))
            # back-triplet x_kj[b, j, rev(i)], zero where i is not in j's list
            xkj_t = torch.gather(
                x_kj.reshape(bsz, a_ax * k_ax, e_ax), 1,
                feats["rev_flat"].reshape(bsz, a_ax * k_ax, 1).expand(-1, -1, e_ax))
            xkj_t = (xkj_t.reshape(bsz, a_ax, k_ax, e_ax)
                     * feats["rev_valid"][..., None].to(m.dtype))
        else:  # dense: the edge axis is j, the reverse edge the transpose
            agg = torch.einsum("bijq,bjqe->bije", feats["Yc"], q)
            xkj_t = x_kj.transpose(1, 2)
        rt, s = feats["Rt"], feats["S"]
        gated = (s[..., None] * rt.reshape(*rt.shape[:-1], L1, R)).reshape(*rt.shape[:-1], L1 * R)
        agg = agg - torch.einsum("bijq,qe->bije", gated, w12) * xkj_t
        # the raw sum over ~K neighbours normalised by K (absorbed into `up`
        # by converted checkpoints)
        x_kj = silu(self.up(agg / self.agg_norm))
        h = x_ji + x_kj
        for k in range(self.num_before_skip):
            h = getattr(self, f"before_skip_{k}")(h)
        h = silu(self.skip(h)) + m
        for k in range(self.num_after_skip):
            h = getattr(self, f"after_skip_{k}")(h)
        return torch.where(adj[..., None], h, h.new_zeros(()))


class OutputPPBlock(nn.Module):
    def __init__(self, hidden: int, out_emb_channels: int, out_channels: int,
                 num_layers: int, num_radial: int, agg_norm: float,
                 cdt: torch.dtype = torch.float32):
        super().__init__()
        self.agg_norm, self.num_layers = agg_norm, num_layers
        self.lin_rbf = Linear(num_radial, hidden, bias=False, compute_dtype=cdt)
        self.lin_up = Linear(hidden, out_emb_channels, bias=False, compute_dtype=cdt)
        for k in range(num_layers):
            setattr(self, f"lin_{k}", Linear(out_emb_channels, out_emb_channels,
                                             compute_dtype=cdt))
        self.lin_out = Linear(out_emb_channels, out_channels, bias=False, compute_dtype=cdt)

    def forward(self, m, rbf, adj):
        g = self.lin_rbf(rbf) * m
        x = torch.where(adj[..., None], g, g.new_zeros(())).sum(dim=2) / self.agg_norm
        x = self.lin_up(x)
        for k in range(self.num_layers):
            x = silu(getattr(self, f"lin_{k}")(x))
        return self.lin_out(x)


@register_model("dimenetpp")
class DimeNetPP(nn.Module):
    """DimeNet++ in float32 or bfloat16; defaults follow the reference's
    config/model/dimenetplusplus.yaml.

    Built on `device` (the card unless the caller names another) with
    weights drawn from `generator` with flax's initialisers (truncated
    lecun-normal kernels and embedding, zero biases, the output blocks'
    `lin_out` zero, `rbf_freq` = n·π).
    """

    derivative_forces = True

    def __init__(
        self,
        node_latent_dim: int = 50,
        hidden: int = 256,
        num_blocks: int = 6,
        int_emb_size: int = 64,
        basis_emb_size: int = 8,
        out_emb_channels: int = 256,
        num_spherical: int = 7,
        num_radial: int = 6,
        max_neighbors: int = 32,
        envelope_exponent: int = 5,
        num_before_skip: int = 1,
        num_after_skip: int = 2,
        num_output_layers: int = 3,
        cutoff: float = 5.0,
        num_elements: int = 100,
        energy_mean: float = 0.0,
        energy_std: float = 1.0,
        compute_dtype: str = "float32",
        compact: bool = True,
        atom_norm: float = 32.0,
        gather_mode: str = "take",
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cdt = cdt = compute_dtype_of(compute_dtype, "DimeNet++")
        if gather_mode not in ("take", "onehot"):
            raise ValueError(f"gather_mode must be take|onehot, got {gather_mode!r}")
        self.hidden, self.num_blocks = hidden, num_blocks
        self.num_spherical, self.num_radial = num_spherical, num_radial
        self.max_neighbors, self.envelope_exponent = max_neighbors, envelope_exponent
        self.cutoff, self.atom_norm, self.compact = cutoff, atom_norm, compact
        self.energy_mean, self.energy_std = energy_mean, energy_std
        k_norm = float(max_neighbors)
        self.rbf_freq = nn.Parameter(torch.empty(num_radial))
        self.atom_embedding = nn.Embedding(num_elements, hidden)
        # flax Denses named *_embed: their kernels keep flax's names
        self.rbf_embed = DenseParams(num_radial, hidden)
        self.edge_embed = DenseParams(3 * hidden, hidden)
        for b in range(num_blocks + 1):
            setattr(self, f"output_{b}", OutputPPBlock(
                hidden, out_emb_channels, node_latent_dim, num_output_layers, num_radial,
                k_norm, cdt))
        for b in range(num_blocks):
            setattr(self, f"interaction_{b}", InteractionPPBlock(
                hidden, int_emb_size, basis_emb_size, num_before_skip, num_after_skip,
                num_spherical, num_radial, k_norm, cdt))
        self.dense_0 = nn.Linear(node_latent_dim, node_latent_dim)
        self.dense_1 = nn.Linear(node_latent_dim, node_latent_dim // 2)
        self.dense_2 = nn.Linear(node_latent_dim // 2, node_latent_dim // 2)
        self.dense_3 = nn.Linear(node_latent_dim // 2, 1)
        L1 = num_spherical
        c_lm = np.concatenate([np.full(2 * l + 1, (-1.0) ** l * np.sqrt(4 * np.pi / (2 * l + 1)))
                               for l in range(L1)]).astype(np.float32)
        parity = np.concatenate([np.full(2 * l + 1, (-1.0) ** l)
                                 for l in range(L1)]).astype(np.float32)
        self.register_buffer("c_lm", torch.from_numpy(c_lm), persistent=False)
        self.register_buffer("parity", torch.from_numpy(parity), persistent=False)
        self.reset_parameters(generator)
        self.to(resolve_device(device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.rbf_freq.copy_(torch.arange(1, self.num_radial + 1) * torch.pi)
            lecun_normal_(self.atom_embedding.weight, fan_in=self.hidden, generator=generator)
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
                elif isinstance(m, DenseParams):
                    lecun_normal_(m.kernel, fan_in=m.kernel.shape[0], generator=generator)
                    m.bias.zero_()
                elif isinstance(m, InteractionPPBlock):
                    lecun_normal_(m.sbf1_kernel, fan_in=m.sbf1_kernel.shape[0],
                                  generator=generator)
                    lecun_normal_(m.sbf2_kernel, fan_in=m.sbf2_kernel.shape[0],
                                  generator=generator)
            # torch_geometric zero-fills the output blocks' final projection
            for b in range(self.num_blocks + 1):
                getattr(self, f"output_{b}").lin_out.weight.zero_()

    def _edges(self, batch: MolBatch):
        """(adj, dist, unit, feats) of the layout: adj the edge mask
        ([B,A,K] compact, [B,A,A] dense), dist and unit its edges' (zero off
        adj), feats the compact layout's index tables (idx, the reverse-edge
        map) and dense unit vectors, or nothing."""
        a_ax = batch.pos.shape[1]
        zero = batch.pos.new_zeros(())
        dgd = graph.dense_graph(batch.pos, batch.node_mask, self.cutoff)
        if not self.compact:
            adj = graph.dense_topk_mask(dgd.dist, dgd.adj, self.max_neighbors)
            unit = torch.where(adj[..., None],
                               dgd.diff / torch.clamp(dgd.dist, min=1e-10)[..., None], zero)
            return adj, torch.where(adj, dgd.dist, zero), unit, {}
        k_ax = min(self.max_neighbors, a_ax)
        nl = graph.neighbor_list(batch.pos, batch.node_mask, self.cutoff, k_ax, dense=dgd)
        idx, adj = nl.idx, nl.mask  # [B,A,K]
        # rev(b,i,n): the slot of i in the list of j = idx[b,i,n]
        idx_g = graph.gather_nodes(idx, idx)  # [B,A,K,K]
        mask_g = graph.gather_nodes(adj, idx)
        arange = torch.arange(a_ax, device=idx.device)
        eq = (idx_g == arange[None, :, None, None]) & mask_g & adj[..., None]
        unit_d = torch.where(dgd.adj[..., None],
                             dgd.diff / torch.clamp(dgd.dist, min=1e-10)[..., None], zero)
        return adj, nl.dist, nl.unit, {
            "idx": idx, "rev_valid": eq.any(-1), "unit_d": unit_d, "adj_d": dgd.adj,
            "rev_flat": idx * k_ax + torch.argmax(eq.to(torch.int8), dim=-1)}

    def _features(self, batch: MolBatch):
        """The block-independent edge tensors: (adj, rbf, feats), each basis
        computed in float32 and cast to the compute dtype after its mask."""
        L1, R, cdt = self.num_spherical, self.num_radial, self.cdt
        adj, dist, unit, feats = self._edges(batch)
        zero = batch.pos.new_zeros(())
        rbf = dimenet_bessel_rbf(dist, R, self.cutoff, self.envelope_exponent,
                                 freqs=self.rbf_freq)
        rbf = torch.where(adj[..., None], rbf, zero).to(cdt)
        # addition-theorem pair features: sbf_ln(d_jk, θ_ijk) =
        # (-1)^l √(4π/(2l+1)) Σ_m Y_lm(û_ij) R̃_ln(d_jk) Y_lm(û_jk)
        y = torch.where(adj[..., None], so3.real_sph_harm(unit, L1 - 1, normalized=True),
                        zero).to(cdt)
        yc = y * self.c_lm.to(cdt)
        rad = dimenet_radial_part(dist, L1, R, self.cutoff, self.envelope_exponent)
        rad = torch.where(adj[..., None], rad, zero).to(cdt)  # [B,A,·,(L)·R]
        g = torch.cat([(y[..., l * l:(l + 1) * (l + 1), None]
                        * rad[..., None, l * R:(l + 1) * R]).reshape(*adj.shape, (2 * l + 1) * R)
                       for l in range(L1)], dim=-1)
        if self.compact:
            # the reverse edge's basis: the same distance, Y with the parity sign
            yt, rt = y * self.parity.to(cdt), rad
        else:
            yt, rt = y.transpose(1, 2), rad.transpose(1, 2)
        # Σ_m as JAX's einsum (a dot): exact products, a float32 sum, one rounding
        s = torch.stack([(yc[..., l * l:(l + 1) * (l + 1)].float()
                          * yt[..., l * l:(l + 1) * (l + 1)].float()).sum(-1).to(cdt)
                         for l in range(L1)], dim=-1)
        feats.update(G=g, Rt=rt, S=s)
        if self.compact:
            y_d = so3.real_sph_harm(feats.pop("unit_d"), L1 - 1, normalized=True)
            y_d = torch.where(feats.pop("adj_d")[..., None], y_d, zero).to(cdt)
            feats["Yc_dense"] = y_d * self.c_lm.to(cdt)
        else:
            feats["Yc"] = yc
        return adj, rbf, feats

    def forward(self, batch: MolBatch) -> ModelOutput:
        adj, rbf, feats = self._features(batch)
        cdt = self.cdt
        x = embed(self.atom_embedding, batch.z.long(), cdt)
        rbf_emb = silu(rbf @ self.rbf_embed.kernel.to(cdt) + self.rbf_embed.bias.to(cdt))
        xi = x[:, :, None].expand(*adj.shape, x.shape[-1])
        xj = (graph.gather_nodes(x, feats["idx"]) if self.compact  # [B,A,K,H]
              else x[:, None].expand(*adj.shape, x.shape[-1]))
        m = silu(torch.cat([xi, xj, rbf_emb], dim=-1) @ self.edge_embed.kernel.to(cdt)
                 + self.edge_embed.bias.to(cdt))
        m = torch.where(adj[..., None], m, m.new_zeros(()))
        p = self.output_0(m, rbf, adj)
        for b in range(self.num_blocks):
            m = getattr(self, f"interaction_{b}")(m, rbf, feats, adj, self.compact)
            p = p + getattr(self, f"output_{b + 1}")(m, rbf, adj)
        # the per-graph latent (accumulated in float32, rounded to the compute
        # dtype, as the JAX sum) over a fixed atom count, then the swish head
        # in float32
        latent = torch.where(batch.node_mask[..., None], p, p.new_zeros(())).sum(1).float()
        h = F.silu(self.dense_0(latent / self.atom_norm))
        h = F.silu(self.dense_1(h))
        h = F.silu(self.dense_2(h))
        energy = self.dense_3(h)[..., 0]
        # energy_mean is per atom: the extensive offset is mean · n_atoms
        n_atoms = batch.node_mask.sum(dim=1).to(energy.dtype)
        return {"energy": energy * self.energy_std + self.energy_mean * n_atoms}
