"""EquiformerV2: SO(2)-reduced equivariant graph attention transformer.

The port of ``nabladft_tpu/models/equiformer_v2.py`` in its fused (Pallas)
parameter layout, the m-shared radial variant (the reference's
config/model/equiformer_v2_oc20.yaml widths: 12 layers, l_max 6, m_max 2, 128
sphere channels, 8 heads × 16 value channels, 64 alpha channels, FFN 128, 128
edge channels, 128 distance Gaussians, cutoff 12 Å, 30 neighbours, grid factor
4). Node features are spherical-harmonic stacks x [B, A, (L+1)², C]. Edge
features (distance basis and endpoint elements) and the compact truncated
Wigner values of each edge's frame are built once per forward over the
K-compacted neighbour list (K = min(max_neighbors, A)); the node embedding
adds the edge-degree embedding, summed over neighbours inside the
contraction. Per block: pre-norm → SO(2) graph attention (`ops.eqv2_attn`,
then a per-l projection) → drop-path → residual → pre-norm → grid-MLP FFN →
drop-path → residual. Heads: an energy FFN on the final norm (standardised,
then masked) and direct forces from a one-channel attention block's l=1 rows
(y, z, x → x, y, z).

The attention runs in one of two modes:

  * ``use_pallas="off"``   — the plain PyTorch version, differentiable by
    autograd;
  * ``use_pallas="fused"`` — `ops.eqv2_attn.eqv2_attention` (CUDA kernel O
    forward, P backward), 13 calls a forward. On CPU tensors the same op runs
    its plain version.

Dropout as in the JAX train job (which builds the model non-deterministic for
training): in ``train()`` mode each attention draws an alpha keep mask [B, A,
K, NH] (p = 0.1, pre-scaled by 1/(1-p)) that the kernel takes as `dropk`,
and each block's two residual branches a drop-path mask [B, 1, 1, 1] (p =
0.05), all from `dropout_generator` (the trainer seeds one from its seed and
the step); in ``eval()`` mode dropk is ones and nothing is dropped.
Parameters are named as the flax tree of the Pallas layout
(`models/convert.load_flax_params`). ``compute_dtype="bfloat16"`` and
``m_share_rad=False`` (the published checkpoints' variant, XLA path only in
the JAX package) are not ported and raise.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models.base import (
    LayerNormParams, ModelOutput, init_linear_, lecun_normal_, register_model,
)
from nabladft_tpu_torch.ops import eqv2_attn, graph, so3
from nabladft_tpu_torch.ops.escn_layer import grid_mats
from nabladft_tpu_torch.ops.radial import gaussian_smearing
from nabladft_tpu_torch.utils import resolve_device

ALPHA_DROP, DROP_PATH = 0.1, 0.05  # the JAX modules' rates
# dropout masks drawn since the last reset: "alpha" (one per attention call)
# and "drop_path" (two per block), in train mode only
DROPOUT_DRAWS: Dict[str, int] = {"alpha": 0, "drop_path": 0}


def reset_dropout_draws() -> None:
    for k in DROPOUT_DRAWS:
        DROPOUT_DRAWS[k] = 0


class EquivariantLayerNorm(nn.Module):
    """'layer_norm_sh': LayerNorm (eps 1e-6) on the l=0 row; per l>0 an RMS
    norm over the (2l+1) rows and channels with a learned per-channel gain."""

    def __init__(self, l_max: int, c: int):
        super().__init__()
        self.l_max, self.c = l_max, c
        self.ln0 = LayerNormParams(c)
        for l in range(1, l_max + 1):
            setattr(self, f"gain_{l}", nn.Parameter(torch.ones(c)))

    def forward(self, x):  # [B,A,S,C]
        outs = [F.layer_norm(x[..., 0, :], (self.c,), self.ln0.scale, self.ln0.bias,
                             eps=1e-6)[..., None, :]]
        for l in range(1, self.l_max + 1):
            sl = x[..., l * l:(l + 1) * (l + 1), :]
            rms = torch.sqrt((sl * sl).sum(dim=-2).mean(dim=-1) + 1e-8)
            outs.append(sl / rms[..., None, None] * getattr(self, f"gain_{l}"))
        return torch.cat(outs, dim=-2)


class GridFFN(nn.Module):
    """The grid-projected pointwise MLP (three bias-free Dense, silu between)."""

    def __init__(self, l_max: int, c: int, hidden: int, out_channels: int, grid_points: int):
        super().__init__()
        self.dense_0 = nn.Linear(c, hidden, bias=False)
        self.dense_1 = nn.Linear(hidden, hidden, bias=False)
        self.dense_2 = nn.Linear(hidden, out_channels, bias=False)
        to_g, from_g = grid_mats(l_max, grid_points)
        self.register_buffer("to_g", torch.as_tensor(to_g, dtype=torch.float32), persistent=False)
        self.register_buffer("from_g", torch.as_tensor(from_g, dtype=torch.float32),
                             persistent=False)

    def forward(self, x):  # [B,A,S,C]
        g = F.silu(self.dense_0(torch.einsum("ps,basc->bapc", self.to_g, x)))
        g = F.silu(self.dense_1(g))
        return torch.einsum("sp,bapc->basc", self.from_g, self.dense_2(g))


class SO2GraphAttention(nn.Module):
    """The Pallas layout's attention (JAX `PallasSO2GraphAttention`): the
    kernel-packed weights, then a per-l projection to `out_channels` (bias on
    l=0). ln_scale / ln_bias [1, VA] are tiled per head before the kernel."""

    def __init__(self, l_max: int, m_max: int, c: int, num_heads: int, alpha_channels: int,
                 value_channels: int, out_channels: int, edge_channels: int, grid_points: int,
                 use_pallas: str):
        super().__init__()
        self.l_max, self.m_max, self.grid_points = l_max, m_max, grid_points
        self.use_pallas = use_pallas
        self.nh, self.va = num_heads, alpha_channels
        co = num_heads * value_channels
        shapes = eqv2_attn.weight_shapes(l_max, m_max, c, co, edge_channels, num_heads,
                                         alpha_channels)
        for name, shape in zip(eqv2_attn.weight_names(m_max), shapes):
            if name in ("ln_scale", "ln_bias"):
                shape = (1, alpha_channels)
            elif name == "alpha_dot":
                shape = (num_heads, alpha_channels)
            setattr(self, name, nn.Parameter(torch.empty(shape)))
        for l in range(l_max + 1):
            setattr(self, f"proj_l{l}", nn.Linear(co, out_channels, bias=l == 0))

    def kernel_weights(self) -> list:
        """The attention's weights in the kernel's order and layout (`ws`)."""
        ws = []
        for name in eqv2_attn.weight_names(self.m_max):
            w = getattr(self, name)
            if name in ("ln_scale", "ln_bias"):
                w = w.repeat(1, self.nh)
            elif name == "alpha_dot":
                w = w.reshape(1, -1)
            ws.append(w)
        return ws

    def kernel_dims(self) -> dict:
        return dict(l_max=self.l_max, m_max=self.m_max, n_grid=self.grid_points, nh=self.nh)

    def forward(self, x, ctx: dict, dropk: torch.Tensor) -> torch.Tensor:
        ws, kw = self.kernel_weights(), self.kernel_dims()
        args = (ctx["idx"], ctx["d"], ctx["xe"], ctx["maskf"], dropk)
        if self.use_pallas == "fused":
            x = x.contiguous()
            agg = eqv2_attn.eqv2_attention(x, x, *args, *ws, **kw)
        else:
            agg = eqv2_attn.eqv2_fwd_reference(x, x, *args, *ws, **kw)
        return torch.cat([getattr(self, f"proj_l{l}")(agg[..., l * l:(l + 1) * (l + 1), :])
                          for l in range(self.l_max + 1)], dim=-2)


class TransBlockV2(nn.Module):
    def __init__(self, l_max: int, m_max: int, c: int, num_heads: int, alpha_channels: int,
                 value_channels: int, ffn_hidden: int, edge_channels: int, grid_points: int,
                 use_pallas: str):
        super().__init__()
        self.norm_1 = EquivariantLayerNorm(l_max, c)
        self.ga = SO2GraphAttention(l_max, m_max, c, num_heads, alpha_channels, value_channels, c,
                                    edge_channels, grid_points, use_pallas)
        self.norm_2 = EquivariantLayerNorm(l_max, c)
        self.ffn = GridFFN(l_max, c, ffn_hidden, c, grid_points)

    def forward(self, x, ctx: dict, model: "EquiformerV2"):
        h = self.ga(self.norm_1(x), ctx, model.alpha_keep(ctx))
        x = x + model.drop_path(h)
        return x + model.drop_path(self.ffn(self.norm_2(x)))


@register_model("equiformer_v2")
class EquiformerV2(nn.Module):
    """EquiformerV2 in float32; defaults follow the reference's
    config/model/equiformer_v2_oc20.yaml (the JAX model's defaults).

    Built on `device` (the card unless the caller names another) with
    weights drawn from `generator` with flax's initialisers (truncated
    lecun-normal kernels, zero biases, unit norms, alpha_dot standard
    normal). Forces come from the direct head (`derivative_forces` False).
    """

    derivative_forces = False

    def __init__(
        self,
        num_layers: int = 12,
        sphere_channels: int = 128,
        attn_alpha_channels: int = 64,
        num_heads: int = 8,
        attn_value_channels: int = 16,
        ffn_hidden_channels: int = 128,
        l_max: int = 6,
        m_max: int = 2,
        edge_channels: int = 128,
        num_distance_basis: int = 128,
        cutoff: float = 12.0,
        max_neighbors: int = 30,
        num_elements: int = 65,
        grid_points_factor: int = 4,
        compute_dtype: str = "float32",
        energy_mean: float = 0.0,
        energy_std: float = 1.0,
        m_share_rad: bool = True,
        use_pallas: str = "off",  # off | fused
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if use_pallas not in ("off", "fused"):
            raise ValueError(f"use_pallas must be off|fused, got {use_pallas!r}")
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r}: the port's EquiformerV2 runs float32 only "
                "(ROADMAP queue 1: bf16 compute)")
        if not m_share_rad:
            raise NotImplementedError(
                "m_share_rad=False (the published checkpoints' variant) waits for pretrained "
                "restore (ROADMAP queue 1: checkpoint and pretrained restore)")
        c, s = sphere_channels, (l_max + 1) ** 2
        self.num_layers, self.l_max, self.m_max, self.c = num_layers, l_max, m_max, c
        self.num_heads, self.edge_channels = num_heads, edge_channels
        self.cutoff, self.max_neighbors = cutoff, max_neighbors
        self.num_distance_basis, self.use_pallas = num_distance_basis, use_pallas
        self.energy_mean, self.energy_std = energy_mean, energy_std
        gp = grid_points_factor * s
        self.sphere_embedding = nn.Embedding(num_elements, c)
        self.src_embed = nn.Embedding(num_elements, edge_channels)
        self.dst_embed = nn.Embedding(num_elements, edge_channels)
        self.dist_proj = nn.Linear(num_distance_basis, edge_channels)
        self.edge_degree_proj = nn.Linear(3 * edge_channels, (l_max + 1) * c)
        attn = (l_max, m_max, c, num_heads, attn_alpha_channels, attn_value_channels)
        for i in range(num_layers):
            setattr(self, f"block_{i}", TransBlockV2(*attn, ffn_hidden_channels,
                                                     3 * edge_channels, gp, use_pallas))
        self.norm_final = EquivariantLayerNorm(l_max, c)
        self.energy_ffn = GridFFN(l_max, c, ffn_hidden_channels, 1, gp)
        self.force_block = SO2GraphAttention(*attn, 1, 3 * edge_channels, gp, use_pallas)
        # the generator of the train-mode dropout masks (None: torch's default)
        self.dropout_generator: Optional[torch.Generator] = None
        self.reset_parameters(generator)
        self.to(resolve_device(device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
                elif isinstance(m, nn.Embedding):
                    lecun_normal_(m.weight, fan_in=m.embedding_dim, generator=generator)
                elif isinstance(m, SO2GraphAttention):
                    for name in eqv2_attn.weight_names(m.m_max):
                        p = getattr(m, name)
                        if name in ("b_rad", "ln_bias"):
                            p.zero_()
                        elif name == "ln_scale":
                            p.fill_(1.0)
                        elif name == "alpha_dot":
                            p.normal_(0.0, 1.0, generator=generator)
                        else:
                            lecun_normal_(p, fan_in=p.shape[0], generator=generator)

    # -- dropout (train mode only) ---------------------------------------------

    def bernoulli_keep(self, shape, keep_prob: float, device) -> torch.Tensor:
        """A boolean keep mask, True with probability keep_prob."""
        u = torch.rand(shape, generator=self.dropout_generator, device=device)
        return u < keep_prob

    def alpha_keep(self, ctx: dict) -> torch.Tensor:
        """The attention's dropk [B, A, K, NH]: ones in eval mode, else a keep
        mask pre-scaled by 1/(1-p)."""
        m = ctx["maskf"]
        if not self.training:
            return ctx["ones"]
        DROPOUT_DRAWS["alpha"] += 1
        keep = self.bernoulli_keep((*m.shape, self.num_heads), 1.0 - ALPHA_DROP, m.device)
        return keep.to(m.dtype) / (1.0 - ALPHA_DROP)

    def drop_path(self, h: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return h
        DROPOUT_DRAWS["drop_path"] += 1
        keep = self.bernoulli_keep((h.shape[0], 1, 1, 1), 1.0 - DROP_PATH, h.device)
        return h * keep.to(h.dtype) / (1.0 - DROP_PATH)

    # -- forward -----------------------------------------------------------------

    def edge_inputs(self, pos: torch.Tensor, node_mask: torch.Tensor, z: torch.Tensor) -> dict:
        """The attention's edge inputs over the K-compacted neighbour list:
        idx [B,A,K] (int32 for the fused attention), d (the compact truncated
        Wigner values of the edge frames, masked) [B,A,K,KW], xe [B,A,K,3EC],
        maskf [B,A,K], and `ones` (eval mode's dropk) [B,A,K,NH]."""
        b, a = z.shape
        nl = graph.neighbor_list(pos, node_mask, self.cutoff, self.max_neighbors)
        k = nl.idx.shape[2]
        maskf = nl.mask.to(pos.dtype)
        # positions are never differentiated (direct forces): the frames are constants
        with torch.no_grad():
            rot = so3.rot_to_z(graph.edge_rotation_vectors(nl.unit, nl.mask))
            dcomp = (so3.wigner_trunc_compact_from_rot(rot, self.l_max, self.m_max)
                     * maskf[..., None]).contiguous()
        z_src = graph.gather_nodes(z[..., None], nl.idx)[..., 0]
        z_dst = z[:, :, None].expand(b, a, k)
        basis = gaussian_smearing(nl.dist, self.num_distance_basis, 0.0, self.cutoff)
        xe = F.silu(torch.cat([self.dist_proj(basis), self.src_embed(z_src), self.dst_embed(z_dst)],
                              dim=-1))
        idx = nl.idx.to(torch.int32) if self.use_pallas == "fused" else nl.idx
        return dict(idx=idx, d=dcomp, xe=xe.contiguous(), maskf=maskf.contiguous(),
                    ones=maskf.new_ones((b, a, k, self.num_heads)))

    def forward(self, batch: MolBatch) -> ModelOutput:
        z = batch.z.long()
        b, a = z.shape
        L, C = self.l_max, self.c
        ctx = self.edge_inputs(batch.pos, batch.node_mask, z)
        dcomp, k = ctx["d"], ctx["d"].shape[2]

        x = batch.pos.new_zeros((b, a, (L + 1) ** 2, C))
        x[:, :, 0, :] = self.sphere_embedding(z)
        # edge-degree embedding: each edge's m=0 radial rows rotated back with
        # the compact values (row (l, 0) of block l), summed over neighbours in
        # the contraction
        deg = self.edge_degree_proj(ctx["xe"]).reshape(b, a, k, L + 1, C)
        offs, _ = so3.trunc_compact_layout(L, self.m_max)
        cols = []
        for l in range(L + 1):
            base = offs[l] + min(l, self.m_max) * (2 * l + 1)
            cols.append(torch.einsum("bajn,bajc->banc", dcomp[..., base:base + 2 * l + 1],
                                     deg[..., l, :]))
        x = x + torch.cat(cols, dim=-2) / math.sqrt(float(self.max_neighbors))
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x, ctx, self)
        x = self.norm_final(x)

        node_e = self.energy_ffn(x)[..., 0, 0] * self.energy_std + self.energy_mean
        energy = torch.where(batch.node_mask, node_e, torch.zeros_like(node_e)).sum(dim=1)
        l1 = self.force_block(x, ctx, self.alpha_keep(ctx))[..., 1:4, 0]  # (y, z, x)
        forces = torch.stack([l1[..., 2], l1[..., 0], l1[..., 1]], dim=-1)
        return {"energy": energy, "forces": forces * batch.node_mask[..., None]}
