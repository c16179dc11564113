"""eSCN: equivariant message passing via the SO(3) → SO(2) reduction.

The port of ``nabladft_tpu/models/escn.py`` in its fused (Pallas) parameter
layout, the JAX package's canonical one (the reference's
config/model/escn-oc.yaml: 8 layers, l_max 6, m_max 2, 128 sphere channels,
hidden 256, 128 edge channels, cutoff 8 Å, 40 neighbours, 128 sphere
samples). Node features are spherical-harmonic stacks x [B, A, (L+1)², C].
Per layer, the edge block embeds distance and endpoint elements; the message
(`ops.escn_layer`) rotates both endpoints' stacks so the edge lies on ẑ,
runs the SO(2) convolutions, silu on the truncated S2 grid, and rotates back
and sums over neighbours; a node-level MLP on the full grid mixes [x,
message]. Sphere-sampled heads give the energy and direct forces.

The message runs in one of two modes:

  * ``use_pallas="off"``   — the plain PyTorch version, differentiable by
    autograd;
  * ``use_pallas="fused"`` — `ops.escn_layer.escn_message` (CUDA kernel M
    forward, N backward). On CPU tensors the same op runs its plain version.

Both read the same dense pair lattice, scattered from the top-K neighbour
list, with the compact truncated Wigner values masked to the graph.
Parameters are named as the flax tree of the Pallas layout
(`models/convert.load_flax_params`). Like the JAX package's fused path, the
layers are not rematerialised (the JAX model's `remat` serves its XLA path
only).

``compute_dtype="bfloat16"`` follows the JAX model's fused path in bf16
(``nabladft_tpu/models/escn.py:415-428``): the embedding's rows are rounded
to bf16 (flax's ``Embed(dtype=bfloat16)``), the stream is float32 from
there on, and every layer's message runs in the kernels' bf16 mode
(``mxu_bf16``: each product's operands rounded to bf16, float32 sums; in
both modes, so "off" is the fused path's oracle); the edge block, the
sphere-MLP tail and the heads stay float32. The parameters are float32 in
both dtypes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models.base import (
    ModelOutput, compute_dtype_of, init_linear_, lecun_normal_, register_model,
)
from nabladft_tpu_torch.ops import escn_layer, graph, so3
from nabladft_tpu_torch.ops.escn_layer import fibonacci_sphere, grid_mats, sh_on_points
from nabladft_tpu_torch.ops.radial import gaussian_smearing
from nabladft_tpu_torch.utils import resolve_device


class EdgeBlock(nn.Module):
    """Invariant edge embedding from distance and endpoint elements."""

    def __init__(self, edge_channels: int, num_elements: int, cutoff: float, num_gaussians: int):
        super().__init__()
        self.cutoff, self.num_gaussians = cutoff, num_gaussians
        self.fc_dist = nn.Linear(num_gaussians, edge_channels)
        self.src_embed = nn.Embedding(num_elements, edge_channels)
        self.dst_embed = nn.Embedding(num_elements, edge_channels)
        self.fc_edge = nn.Linear(edge_channels, edge_channels)

    def forward(self, dist, z_src, z_dst):
        x_dist = self.fc_dist(gaussian_smearing(dist, self.num_gaussians, 0.0, self.cutoff))
        x = F.silu(self.src_embed(z_src) + self.dst_embed(z_dst) + x_dist)
        return F.silu(self.fc_edge(x))


class ESCNLayer(nn.Module):
    """One layer: edge block, the message (plain or kernels M/N), then the
    node-level full-grid MLP on [x, message]."""

    def __init__(self, l_max: int, m_max: int, c: int, hidden: int, edge_channels: int,
                 num_elements: int, cutoff: float, num_gaussians: int, grid_points: int,
                 use_pallas: str, mxu_bf16: bool = False):
        super().__init__()
        self.l_max, self.m_max, self.grid_points, self.use_pallas = l_max, m_max, grid_points, use_pallas
        self.mxu_bf16 = mxu_bf16
        self.edge_block = EdgeBlock(edge_channels, num_elements, cutoff, num_gaussians)
        for name, shape in zip(self.weight_names(m_max),
                               escn_layer.weight_shapes(l_max, m_max, c, hidden, edge_channels)):
            setattr(self, name, nn.Parameter(torch.empty(shape)))
        self.fc1_sphere = nn.Linear(2 * c, c, bias=False)
        self.fc2_sphere = nn.Linear(c, c, bias=False)
        self.fc3_sphere = nn.Linear(c, c, bias=False)
        to_g, from_g = grid_mats(l_max, grid_points)
        self.register_buffer("to_g", torch.as_tensor(to_g, dtype=torch.float32), persistent=False)
        self.register_buffer("from_g", torch.as_tensor(from_g, dtype=torch.float32),
                             persistent=False)

    @staticmethod
    def weight_names(m_max: int):
        names = ["wg", "bg", "w1_0", "w2_0"]
        for m in range(1, m_max + 1):
            names += [f"fc1_m{m}", f"w2r_m{m}", f"w2i_m{m}"]
        return names

    def forward(self, x, dcomp, dist_d, z_src_d, z_dst_d):
        xe = self.edge_block(dist_d, z_src_d, z_dst_d)
        ws = [getattr(self, n) for n in self.weight_names(self.m_max)]
        kw = dict(l_max=self.l_max, m_max=self.m_max, n_grid=self.grid_points,
                  mxu_bf16=self.mxu_bf16)
        if self.use_pallas == "fused":
            msg = escn_layer.escn_message(x.contiguous(), dcomp, xe.contiguous(), *ws, **kw)
        else:
            msg = escn_layer.escn_fwd_reference(x, dcomp, xe, *ws, **kw)
        # node-level MLP on [x, message] over the FULL grid (node features carry
        # every m up to L)
        g = torch.cat([torch.einsum("ps,basc->bapc", self.to_g, x),
                       torch.einsum("ps,basc->bapc", self.to_g, msg)], dim=-1)
        g = F.silu(self.fc1_sphere(g))
        g = F.silu(self.fc2_sphere(g))
        return torch.einsum("sp,bapc->basc", self.from_g, self.fc3_sphere(g))


@register_model("escn")
class ESCN(nn.Module):
    """eSCN in float32 or bf16 (`compute_dtype`); defaults follow the
    reference's config/model/escn-oc.yaml.

    Built on `device` (the card unless the caller names another) with
    weights drawn from `generator` with flax's initialisers (truncated
    lecun-normal kernels, zero biases, endpoint embeddings uniform in
    ±0.001). Forces come from the direct head (`derivative_forces` False).
    """

    derivative_forces = False

    def __init__(
        self,
        num_layers: int = 8,
        l_max: int = 6,
        m_max: int = 2,
        sphere_channels: int = 128,
        hidden: int = 256,
        edge_channels: int = 128,
        cutoff: float = 8.0,
        max_neighbors: int = 40,
        num_elements: int = 65,
        num_sphere_samples: int = 128,
        distance_resolution: float = 0.02,
        grid_points_factor: int = 2,
        compute_dtype: str = "float32",
        energy_mean: float = 0.0,
        energy_std: float = 1.0,
        use_pallas: str = "off",  # off | fused
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if use_pallas not in ("off", "fused"):
            raise ValueError(f"use_pallas must be off|fused, got {use_pallas!r}")
        self.cdt = compute_dtype_of(compute_dtype, "eSCN")
        c = sphere_channels
        self.num_layers, self.l_max, self.m_max, self.c = num_layers, l_max, m_max, c
        self.cutoff, self.max_neighbors = cutoff, max_neighbors
        self.num_sphere_samples, self.use_pallas = num_sphere_samples, use_pallas
        self.energy_mean, self.energy_std = energy_mean, energy_std
        s = (l_max + 1) ** 2
        num_gauss = int(round(cutoff / distance_resolution))
        self.sphere_embedding = nn.Embedding(num_elements, c)
        self.layers = nn.ModuleList(
            ESCNLayer(l_max, m_max, c, hidden, edge_channels, num_elements, cutoff, num_gauss,
                      grid_points_factor * s, use_pallas, self.cdt == torch.bfloat16)
            for _ in range(num_layers))
        for head in ("energy", "force"):
            setattr(self, f"{head}_fc1", nn.Linear(c, c))
            setattr(self, f"{head}_fc2", nn.Linear(c, c))
            setattr(self, f"{head}_fc3", nn.Linear(c, 1, bias=False))
        self.register_buffer("pts", torch.as_tensor(fibonacci_sphere(num_sphere_samples),
                                                    dtype=torch.float32), persistent=False)
        self.register_buffer("y_pts", torch.as_tensor(sh_on_points(l_max, num_sphere_samples),
                                                      dtype=torch.float32), persistent=False)
        self.reset_parameters(generator)
        self.to(resolve_device(device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            lecun_normal_(self.sphere_embedding.weight, fan_in=self.c, generator=generator)
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
                elif isinstance(m, EdgeBlock):
                    for emb in (m.src_embed, m.dst_embed):
                        emb.weight.uniform_(-0.001, 0.001, generator=generator)
                elif isinstance(m, ESCNLayer):
                    for name in m.weight_names(m.m_max):
                        p = getattr(m, name)
                        if name == "bg":
                            p.zero_()
                        else:  # flax's fan-in of a stacked [2, in, out] kernel
                            lecun_normal_(p, fan_in=p.shape[0] * p.shape[1], generator=generator)

    def forward(self, batch: MolBatch) -> ModelOutput:
        z = batch.z.long()
        b, a = z.shape
        nl = graph.neighbor_list(batch.pos, batch.node_mask, self.cutoff, self.max_neighbors)
        # the dense pair lattice, scattered from the top-K list; positions are
        # never differentiated (direct forces), so the rotations are constants
        mask_d, unit_d, dist_d = graph.dense_from_neighbor_list(nl, a)
        with torch.no_grad():
            rot_d = so3.rot_to_z(unit_d)
            dcomp = (so3.wigner_trunc_compact_from_rot(rot_d, self.l_max, self.m_max)
                     * mask_d[..., None]).contiguous()
        z_src_d = z[:, None, :].expand(b, a, a)
        z_dst_d = z[:, :, None].expand(b, a, a)

        x = batch.pos.new_zeros((b, a, (self.l_max + 1) ** 2, self.c))
        emb = self.sphere_embedding(z)  # flax Embed(dtype=bfloat16) rounds the rows
        x[:, :, 0, :] = emb.to(self.cdt) if self.cdt == torch.bfloat16 else emb
        for i, layer in enumerate(self.layers):
            out = layer(x, dcomp, dist_d, z_src_d, z_dst_d)
            x = out if i == 0 else x + out

        # sphere-sampled heads
        x_pt = torch.einsum("ps,basc->bapc", self.y_pts, x)
        h = F.silu(self.energy_fc1(x_pt))
        h = F.silu(self.energy_fc2(h))
        node_energy = self.energy_fc3(h)[..., 0].mean(dim=-1) * 0.001
        node_energy = node_energy * self.energy_std + self.energy_mean
        energy = torch.where(batch.node_mask, node_energy, torch.zeros_like(node_energy)).sum(1)
        f = F.silu(self.force_fc1(x_pt))
        f = F.silu(self.force_fc2(f))
        f = self.force_fc3(f)[..., 0]
        forces = torch.einsum("bap,pc->bac", f, self.pts) / self.num_sphere_samples
        return {"energy": energy, "forces": forces * batch.node_mask[..., None]}
