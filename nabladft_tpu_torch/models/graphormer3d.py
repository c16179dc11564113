"""Graphormer3D: an all-pairs transformer with a Gaussian edge bias.

The port of ``nabladft_tpu/models/graphormer3d.py`` (the reference's
nablaDFT/graphormer/graphormer_3d.py:227-321, Graphormer3D-small: 4 blocks
× 6 layers whose weights the blocks share, 512 dim, 32 heads, 128 Gaussian
kernels; direct forces from the attention-weighted Δpos head,
graphormer_3d.py:185-225). Batches are dense [B, A] with a padding mask, so
the model is batched matmuls and softmax: attention is written out (scaled
logits plus the additive bias with -1e9 on padding senders, softmax, the
weighted sum), GELU is the exact erf form, and the per-atom energy is
standardised before padding is masked (masking first would add
(A - n_atoms) · energy_mean per molecule).

Dropout as the JAX train job (which builds the model non-deterministic for
training): in ``train()`` mode each of the seven sites (input, attention
probabilities, after attention, activation, after the FFN, the energy head
and the force head's probabilities) with a rate above 0 draws a keep mask
from `dropout_generator` (the trainer seeds one from its seed and the
step), scaled by 1/(1-p); in ``eval()`` mode nothing is dropped.
Parameters are named as the flax tree (`models/convert.load_flax_params`).

``compute_dtype="bfloat16"`` runs as the JAX model's: the embeddings, the
edge projection and the bias MLP, the encoder layers (LayerNorm computed in
float32 and cast) and the force head's projections in bf16, with the JAX
model's float32 islands: the attention logits and softmax, the additive bias
(cast back to float32 where it joins the logits), the force features before
their readout, `final_ln` on the widened residual stream, and the energy
head. Parameters stay float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models.base import (
    LayerNormParams, Linear, ModelOutput, compute_dtype_of, embed, gelu, init_linear_,
    lecun_normal_, register_model,
)
from nabladft_tpu_torch.utils import resolve_device

def _layer_norm(p: LayerNormParams, x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm, epsilon 1e-5: computed in float32, the output in x's
    dtype (flax's ``LayerNorm(dtype=...)``)."""
    return F.layer_norm(x.float(), (x.shape[-1],), p.scale, p.bias, 1e-5).to(x.dtype)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)


def _scale(q: torch.Tensor) -> torch.Tensor:
    """The query scale d_head^-1/2 in q's dtype, as JAX rounds it."""
    return q.new_tensor(q.shape[-1] ** -0.5)


class GaussianEdgeLayer(nn.Module):
    """Distance → K Gaussians after a per-edge-type affine (the reference's
    GaussianLayer, graphormer_3d.py:126-146)."""

    def __init__(self, num_kernels: int, num_edge_types: int):
        super().__init__()
        self.embed_0 = nn.Embedding(num_edge_types, 1)  # mul
        self.embed_1 = nn.Embedding(num_edge_types, 1)  # bias
        self.means = nn.Parameter(torch.empty(num_kernels))
        self.stds = nn.Parameter(torch.empty(num_kernels))

    def forward(self, dist, edge_type):
        x = self.embed_0(edge_type)[..., 0] * dist + self.embed_1(edge_type)[..., 0]
        std = torch.abs(self.stds) + 1e-5
        z = (x[..., None] - self.means) / std
        return torch.exp(-0.5 * z * z) / (math.sqrt(2 * math.pi) * std)


class EncoderLayer(nn.Module):
    """Pre-LN self-attention with an additive bias [B, H, A, A], then the FFN."""

    def __init__(self, embed_dim: int, ffn_dim: int, heads: int, dropout: float,
                 attention_dropout: float, activation_dropout: float, drop,
                 cdt: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.rates = (dropout, attention_dropout, activation_dropout)
        self.layernorm_0 = LayerNormParams(embed_dim)
        self.dense_0 = Linear(embed_dim, 3 * embed_dim, compute_dtype=cdt)
        self.dense_1 = Linear(embed_dim, embed_dim, compute_dtype=cdt)
        self.layernorm_1 = LayerNormParams(embed_dim)
        self.dense_2 = Linear(embed_dim, ffn_dim, compute_dtype=cdt)
        self.dense_3 = Linear(ffn_dim, embed_dim, compute_dtype=cdt)
        self.drop = drop

    def forward(self, x, attn_bias):
        p_drop, p_attn, p_act = self.rates
        q, k, v = torch.chunk(self.dense_0(_layer_norm(self.layernorm_0, x)), 3, dim=-1)
        q, k, v = _heads(q, self.heads), _heads(k, self.heads), _heads(v, self.heads)
        q = q * _scale(q)
        # the logits and their softmax in float32, the probabilities in x's dtype
        logits = torch.einsum("bihd,bjhd->bhij", q, k).float() + attn_bias
        probs = self.drop(torch.softmax(logits, dim=-1).to(x.dtype), p_attn)
        attn = torch.einsum("bhij,bjhd->bihd", probs, v).reshape(x.shape)
        x = x + self.drop(self.dense_1(attn), p_drop)
        h = self.drop(gelu(self.dense_2(_layer_norm(self.layernorm_1, x))), p_act)
        return x + self.drop(self.dense_3(h), p_drop)


class NodeForceHead(nn.Module):
    """Direct forces: attention probabilities × the Δpos unit vectors ×
    values, one linear readout per component (the reference's NodeTaskHead)."""

    def __init__(self, embed_dim: int, heads: int, drop, cdt: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        for i in range(3):
            setattr(self, f"dense_{i}", Linear(embed_dim, embed_dim, compute_dtype=cdt))
        for i in range(3, 6):
            setattr(self, f"dense_{i}", nn.Linear(embed_dim, 1))
        self.drop = drop

    def forward(self, x, attn_bias, unit):
        q, k, v = (_heads(getattr(self, f"dense_{i}")(x), self.heads) for i in range(3))
        dt = q.dtype
        logits = torch.einsum("bihd,bjhd->bhij", q * _scale(q), k).float() + attn_bias
        probs = self.drop(torch.softmax(logits, dim=-1).to(dt), 0.1)
        unit = unit.to(dt)
        # feat[b,i,c] = Σ_j probs[b,h,i,j] · unit[b,i,j,c] · v[b,j,h], read out in float32
        out = []
        for c in range(3):
            feat = torch.einsum("bhij,bjhd->bihd", probs * unit[:, None, :, :, c], v)
            out.append(getattr(self, f"dense_{3 + c}")(feat.reshape(x.shape).float()))
        return torch.cat(out, dim=-1)  # [B,A,3]


@register_model("graphormer3d")
class Graphormer3D(nn.Module):
    """Graphormer3D in float32 or bfloat16; defaults are the reference's
    config/model/graphormer3d-small.yaml.

    Built on `device` (the card unless the caller names another) with
    weights drawn from `generator` with the flax module's initialisers
    (truncated lecun-normal kernels and embeddings, zero biases, the edge
    affine's mul 1 and bias 0, Gaussian means and stds U[0, 3), the energy
    aggregation factor N(0, 0.01²)).
    """

    derivative_forces = False  # the direct force head

    def __init__(
        self,
        blocks: int = 4,
        layers: int = 6,
        embed_dim: int = 512,
        ffn_embed_dim: int = 512,
        attention_heads: int = 32,
        input_dropout: float = 0.1,
        dropout: float = 0.1,
        attention_dropout: float = 0.0,
        activation_dropout: float = 0.1,
        num_kernel: int = 128,
        atom_types: int = 64,
        compute_dtype: str = "float32",
        energy_mean: float = 0.0,
        energy_std: float = 1.0,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cdt = cdt = compute_dtype_of(compute_dtype, "Graphormer3D")
        self.blocks, self.embed_dim, self.atom_types = blocks, embed_dim, atom_types
        self.input_dropout = input_dropout
        self.energy_mean, self.energy_std = energy_mean, energy_std
        self.dropout_generator: Optional[torch.Generator] = None
        drop = self.dropout  # the layers draw through the model's generator
        self.gbf = GaussianEdgeLayer(num_kernel, atom_types**2)
        self.tag_encoder = nn.Embedding(3, embed_dim)
        self.atom_encoder = nn.Embedding(atom_types, embed_dim)
        self.edge_proj = Linear(num_kernel, embed_dim, compute_dtype=cdt)
        self.bias_proj_0 = Linear(num_kernel, num_kernel, compute_dtype=cdt)
        self.bias_proj_1 = Linear(num_kernel, attention_heads, compute_dtype=cdt)
        self.layers = nn.ModuleList(
            EncoderLayer(embed_dim, ffn_embed_dim, attention_heads, dropout, attention_dropout,
                         activation_dropout, drop, cdt) for _ in range(layers))
        self.final_ln = LayerNormParams(embed_dim)
        self.energy_proj_0 = nn.Linear(embed_dim, embed_dim)
        self.energy_proj_1 = nn.Linear(embed_dim, 1)
        self.energy_agg_factor = nn.Embedding(3, 1)
        self.force_head = NodeForceHead(embed_dim, attention_heads, drop, cdt)
        self.reset_parameters(generator)
        self.to(resolve_device(device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
            for emb in (self.tag_encoder, self.atom_encoder):
                lecun_normal_(emb.weight, fan_in=self.embed_dim, generator=generator)
            self.gbf.embed_0.weight.fill_(1.0)
            self.gbf.embed_1.weight.zero_()
            for t in (self.gbf.means, self.gbf.stds):
                t.uniform_(0.0, 3.0, generator=generator)
            self.energy_agg_factor.weight.normal_(0.0, 0.01, generator=generator)

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """flax Dropout: in train mode keep with probability 1 - rate and
        scale by 1/(1 - rate); a rate of 0 draws nothing."""
        if not self.training or rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.dropout_generator, device=x.device) >= rate
        # 1 - rate in x's dtype, as JAX rounds the weakly typed constant
        return torch.where(keep, x / x.new_tensor(1.0 - rate), x.new_zeros(()))

    def forward(self, batch: MolBatch) -> ModelOutput:
        mask = batch.node_mask
        z = torch.where(mask, batch.z, torch.zeros_like(batch.z)).long()
        tags = mask.long()  # 1 = real atom, 0 = padding
        diff = batch.pos[:, None, :, :] - batch.pos[:, :, None, :]  # pos_j - pos_i
        dist = torch.linalg.norm(diff, dim=-1)
        unit = diff / (dist[..., None] + 1e-5)
        gbf = self.gbf(dist, z[:, :, None] * self.atom_types + z[:, None, :])  # [B,A,A,K]
        # edge features zeroed where the sender is padding
        edge_feat = torch.where(mask[:, None, :, None], gbf, gbf.new_zeros(()))
        cdt = self.cdt
        x = (embed(self.tag_encoder, tags, cdt) + embed(self.atom_encoder, z, cdt)
             + self.edge_proj(edge_feat.sum(2)))
        x = self.dropout(x, self.input_dropout)
        # the bias MLP in the compute dtype, the bias in float32 where it
        # joins the float32 logits
        bias = self.bias_proj_1(gelu(self.bias_proj_0(gbf))).permute(0, 3, 1, 2).float()
        bias = torch.where(mask[:, None, None, :], bias, bias.new_full((), -1e9))
        for _ in range(self.blocks):  # the blocks share the layers' weights
            for layer in self.layers:
                x = layer(x, bias)
        x = _layer_norm(self.final_ln, x.float())
        e = F.gelu(self.energy_proj_0(self.dropout(x, 0.1)))
        e = self.energy_proj_1(e)[..., 0]
        agg = self.energy_agg_factor(tags)[..., 0]
        # standardise first, mask second
        e_atom = (e * agg * self.energy_std + self.energy_mean) * mask
        forces = self.force_head(x, bias, unit) * mask[..., None]
        return {"energy": e_atom.sum(dim=1), "forces": forces}
