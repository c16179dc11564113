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
the step; its offset on the card counts the draws); in ``eval()`` mode
dropk is ones and nothing is dropped. Parameters are named as the flax tree
of the Pallas layout (`models/convert.load_flax_params`).
``compute_dtype="bfloat16"`` is not ported and raises.

``m_share_rad=False`` builds the reference-compatible variant that serves
the published checkpoints (the JAX model's XLA-only path,
``nabladft_tpu/models/equiformer_v2.py:563-590, 631-660``): per-m internal
radial MLPs in each attention's first SO(2) conv, per-block atom-edge
embeddings, the raw Gaussian basis (600 of them in the checkpoints'
config), the exact 'layer_norm_sh', the reference FFN (scalar MLP,
SO3_LinearV2, grid MLP), the reference edge-degree embedding (÷ avg_degree)
and the energy ÷ avg_num_nodes; its parameters carry the XLA tree's names.
The JAX package has no kernel for it either, so it is a plain PyTorch path
chosen by the variant at construction: asking for ``use_pallas="fused"``
with it raises, and kernels O and P never run there.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models.base import (
    LayerNormParams, ModelOutput, init_linear_, lecun_normal_, register_model,
)
from nabladft_tpu_torch.ops import eqv2_attn, graph, so3
from nabladft_tpu_torch.ops.escn_layer import _expand_matrix, _spans, grid_act, grid_mats
from nabladft_tpu_torch.ops.radial import gaussian_smearing
from nabladft_tpu_torch.utils import resolve_device

ALPHA_DROP, DROP_PATH = 0.1, 0.05  # the JAX modules' rates
LN_EPS_REF = 1e-5  # torch.nn.LayerNorm's, in the reference-compatible variant


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


# ---------------------------------------------------------------------------
# the reference-compatible variant (m_share_rad=False), plain PyTorch
# ---------------------------------------------------------------------------


class RadialFn(nn.Module):
    """The reference RadialFunction: Linear → LayerNorm (eps 1e-5) → SiLU
    stacks, a plain Linear last."""

    def __init__(self, c_in: int, channels):
        super().__init__()
        dims = (c_in, *channels)
        self.n = len(channels)
        for i in range(self.n):
            setattr(self, f"lin_{i}", nn.Linear(dims[i], dims[i + 1]))
            if i < self.n - 1:
                setattr(self, f"ln_{i}", LayerNormParams(dims[i + 1]))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"lin_{i}")(x)
            if i < self.n - 1:
                ln = getattr(self, f"ln_{i}")
                x = F.silu(F.layer_norm(x, x.shape[-1:], ln.scale, ln.bias, eps=LN_EPS_REF))
        return x


class SO2ConvRef(nn.Module):
    """The reference SO2_Convolution on m-major stacks [..., S_t, c_in]:
    fc_m0 with a bias and `extra` invariant outputs after the per-l ones,
    bias-free (fc_r, fc_i) per m; with `rad_hidden`, an internal
    RadialFunction of the edge scalars scales each m-block's input per
    (l, channel)."""

    def __init__(self, l_max: int, m_max: int, c_in: int, co: int, extra: int = 0,
                 edge_in: int = 0, rad_hidden=()):
        super().__init__()
        self.l_max, self.m_max, self.c_in, self.co = l_max, m_max, c_in, co
        n0 = l_max + 1
        if rad_hidden:
            n_rad = sum((l_max + 1 - m) * c_in for m in range(m_max + 1))
            self.rad_func = RadialFn(edge_in, (*rad_hidden, n_rad))
        self.fc_m0 = nn.Linear(n0 * c_in, n0 * co + extra)
        for m in range(1, m_max + 1):
            n_l = l_max + 1 - m
            setattr(self, f"fc_r_m{m}", nn.Linear(n_l * c_in, n_l * co, bias=False))
            setattr(self, f"fc_i_m{m}", nn.Linear(n_l * c_in, n_l * co, bias=False))

    def forward(self, x_t, x_edge):
        lead, c_in, co = x_t.shape[:-2], self.c_in, self.co
        spans = _spans(self.l_max, self.m_max)
        rad = self.rad_func(x_edge) if hasattr(self, "rad_func") else None
        s0, n0 = spans[0]
        flat0 = x_t[..., s0:s0 + n0, :].reshape(*lead, -1)
        off = n0 * c_in
        if rad is not None:
            flat0 = flat0 * rad[..., :off]
        h0 = self.fc_m0(flat0)
        parts = [h0[..., :n0 * co].reshape(*lead, n0, co)]
        for m in range(1, self.m_max + 1):
            (sp, n_l), (sm, _) = spans[2 * m - 1], spans[2 * m]
            fp = x_t[..., sp:sp + n_l, :].reshape(*lead, -1)
            fm = x_t[..., sm:sm + n_l, :].reshape(*lead, -1)
            if rad is not None:
                rad_m = rad[..., off:off + n_l * c_in]
                fp, fm = fp * rad_m, fm * rad_m
                off += n_l * c_in
            wr, wi = getattr(self, f"fc_r_m{m}"), getattr(self, f"fc_i_m{m}")
            parts += [(wr(fp) - wi(fm)).reshape(*lead, n_l, co),
                      (wr(fm) + wi(fp)).reshape(*lead, n_l, co)]
        return torch.cat(parts, dim=-2), h0[..., n0 * co:]


def smooth_leaky_relu(x, alpha: float = 0.2):
    """The reference SmoothLeakyReLU (activation.py:58-66)."""
    return (1 + alpha) / 2 * x + (1 - alpha) / 2 * x * (2 * torch.sigmoid(x) - 1)


class RefSO2GraphAttention(nn.Module):
    """The reference SO2EquivariantGraphAttention (transformer_block.py:22-326)
    over the K-compacted neighbour list: per-attention source / target atom
    embeddings appended to the raw edge basis, SO2 conv 1 with its per-m
    radial MLP, the separable S2 activation (the grid silu on rows 1.., a
    silu of the gate scalars on row 0), SO2 conv 2, alpha from LayerNorm
    (eps 1e-5) → SmoothLeakyReLU → alpha_dot, a softmax over each receiver's
    live edges, then the per-l projection."""

    def __init__(self, l_max: int, m_max: int, c: int, num_heads: int, alpha_channels: int,
                 value_channels: int, hidden_channels: int, out_channels: int, edge_channels: int,
                 num_basis: int, num_elements: int, grid_points: int):
        super().__init__()
        self.l_max, self.m_max, self.grid_points = l_max, m_max, grid_points
        self.nh, self.va, self.vc = num_heads, alpha_channels, value_channels
        hid, co, edge_in = hidden_channels, num_heads * value_channels, num_basis + 2 * edge_channels
        self.source_embedding = nn.Embedding(num_elements, edge_channels)
        self.target_embedding = nn.Embedding(num_elements, edge_channels)
        self.so2_conv_1 = SO2ConvRef(l_max, m_max, 2 * c, hid, num_heads * alpha_channels + hid,
                                     edge_in, (edge_channels, edge_channels))
        self.so2_conv_2 = SO2ConvRef(l_max, m_max, hid, co)
        self.alpha_norm = LayerNormParams(alpha_channels)
        self.alpha_dot = nn.Parameter(torch.empty(num_heads, alpha_channels))
        for l in range(l_max + 1):
            setattr(self, f"proj_l{l}", nn.Linear(co, out_channels, bias=l == 0))

    def forward(self, x, ctx: dict, dropk: torch.Tensor) -> torch.Tensor:
        nh, va, dt, idx = self.nh, self.va, ctx["dt"], ctx["idx"]
        x_edge = torch.cat([ctx["basis"], self.source_embedding(ctx["z_src"]),
                            self.target_embedding(ctx["z_dst"])], dim=-1)
        x_src = torch.einsum("bakrs,baksc->bakrc", dt, graph.gather_nodes(x, idx))
        x_tgt = torch.einsum("bakrs,basc->bakrc", dt, x)
        hidden, extra = self.so2_conv_1(torch.cat([x_src, x_tgt], dim=-1), x_edge)
        acted = grid_act(hidden, self.l_max, self.m_max, self.grid_points)
        acted = torch.cat([F.silu(extra[..., nh * va:])[..., None, :], acted[..., 1:, :]], dim=-2)
        values, _ = self.so2_conv_2(acted, x_edge)

        a = extra[..., :nh * va].reshape(*extra.shape[:-1], nh, va)
        a = smooth_leaky_relu(F.layer_norm(a, (va,), self.alpha_norm.scale, self.alpha_norm.bias,
                                           eps=LN_EPS_REF))
        logits = torch.einsum("bakhv,hv->bakh", a, self.alpha_dot)
        live = ctx["maskf"][..., None] > 0.5
        logits = torch.where(live, logits, torch.full_like(logits, -1e9))
        alpha = torch.where(live, torch.softmax(logits, dim=2), torch.zeros_like(logits)) * dropk
        v = values.reshape(*values.shape[:-1], nh, self.vc) * alpha[..., None, :, None]
        agg = torch.einsum("bakrs,bakrc->basc", dt, v.reshape(values.shape))
        return torch.cat([getattr(self, f"proj_l{l}")(agg[..., l * l:(l + 1) * (l + 1), :])
                          for l in range(self.l_max + 1)], dim=-2)


class RefEquivariantLayerNorm(nn.Module):
    """The exact 'layer_norm_sh' (layer_norm.py:117-215): LayerNorm (eps
    1e-5) on l=0; one shared rescale of every l>0 row from the
    degree-balanced second moment (each l weighted 1/((2l+1)L)), times a
    per-(l, channel) affine weight."""

    def __init__(self, l_max: int, c: int):
        super().__init__()
        self.l_max, self.c = l_max, c
        self.ln0 = LayerNormParams(c)
        self.affine_weight = nn.Parameter(torch.ones(l_max, c))
        w = [1.0 / ((2 * l + 1) * l_max) for l in range(1, l_max + 1) for _ in range(2 * l + 1)]
        self.register_buffer("row_w", torch.tensor(w), persistent=False)

    def forward(self, x):  # [B,A,S,C]
        x0 = F.layer_norm(x[..., 0, :], (self.c,), self.ln0.scale, self.ln0.bias, eps=LN_EPS_REF)
        rest = x[..., 1:, :]
        inv = torch.rsqrt(torch.einsum("...ic,i->...c", rest * rest, self.row_w.to(x.dtype))
                          .mean(dim=-1) + LN_EPS_REF)
        outs = [x0[..., None, :]]
        for l in range(1, self.l_max + 1):
            outs.append(x[..., l * l:(l + 1) * (l + 1), :] * inv[..., None, None]
                        * self.affine_weight[l - 1])
        return torch.cat(outs, dim=-2)


class SO3LinearV2(nn.Module):
    """A per-l linear map: one stacked weight [L+1, in, out], a bias on l=0
    (so3.py:603-641)."""

    def __init__(self, l_max: int, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(l_max + 1, c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))
        l_of_row = [l for l in range(l_max + 1) for _ in range(2 * l + 1)]
        self.register_buffer("l_of_row", torch.tensor(l_of_row), persistent=False)

    def forward(self, x):  # [..., S, in]
        out = torch.einsum("...sc,sco->...so", x, self.weight[self.l_of_row])
        return torch.cat([(out[..., 0, :] + self.bias)[..., None, :], out[..., 1:, :]], dim=-2)


class RefFFN(nn.Module):
    """The reference FeedForwardNetwork with the grid MLP and separable S2
    (transformer_block.py:328-455)."""

    def __init__(self, l_max: int, c: int, hidden: int, out_channels: int, grid_points: int):
        super().__init__()
        self.scalar_mlp = nn.Linear(c, hidden)
        self.so3_linear_1 = SO3LinearV2(l_max, c, hidden)
        for i in range(3):
            setattr(self, f"grid_{i}", nn.Linear(hidden, hidden, bias=False))
        self.so3_linear_2 = SO3LinearV2(l_max, hidden, out_channels)
        to_g, from_g = grid_mats(l_max, grid_points)
        self.register_buffer("to_g", torch.as_tensor(to_g, dtype=torch.float32), persistent=False)
        self.register_buffer("from_g", torch.as_tensor(from_g, dtype=torch.float32),
                             persistent=False)

    def forward(self, x):  # [B,A,S,C]
        scal = F.silu(self.scalar_mlp(x[..., 0, :]))
        g = torch.einsum("ps,basc->bapc", self.to_g, self.so3_linear_1(x))
        g = F.silu(self.grid_1(F.silu(self.grid_0(g))))
        h = torch.einsum("sp,bapc->basc", self.from_g, self.grid_2(g))
        return self.so3_linear_2(torch.cat([scal[..., None, :], h[..., 1:, :]], dim=-2))


class RefTransBlockV2(nn.Module):
    def __init__(self, l_max: int, m_max: int, c: int, num_heads: int, alpha_channels: int,
                 value_channels: int, hidden_channels: int, ffn_hidden: int, edge_channels: int,
                 num_basis: int, num_elements: int, grid_points: int):
        super().__init__()
        self.norm_1 = RefEquivariantLayerNorm(l_max, c)
        self.ga = RefSO2GraphAttention(l_max, m_max, c, num_heads, alpha_channels, value_channels,
                                       hidden_channels, c, edge_channels, num_basis, num_elements,
                                       grid_points)
        self.norm_2 = RefEquivariantLayerNorm(l_max, c)
        self.ffn = RefFFN(l_max, c, ffn_hidden, c, grid_points)

    def forward(self, x, ctx: dict, model: "EquiformerV2"):
        h = self.ga(self.norm_1(x), ctx, model.alpha_keep(ctx))
        x = x + model.drop_path(h)
        return x + model.drop_path(self.ffn(self.norm_2(x)))


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
        attn_hidden_channels: int = 0,
        basis_width_scalar: float = 2.0,
        avg_num_nodes: float = 39.65745326960467,
        avg_degree: float = 19.16009564536883,
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
        if not m_share_rad and use_pallas == "fused":
            raise ValueError("m_share_rad=False (the reference-compatible variant) has no fused "
                             "kernel, in the JAX package either: build it with use_pallas='off'")
        c, s = sphere_channels, (l_max + 1) ** 2
        self.num_layers, self.l_max, self.m_max, self.c = num_layers, l_max, m_max, c
        self.sphere_channels, self.num_heads, self.edge_channels = c, num_heads, edge_channels
        self.attn_alpha_channels, self.attn_value_channels = attn_alpha_channels, attn_value_channels
        self.attn_hidden_channels = attn_hidden_channels
        self.cutoff, self.max_neighbors = cutoff, max_neighbors
        self.num_distance_basis, self.use_pallas = num_distance_basis, use_pallas
        self.energy_mean, self.energy_std = energy_mean, energy_std
        self.m_share_rad, self.basis_width_scalar = m_share_rad, basis_width_scalar
        self.avg_num_nodes, self.avg_degree = avg_num_nodes, avg_degree
        gp = grid_points_factor * s
        self.sphere_embedding = nn.Embedding(num_elements, c)
        attn = (l_max, m_max, c, num_heads, attn_alpha_channels, attn_value_channels)
        if m_share_rad:
            self.src_embed = nn.Embedding(num_elements, edge_channels)
            self.dst_embed = nn.Embedding(num_elements, edge_channels)
            self.dist_proj = nn.Linear(num_distance_basis, edge_channels)
            self.edge_degree_proj = nn.Linear(3 * edge_channels, (l_max + 1) * c)
            for i in range(num_layers):
                setattr(self, f"block_{i}", TransBlockV2(*attn, ffn_hidden_channels,
                                                         3 * edge_channels, gp, use_pallas))
            self.norm_final = EquivariantLayerNorm(l_max, c)
            self.energy_ffn = GridFFN(l_max, c, ffn_hidden_channels, 1, gp)
            self.force_block = SO2GraphAttention(*attn, 1, 3 * edge_channels, gp, use_pallas)
        else:
            hid = attn_hidden_channels or num_heads * attn_value_channels
            edge = (edge_channels, num_distance_basis, num_elements, gp)
            self.edge_degree_source_embedding = nn.Embedding(num_elements, edge_channels)
            self.edge_degree_target_embedding = nn.Embedding(num_elements, edge_channels)
            self.edge_degree_rad = RadialFn(num_distance_basis + 2 * edge_channels,
                                            (edge_channels, edge_channels, (l_max + 1) * c))
            for i in range(num_layers):
                setattr(self, f"block_{i}", RefTransBlockV2(*attn, hid, ffn_hidden_channels,
                                                            *edge))
            self.norm_final = RefEquivariantLayerNorm(l_max, c)
            self.energy_block = RefFFN(l_max, c, ffn_hidden_channels, 1, gp)
            self.force_block = RefSO2GraphAttention(*attn, hid, 1, *edge)
            self.register_buffer("expand", torch.from_numpy(_expand_matrix(l_max, m_max)),
                                 persistent=False)
        # the generator of the train-mode dropout masks (None: torch's default)
        self.dropout_generator: Optional[torch.Generator] = None
        self.reset_parameters(generator)
        self.to(resolve_device(device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
                elif isinstance(m, nn.Embedding) and name.endswith(("source_embedding",
                                                                    "target_embedding")):
                    # the reference's atom-edge embeddings: uniform ±0.001
                    m.weight.uniform_(-0.001, 0.001, generator=generator)
                elif isinstance(m, nn.Embedding):
                    lecun_normal_(m.weight, fan_in=m.embedding_dim, generator=generator)
                elif isinstance(m, SO3LinearV2):
                    bound = 1.0 / math.sqrt(m.weight.shape[1])
                    m.weight.uniform_(-bound, bound, generator=generator)
                elif isinstance(m, RefSO2GraphAttention):
                    m.alpha_dot.normal_(0.0, 1.0, generator=generator)
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
        keep = self.bernoulli_keep((*m.shape, self.num_heads), 1.0 - ALPHA_DROP, m.device)
        return keep.to(m.dtype) / (1.0 - ALPHA_DROP)

    def drop_path(self, h: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return h
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

    def ref_edge_inputs(self, pos: torch.Tensor, node_mask: torch.Tensor, z: torch.Tensor) -> dict:
        """The reference-compatible variant's edge inputs: idx, d (compact,
        masked), dt = the dense m-major truncated rotations [B,A,K,S_t,S],
        basis (the raw Gaussians of the reference GaussianSmearing), z_src,
        z_dst, maskf and `ones`."""
        b, a = z.shape
        nl = graph.neighbor_list(pos, node_mask, self.cutoff, self.max_neighbors)
        k = nl.idx.shape[2]
        maskf = nl.mask.to(pos.dtype)
        with torch.no_grad():
            rot = so3.rot_to_z(graph.edge_rotation_vectors(nl.unit, nl.mask))
            dcomp = so3.wigner_trunc_compact_from_rot(rot, self.l_max, self.m_max) * maskf[..., None]
            dt = (dcomp @ self.expand.to(dcomp.dtype)).reshape(b, a, k, -1, (self.l_max + 1) ** 2)
        n = self.num_distance_basis
        centers = torch.linspace(0.0, self.cutoff, n, dtype=pos.dtype, device=pos.device)
        coeff = -0.5 / (self.basis_width_scalar * float(self.cutoff / (n - 1))) ** 2
        basis = torch.exp(coeff * (nl.dist[..., None] - centers) ** 2)
        z_src = graph.gather_nodes(z[..., None], nl.idx)[..., 0]
        return dict(idx=nl.idx, d=dcomp, dt=dt, basis=basis, z_src=z_src,
                    z_dst=z[:, :, None].expand(b, a, k), maskf=maskf,
                    ones=maskf.new_ones((b, a, k, self.num_heads)))

    def forward(self, batch: MolBatch) -> ModelOutput:
        z = batch.z.long()
        b, a = z.shape
        L, C = self.l_max, self.c
        ref = not self.m_share_rad
        ctx = (self.ref_edge_inputs if ref else self.edge_inputs)(batch.pos, batch.node_mask, z)
        dcomp, k = ctx["d"], ctx["d"].shape[2]

        x = batch.pos.new_zeros((b, a, (L + 1) ** 2, C))
        x[:, :, 0, :] = self.sphere_embedding(z)
        # edge-degree embedding: each edge's m=0 radial rows rotated back with
        # the compact values (row (l, 0) of block l), summed over neighbours in
        # the contraction
        if ref:
            deg = self.edge_degree_rad(torch.cat([
                ctx["basis"], self.edge_degree_source_embedding(ctx["z_src"]),
                self.edge_degree_target_embedding(ctx["z_dst"])], dim=-1))
            rescale = self.avg_degree
        else:
            deg = self.edge_degree_proj(ctx["xe"])
            rescale = math.sqrt(float(self.max_neighbors))
        deg = deg.reshape(b, a, k, L + 1, C)
        offs, _ = so3.trunc_compact_layout(L, self.m_max)
        cols = []
        for l in range(L + 1):
            base = offs[l] + min(l, self.m_max) * (2 * l + 1)
            cols.append(torch.einsum("bajn,bajc->banc", dcomp[..., base:base + 2 * l + 1],
                                     deg[..., l, :]))
        x = x + torch.cat(cols, dim=-2) / rescale
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x, ctx, self)
        x = self.norm_final(x)

        if ref:
            node_e = self.energy_block(x)[..., 0, 0]
            energy = torch.where(batch.node_mask, node_e, torch.zeros_like(node_e)).sum(dim=1)
            n_atoms = batch.node_mask.sum(dim=1).to(energy.dtype)
            energy = energy / self.avg_num_nodes * self.energy_std + self.energy_mean * n_atoms
            # the reference's force block has no alpha dropout
            l1 = self.force_block(x, ctx, ctx["ones"])[..., 1:4, 0]  # (y, z, x)
        else:
            node_e = self.energy_ffn(x)[..., 0, 0] * self.energy_std + self.energy_mean
            energy = torch.where(batch.node_mask, node_e, torch.zeros_like(node_e)).sum(dim=1)
            l1 = self.force_block(x, ctx, self.alpha_keep(ctx))[..., 1:4, 0]  # (y, z, x)
        forces = torch.stack([l1[..., 2], l1[..., 0], l1[..., 1]], dim=-1)
        return {"energy": energy, "forces": forces * batch.node_mask[..., None]}
