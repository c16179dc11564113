"""QHNet: SE(3)-equivariant Hamiltonian-matrix prediction.

The port of ``nabladft_tpu/models/qhnet.py`` (the reference's
config/model/qhnet.yaml: lmax 4 features with 128 channels per l, 5 ConvNet
layers over a 12 Bohr radius graph, Self / Pair heads after layer
`start_layer`, and a wigner-3j `Expansion` into per-pair orbital blocks,
assembled into the full symmetric H). Features are per-l tensors
``x[l]: [B, A, C, 2l+1]``; pairs live on the dense [B, A, A] lattice with two
masks (the radius graph and the full graph).

The Conv and Pair layers' tensor products run in one of two modes:

  * ``use_pallas="off"``   — the einsum path (`weighted_tensor_product`,
    `self_tensor_product`), differentiable by autograd;
  * ``use_pallas="fused"`` — `ops.qhnet_tp.conv_tp` (CUDA kernel I forward,
    J backward) and `pair_tp` (K forward, L backward). On CPU tensors the
    same ops run their plain versions.

``remat`` recomputes each Conv and Pair layer and the pair head in the
backward pass (`torch.utils.checkpoint`), as the JAX package's `nn.remat`.
Parameters are named as the flax tree (`models/convert.load_flax_params`).
``ref_compat`` (the wiring of checkpoints converted from the reference)
waits for pretrained restore and raises.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models.base import (
    MLP, ModelOutput, init_linear_, lecun_normal_, register_model, shifted_softplus,
)
from nabladft_tpu_torch.ops import graph, so3
from nabladft_tpu_torch.ops import qhnet_tp
from nabladft_tpu_torch.ops.radial import ExpBernsteinRBF
from nabladft_tpu_torch.utils import resolve_device

# def2-SVP contracted shells per element (l of each shell); the pipeline
# reads the basis from the Hamiltonian database's basisset table instead
DEF2_SVP_ORBITALS: Dict[int, Tuple[int, ...]] = {
    1: (0, 0, 1),
    6: (0, 0, 0, 1, 1, 2),
    7: (0, 0, 0, 1, 1, 2),
    8: (0, 0, 0, 1, 1, 2),
    9: (0, 0, 0, 1, 1, 2),
    16: (0, 0, 0, 0, 1, 1, 1, 2),
    17: (0, 0, 0, 0, 1, 1, 1, 2),
    35: (0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2),
}

LMAX = qhnet_tp.LMAX  # feature lmax (reference sh_lmax=4)
N_PATHS = len(qhnet_tp.tp_paths(LMAX))


class OrbitalLayout:
    """Static per-element orbital bookkeeping: the generic block basis is
    s_max×l0 + p_max×l1 + d_max×l2 (R slots); each element uses a prefix of
    each l-group (`valid`, and `rank` its compressed position)."""

    def __init__(self, orbitals: Dict[int, Sequence[int]], num_elements: int = 100):
        self.orbitals = {int(z): tuple(o) for z, o in orbitals.items()}
        counts = {z: [list(o).count(l) for l in range(3)] for z, o in self.orbitals.items()}
        self.mults = [max(c[l] for c in counts.values()) for l in range(3)]
        self.R = sum(m * (2 * l + 1) for l, m in enumerate(self.mults))
        self.valid = np.zeros((num_elements, self.R), bool)
        self.rank = np.zeros((num_elements, self.R), np.int64)
        self.norb = np.zeros((num_elements,), np.int64)
        for z, cnt in counts.items():
            pos = r = 0
            for l, m_max in enumerate(self.mults):
                for sh in range(m_max):
                    for _ in range(2 * l + 1):
                        if sh < cnt[l]:
                            self.valid[z, pos] = True
                            self.rank[z, pos] = r
                            r += 1
                        pos += 1
            self.norb[z] = r

    def group_slices(self) -> List[Tuple[int, int, int]]:
        """[(l, offset, mult)] of the generic block layout."""
        out, off = [], 0
        for l, m in enumerate(self.mults):
            out.append((l, off, m))
            off += m * (2 * l + 1)
        return out


# ---------------------------------------------------------------------------
# equivariant building blocks (per-l feature lists)
# ---------------------------------------------------------------------------


class IrrepsLinear(nn.Module):
    """Per-l channel mix; bias on l=0 only (e3nn o3.Linear semantics)."""

    def __init__(self, in_ch: int, out_ch: int, lmax: int = LMAX):
        super().__init__()
        for l in range(lmax + 1):
            setattr(self, f"l{l}", nn.Linear(in_ch, out_ch, bias=(l == 0)))
        self.lmax = lmax

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [getattr(self, f"l{l}")(x.transpose(-1, -2)).transpose(-1, -2)
                for l, x in enumerate(xs)]


class NormGate(nn.Module):
    """Scalar-gated nonlinearity (reference layers.py:123-148)."""

    def __init__(self, c: int, lmax: int = LMAX):
        super().__init__()
        self.gate_mlp = MLP((lmax + 1) * c, [(lmax + 1) * c, (lmax + 1) * c])
        self.lmax = lmax

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        norms = [torch.sqrt((x * x).sum(dim=-1) + 1e-8) for x in xs[1:]]
        gates = self.gate_mlp(torch.cat([xs[0][..., 0]] + norms, dim=-1))
        parts = torch.chunk(gates, len(xs), dim=-1)
        return [parts[0][..., None]] + [x * g[..., None] for x, g in zip(xs[1:], parts[1:])]


def inner_products(xs_a: List[torch.Tensor], xs_b: List[torch.Tensor]) -> torch.Tensor:
    """Per-l per-channel invariants <a_l, b_l> / (2l+1): [..., (L+1)·C]."""
    return torch.cat([(a * b).sum(dim=-1) / a.shape[-1] for a, b in zip(xs_a, xs_b)], dim=-1)


def _cg(l1: int, l2: int, l3: int, like: torch.Tensor) -> torch.Tensor:
    return _cg_on(l1, l2, l3, like.dtype, like.device)


@functools.lru_cache(maxsize=None)
def _cg_on(l1: int, l2: int, l3: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """real_cg(l1, l2, l3) as a tensor, copied to each device once."""
    return torch.as_tensor(so3.real_cg(l1, l2, l3), dtype=dtype, device=device)


def weighted_tensor_product(xs: List[torch.Tensor], sh: List[torch.Tensor],
                            weights: List[torch.Tensor], l_out_max: int) -> List[torch.Tensor]:
    """uvu-mode TP: out[l3] += w_path ⊙ (x[l1] ⊗ sh[l2])_{l3} per channel.
    xs[l1]: [..., C, 2l1+1]; sh[l2]: [..., 2l2+1]; weights: P per-path [..., C]."""
    paths = qhnet_tp.tp_paths(len(xs) - 1)
    outs: List[Optional[torch.Tensor]] = [None] * (l_out_max + 1)
    for p, (l1, l2, l3) in enumerate(paths):
        z = torch.einsum("abm,...b->...am", _cg(l1, l2, l3, xs[0]), sh[l2])
        term = torch.einsum("...ca,...am->...cm", xs[l1], z) * weights[p][..., None]
        outs[l3] = term if outs[l3] is None else outs[l3] + term
    return outs


def self_tensor_product(xs_a: List[torch.Tensor], xs_b: List[torch.Tensor], l_out_max: int,
                        weights: List[torch.Tensor]) -> List[torch.Tensor]:
    """uuu-mode TP of two per-l feature lists with per-path-channel weights,
    contracted cg into xs_a first, then xs_b (the broadcast side)."""
    paths = qhnet_tp.tp_paths(len(xs_a) - 1)
    outs: List[Optional[torch.Tensor]] = [None] * (l_out_max + 1)
    for p, (l1, l2, l3) in enumerate(paths):
        z = torch.einsum("abm,...ca->...cbm", _cg(l1, l2, l3, xs_a[0]), xs_a[l1])
        term = torch.einsum("...cbm,...cb->...cm", z, xs_b[l2]) * weights[p][..., None]
        outs[l3] = term if outs[l3] is None else outs[l3] + term
    return outs


class _DenseParams(nn.Module):
    """Raw Dense parameters (kernel [in, out], bias [out]) that are handed to
    the fused kernels rather than applied."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))


class GateMLPSplit(nn.Module):
    """MLP([hidden, out]) returned as (activated hidden, W2, b2), so callers
    finish it per path (h @ W2[:, slice] + b2[slice]) or in a fused kernel.
    Parameters named as the flax MLP's Dense_0 / Dense_1."""

    def __init__(self, in_features: int, hidden: int, out: int, activation=F.silu):
        super().__init__()
        self.dense_0 = nn.Linear(in_features, hidden)
        self.dense_1 = _DenseParams(hidden, out)
        self.activation = activation

    def forward(self, x: torch.Tensor):
        return self.activation(self.dense_0(x)), self.dense_1.kernel, self.dense_1.bias


def _flat_to_list(flat: torch.Tensor, lmax: int) -> List[torch.Tensor]:
    """[..., (L+1)², C] (SH axis at -2) → per-l [..., C, 2l+1]."""
    return [flat[..., l * l:(l + 1) * (l + 1), :].transpose(-1, -2) for l in range(lmax + 1)]


def _list_to_flat(xs: List[torch.Tensor]) -> torch.Tensor:
    """Per-l [..., C, 2l+1] → [..., (L+1)², C]."""
    return torch.cat([x.transpose(-1, -2) for x in xs], dim=-2)


def _path_weights(h_r, w2r, b2r, h_s, w2s, b2s, mask, c: int) -> List[torch.Tensor]:
    """The per-path gate weights [..., C] of the einsum path, zero off `mask`."""
    zero = torch.zeros((), dtype=h_r.dtype, device=h_r.device)
    return [torch.where(mask[..., None],
                        (h_r @ w2r[:, p * c:(p + 1) * c] + b2r[p * c:(p + 1) * c])
                        * (h_s @ w2s[:, p * c:(p + 1) * c] + b2s[p * c:(p + 1) * c]), zero)
            for p in range(N_PATHS)]


def _pair_scalars(xs0: torch.Tensor, ip: torch.Tensor) -> torch.Tensor:
    """[s0_i, s0_j, inner products] per pair: [B,A,A,(L+3)·C]."""
    b, a, c = xs0.shape
    return torch.cat([xs0[:, :, None].expand(b, a, a, c), xs0[:, None].expand(b, a, a, c), ip],
                     dim=-1)


class ConvNetLayer(nn.Module):
    """Radius-graph equivariant convolution (reference layers.py:150-344)."""

    def __init__(self, c: int, rbf_dim: int, use_norm_gate: bool, use_pallas: str):
        super().__init__()
        self.c, self.use_norm_gate, self.use_pallas = c, use_norm_gate, use_pallas
        if use_norm_gate:
            self.linear_pre = IrrepsLinear(c, c)
            self.norm_gate = NormGate(c)
            self.linear_in = IrrepsLinear(c, c)
        self.fc_rbf = GateMLPSplit(rbf_dim, 32, N_PATHS * c, shifted_softplus)
        self.fc_s0 = GateMLPSplit((LMAX + 3) * c, 32, N_PATHS * c, shifted_softplus)
        self.linear_out = IrrepsLinear(c, c)

    def forward(self, xs, sh, rbf, adj, cgsh):
        if self.use_norm_gate:
            pre = self.linear_pre(xs)
            gated = self.linear_in(self.norm_gate(xs))
        else:
            pre = gated = xs
        ip = inner_products([x[:, :, None] for x in pre], [x[:, None, :] for x in pre])
        h_r, w2r, b2r = self.fc_rbf(rbf)
        h_s, w2s, b2s = self.fc_s0(_pair_scalars(pre[0][..., 0], ip))
        if self.use_pallas == "fused":
            x_lat = _list_to_flat(gated).transpose(1, 2).contiguous()  # [B,S,A,C]
            agg = _flat_to_list(qhnet_tp.conv_tp(x_lat, cgsh, h_r.contiguous(), h_s.contiguous(),
                                                 w2r, b2r, w2s, b2s), LMAX)
        else:
            w = _path_weights(h_r, w2r, b2r, h_s, w2s, b2s, adj, self.c)
            x_j = [x[:, None] for x in gated]
            agg = [m.sum(dim=2) for m in weighted_tensor_product(x_j, sh, w, LMAX)]
        return self.linear_out([a + g for a, g in zip(agg, gated)])


class SelfNetLayer(nn.Module):
    """Node self tensor product → diagonal-block features (layers.py:495-583)."""

    def __init__(self, c: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ng1, self.lin1 = NormGate(c), IrrepsLinear(c, c)
        self.ng2, self.lin2 = NormGate(c), IrrepsLinear(c, c)
        self.tp_weights = nn.Parameter(torch.randn(N_PATHS, c, generator=generator))
        self.ng3, self.lin3 = NormGate(c), IrrepsLinear(c, c)

    def forward(self, xs, old_fii):
        xl = self.lin1(self.ng1(xs))
        xr = self.lin2(self.ng2(xs))
        tp = self_tensor_product(xl, xr, LMAX, list(self.tp_weights))
        out = self.lin3(self.ng3([a + b for a, b in zip(tp, xs)]))
        return out if old_fii is None else [a + b for a, b in zip(out, old_fii)]


class PairNetLayer(nn.Module):
    """Pairwise tensor product → off-diagonal block features (layers.py:346-494)."""

    def __init__(self, c: int, rbf_dim: int, use_pallas: str):
        super().__init__()
        self.c, self.use_pallas = c, use_pallas
        self.lin_inner = IrrepsLinear(c, c)
        self.ng_pre, self.lin_n = NormGate(c), IrrepsLinear(c, c)
        self.fc_rbf = GateMLPSplit(rbf_dim, 8, N_PATHS * c, shifted_softplus)
        self.fc_s0 = GateMLPSplit((LMAX + 3) * c, c, N_PATHS * c)
        self.ng_post, self.lin_out = NormGate(c), IrrepsLinear(c, c)
        self.register_buffer("cgz_t", torch.from_numpy(qhnet_tp.cgz_matrix(LMAX)),
                             persistent=False)

    def forward(self, xs, rbf_full, full_mask, old_fij):
        inner = self.lin_inner(xs)
        ip = inner_products([x[:, :, None] for x in inner], [x[:, None, :] for x in inner])
        node = self.lin_n(self.ng_pre(xs))
        h_r, w2r, b2r = self.fc_rbf(rbf_full)
        h_s, w2s, b2s = self.fc_s0(_pair_scalars(inner[0][..., 0], ip))
        if self.use_pallas == "fused":
            node_flat = _list_to_flat(node)  # [B,A,S,C]
            zi = torch.einsum("basc,sk->bakc", node_flat, self.cgz_t).contiguous()  # [B,A,Kz,C]
            maskf = full_mask.to(node_flat.dtype)[..., None].contiguous()
            fij = qhnet_tp.pair_tp(node_flat.transpose(1, 2).contiguous(), zi, maskf,
                                   h_r.contiguous(), h_s.contiguous(), w2r, b2r, w2s, b2s)
            pair = [fij[:, :, l * l:(l + 1) * (l + 1)].permute(0, 1, 3, 4, 2)
                    for l in range(LMAX + 1)]  # [B,A,A,C,2l+1]
        else:
            w = _path_weights(h_r, w2r, b2r, h_s, w2s, b2s, full_mask, self.c)
            pair = self_tensor_product([x[:, :, None] for x in node], [x[:, None] for x in node],
                                       LMAX, w)
        out = self.lin_out(self.ng_post(pair))
        return out if old_fij is None else [a + b for a, b in zip(out, old_fij)]


class Expansion(nn.Module):
    """Irreps features → generic orbital block via wigner-3j paths
    (reference layers.py:585-656). No parameters."""

    def __init__(self, layout: OrbitalLayout):
        super().__init__()
        self.layout = layout

    def forward(self, fs: List[torch.Tensor], weights, bias: torch.Tensor) -> torch.Tensor:
        """fs[l]: [..., Cb, 2l+1]; weights: [..., W] or an (h, w2, b2) triple
        whose slices are projected per block (h @ w2[:, s] + b2[s]), so the
        [..., W] tensor never exists; bias [..., Wb]. Returns [..., R, R]."""
        cb = fs[0].shape[-2]
        lead = fs[0].shape[:-2]
        lazy = isinstance(weights, tuple)
        groups = self.layout.group_slices()
        w_off = b_off = 0
        rows = []
        for lo1, _, mul1 in groups:
            row = []
            for lo2, _, mul2 in groups:
                block = None
                for l_in in range(abs(lo1 - lo2), min(lo1 + lo2, len(fs) - 1) + 1):
                    nw = cb * mul1 * mul2
                    if lazy:
                        h, w2, b2 = weights
                        w = h @ w2[:, w_off:w_off + nw] + b2[w_off:w_off + nw]
                    else:
                        w = weights[..., w_off:w_off + nw]
                    w = w.reshape(*lead, cb, mul1, mul2)
                    w_off += nw
                    term = torch.einsum("...wk,...wuv->...uvk", fs[l_in], w) / cb
                    if l_in == 0:
                        b = bias[..., b_off:b_off + mul1 * mul2].reshape(*lead, mul1, mul2)
                        b_off += mul1 * mul2
                        term = term + b[..., None]
                    contrib = torch.einsum("ijk,...uvk->...uivj", _cg(lo1, lo2, l_in, term), term)
                    contrib = contrib.reshape(*lead, mul1 * (2 * lo1 + 1), mul2 * (2 * lo2 + 1))
                    block = contrib if block is None else block + contrib
                row.append(block)
            rows.append(torch.cat(row, dim=-1))
        return torch.cat(rows, dim=-2)


def expansion_weight_counts(layout: OrbitalLayout, cb: int,
                            l_in_max: int = LMAX) -> Tuple[int, int]:
    w = b = 0
    groups = layout.group_slices()
    for lo1, _, mul1 in groups:
        for lo2, _, mul2 in groups:
            for l_in in range(abs(lo1 - lo2), min(lo1 + lo2, l_in_max) + 1):
                w += cb * mul1 * mul2
                if l_in == 0:
                    b += mul1 * mul2
    return w, b


@register_model("qhnet")
class QHNet(nn.Module):
    """QHNet in float32; defaults follow the reference's config/model/qhnet.yaml.

    Built on `device` (the card unless the caller names another) with
    weights drawn from `generator` with flax's initialisers (truncated
    lecun-normal Dense kernels and embedding, zero biases, unit-normal
    `tp_weights`, γ = 0.5); `models/convert.load_flax_params` carries JAX
    weights across. `assemble_matrix=False` returns the block-space "super
    matrix" instead of the dense [B, O, O] H.
    """

    derivative_forces = False

    def __init__(
        self,
        hidden: int = 128,
        bottle_hidden: int = 32,
        num_layers: int = 5,
        radius_cutoff: float = 12.0,
        rbf_dim: int = 32,
        num_elements: int = 100,
        start_layer: int = 2,
        orbitals: Optional[Dict[int, Sequence[int]]] = None,
        remat: bool = True,
        use_pallas: str = "off",  # off | fused
        ref_compat: bool = False,
        assemble_matrix: bool = True,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if use_pallas not in ("off", "fused"):
            raise ValueError(f"use_pallas must be off|fused, got {use_pallas!r}")
        if ref_compat:
            raise NotImplementedError(
                "ref_compat serves checkpoints converted from the reference; it waits for "
                "pretrained restore (ROADMAP queue 1: checkpoint and pretrained restore)")
        c, cb = hidden, bottle_hidden
        self.hidden, self.num_layers, self.start_layer = hidden, num_layers, start_layer
        self.radius_cutoff, self.remat, self.use_pallas = radius_cutoff, remat, use_pallas
        self.assemble_matrix = assemble_matrix
        self.layout = OrbitalLayout(orbitals or DEF2_SVP_ORBITALS, num_elements)
        self.rbf = ExpBernsteinRBF(rbf_dim, radius_cutoff)
        self.node_embedding = nn.Embedding(num_elements, c)
        for i in range(num_layers):
            setattr(self, f"conv_{i}", ConvNetLayer(c, rbf_dim, i != 0, use_pallas))
            if i > start_layer:
                setattr(self, f"self_{i}", SelfNetLayer(c, generator))
                setattr(self, f"pair_{i}", PairNetLayer(c, rbf_dim, use_pallas))
        self.output_ii = IrrepsLinear(c, cb)
        self.output_ij = IrrepsLinear(c, cb)
        n_w, n_b = expansion_weight_counts(self.layout, cb)
        self.fc_ii = MLP(c, [c, n_w])
        self.fc_ii_bias = MLP(c, [c, n_b])
        self.fc_ij = GateMLPSplit(2 * c, c, n_w)
        self.fc_ij_bias = MLP(2 * c, [c, n_b])
        self.expand_ii = Expansion(self.layout)
        self.expand_ij = Expansion(self.layout)
        for name, arr in (("norb_t", self.layout.norb), ("valid_t", self.layout.valid),
                          ("rank_t", self.layout.rank)):
            self.register_buffer(name, torch.from_numpy(arr), persistent=False)
        self.register_buffer("cgsh_t", torch.from_numpy(qhnet_tp.cgsh_matrix(LMAX)),
                             persistent=False)
        self.reset_parameters(generator)
        self.to(resolve_device(device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            lecun_normal_(self.node_embedding.weight, fan_in=self.hidden, generator=generator)
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
                elif isinstance(m, _DenseParams):
                    lecun_normal_(m.kernel, fan_in=m.kernel.shape[0], generator=generator)
                    m.bias.zero_()

    def _maybe_remat(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def forward(self, batch: MolBatch) -> ModelOutput:
        c = self.hidden
        z = batch.z.long()
        dg = graph.dense_graph(batch.pos, batch.node_mask, self.radius_cutoff)
        full_mask = graph.dense_graph(batch.pos, batch.node_mask, 1e9).adj
        zero = torch.zeros((), dtype=batch.pos.dtype, device=batch.pos.device)
        dist = torch.where(full_mask, dg.dist, zero)
        unit = torch.where(full_mask[..., None],
                           dg.diff / torch.clamp(dg.dist, min=1e-9)[..., None], zero)
        rbf = torch.where(full_mask[..., None], self.rbf(dist), zero)
        # component-normalized edge SH (reference build_graph, qhnet.py:258-268)
        sh_flat = so3.real_sph_harm(unit, LMAX, normalized=False)
        sh = [sh_flat[..., l * l:(l + 1) * (l + 1)] for l in range(LMAX + 1)]

        emb = self.node_embedding(z)
        xs = [emb[..., None]] + [emb.new_zeros((*z.shape, c, 2 * l + 1))
                                 for l in range(1, LMAX + 1)]
        cgsh = None
        if self.use_pallas == "fused":
            # the layer-independent CG ⊗ sh table, radius graph premasked;
            # positions are never differentiated in Hamiltonian training
            sh_adj = torch.where(dg.adj[..., None], sh_flat, zero)
            cgsh = (sh_adj @ self.cgsh_t).detach().contiguous()  # [B,A,A,K]
        fii = fij = None
        for i in range(self.num_layers):
            xs = self._maybe_remat(getattr(self, f"conv_{i}"), xs, sh, rbf, dg.adj, cgsh)
            if i > self.start_layer:
                fii = getattr(self, f"self_{i}")(xs, fii)
                fij = self._maybe_remat(getattr(self, f"pair_{i}"), xs, rbf, full_mask, fij)

        fii = self.output_ii(fii)
        fij = self.output_ij(fij)
        x0 = xs[0][..., 0]  # [B,A,C]
        diag = self.expand_ii(fii, self.fc_ii(x0), self.fc_ii_bias(x0))  # [B,A,R,R]
        b, a = z.shape
        pair_scal = torch.cat([x0[:, :, None].expand(b, a, a, c), x0[:, None].expand(b, a, a, c)],
                              dim=-1)
        off = self._maybe_remat(self._pair_head, fij, pair_scal)  # [B,A,A,R,R]
        if batch.orb_mask is None:
            return {"diag_blocks": diag, "off_blocks": off}

        # on-device assembly: P[b,i,r,o] one-hot projection per atom
        o_max = batch.orb_mask.shape[-1]
        norb = torch.where(batch.node_mask, self.norb_t[z], torch.zeros_like(z))
        offsets = torch.cumsum(norb, dim=1) - norb
        tgt = offsets[..., None] + self.rank_t[z]  # [B,A,R]
        v = self.valid_t[z] & batch.node_mask[..., None]
        idx = torch.where(v, tgt, torch.full_like(tgt, o_max))
        p = F.one_hot(idx, o_max + 1)[..., :o_max].to(diag.dtype)  # [B,A,R,O]

        eye = torch.eye(a, dtype=torch.bool, device=z.device)
        off = torch.where((~eye[None, :, :, None, None]) & full_mask[..., None, None], off, zero)
        if not self.assemble_matrix:
            sym_diag = diag + diag.transpose(-1, -2)
            sym_off = off + off.permute(0, 2, 1, 4, 3)
            blocks = sym_off + torch.where(eye[None, :, :, None, None], sym_diag[:, :, None], zero)
            r = diag.shape[-1]
            return {
                "hamiltonian_blocks": blocks.permute(0, 1, 3, 2, 4).reshape(b, a * r, a * r),
                "block_index": torch.where(v, tgt, torch.zeros_like(tgt)),
                "block_valid": v,
            }
        h = torch.einsum("biro,birs,bisq->boq", p, diag, p)
        m_right = torch.einsum("bijrs,bjsq->birq", off, p)  # [B,A,R,O]
        h = h + torch.einsum("biro,birq->boq", p, m_right)
        return {"hamiltonian": h + h.transpose(-1, -2)}

    def _pair_head(self, fij, pair_scal):
        return self.expand_ij(fij, self.fc_ij(pair_scal), self.fc_ij_bias(pair_scal))
