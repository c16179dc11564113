"""PaiNN: polarizable atom interaction NN (scalar + vector features).

The molecular path of ``nabladft_tpu/models/painn.py``: messages over the
dense pair axis [B, A, A] (nablaDFT molecules are ≤ 62 atoms). The message
block runs in one of two modes:

  * ``use_pallas="off"``   — plain PyTorch, differentiable to any order;
  * ``use_pallas="fused"`` — `painn_message`: CUDA kernel A forward and
    kernel B backward, with the radial-basis chain rule folded into a
    scalar g_dist (first-order paths: inference and forces). Under a
    forward-AD dual level with a dual `pos` (the surrogate training pass)
    the same module runs `painn_dual` instead: kernel C forward and kernel D
    backward, the JAX package's ``use_pallas="train"``. On CPU tensors the
    same ops run their plain versions.

The field keeps its JAX name so ``configs/*.yaml`` read unchanged.
State: scalars s [B,A,F] and vectors v [B,A,3,F]; equivariance is kept by
never applying bias or nonlinearity to the vector channel. Forces are
-∂E/∂pos (see models/base.py `forward`).

``compute_dtype="bfloat16"`` runs as the JAX model's: the parameters stay
float32 and are cast where flax's ``dtype=`` casts them; the pair features
are computed in float32 and cast after the mask (rbf_env, rbfp and rbf_env's
tangent, unit_t, envf); the message and update run in bf16 (the kernels in
their bf16 mode), with two float32 islands: vv_norm's sum and the energy
head, on s widened.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.autograd.forward_ad as fwAD
from torch import nn

from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models.base import (
    MLP, Linear, ModelOutput, compute_dtype_of, dual_lanes, embed, init_linear_, lecun_normal_,
    register_model, shifted_softplus,
)
from nabladft_tpu_torch.ops import graph, radial
from nabladft_tpu_torch.ops.painn_fused import painn_dual, painn_message, painn_message_dense
from nabladft_tpu_torch.ops.segment import masked_sum
from nabladft_tpu_torch.utils import resolve_device


class PaiNNMessage(nn.Module):
    def __init__(self, hidden: int, n_rbf: int, use_pallas: str = "off",
                 cdt: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.use_pallas = use_pallas
        self.cdt = cdt
        self.mlp = MLP(hidden, [hidden, 3 * hidden], compute_dtype=cdt)  # flax MLP_0
        # [R, 3F], the layout the kernels take (not a Linear weight)
        self.filter_kernel = nn.Parameter(torch.empty(n_rbf, 3 * hidden))
        self.filter_bias = nn.Parameter(torch.zeros(3 * hidden))

    def forward(self, s, v, feats):
        """feats: dist, rbf_env [B,A,A,R], rbfp, unit_t [B,A,3,A], envf [B,A,A]
        (premasked cutoff envelope). rbf_env/rbfp premasked. In the fused
        dual pass feats also holds rbf_env_t, rbf_env's tangent."""
        f = self.hidden
        phi = self.mlp(s)  # [B,A,3F]
        w, b = self.filter_kernel.to(self.cdt), self.filter_bias.to(self.cdt)
        v_flat = v.reshape(*v.shape[:2], 3 * f)  # [B,A,3,F] -> c-major flat
        if self.use_pallas == "off":
            ds, dv_flat = painn_message_dense(feats["rbf_env"], phi, v_flat, feats["unit_t"], w)
        elif feats.get("rbf_env_t") is not None:
            ds, dv_flat = _dual_message(feats, phi, v_flat, w)
        else:
            ds, dv_flat = painn_message(
                feats["dist"], feats["rbf_env"], feats["rbfp"],
                phi, v_flat.contiguous(), feats["unit_t"], w,
            )
        # bias terms, bypassing the radial basis: the filter is
        # (rbf@W + b)·env, so the bias rides the envelope: b ⊙ Σ_j env_ij·φ_j.
        # Kept outside the kernels so they see bias-free, premasked messages.
        adjf = feats["envf"]
        phi1 = phi[..., f : 2 * f]
        q = torch.cat(
            [phi[..., :f]] + [phi1 * v_flat[..., c * f : (c + 1) * f] for c in range(3)],
            dim=-1,
        )  # [B,A,4F]: φ0 and φ1⊙v_c
        nb = torch.bmm(adjf, q)
        ds = ds + b[:f] * nb[..., :f]
        dv_flat = dv_flat + torch.cat(
            [b[f : 2 * f] * nb[..., (c + 1) * f : (c + 2) * f] for c in range(3)], dim=-1
        )
        dvu_b = torch.einsum(
            "bicj,bjf->bicf", feats["unit_t"] * adjf[:, :, None, :], phi[..., 2 * f :]
        )
        dv_flat = dv_flat + (b[2 * f :] * dvu_b).reshape(*ds.shape[:2], 3 * f)
        return ds, dv_flat.reshape(*v.shape)


def _dual_message(feats, phi, v_flat, w):
    """Kernel C on the primal and tangent lanes of the message inputs; the
    outputs are packed back into dual tensors, so reverse mode through
    their tangents reaches kernel D once, with both lanes' cotangents."""
    if fwAD.unpack_dual(w).tangent is not None:
        raise ValueError("the dual PaiNN message takes no tangent on the filter weights")
    phi_p, phi_t = dual_lanes(phi)
    v_p, v_t = dual_lanes(v_flat)
    ut_p, ut_t = dual_lanes(feats["unit_t"])
    ds, dv, dsd, dvd = painn_dual(feats["rbf_env"], feats["rbf_env_t"], phi_p, phi_t,
                                  v_p, v_t, ut_p, ut_t, w)
    return fwAD.make_dual(ds, dsd), fwAD.make_dual(dv, dvd)


class PaiNNUpdate(nn.Module):
    def __init__(self, hidden: int, eps: float = 1e-8, cdt: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        # channel mixes of the vector features (no bias: equivariance)
        self.dense_0 = Linear(hidden, hidden, bias=False, compute_dtype=cdt)  # flax Dense_0
        self.dense_1 = Linear(hidden, hidden, bias=False, compute_dtype=cdt)  # flax Dense_1
        self.mlp = MLP(2 * hidden, [hidden, 3 * hidden], compute_dtype=cdt)  # flax MLP_0

    def forward(self, s, v):
        u = self.dense_0(v)  # [B,A,3,F]
        vv = self.dense_1(v)
        # the squared norm summed in float32 (an island of the bf16 mode)
        vv_norm = torch.sqrt((vv * vv).float().sum(dim=-2) + self.eps)
        gates = self.mlp(torch.cat([s, vv_norm.to(s.dtype)], dim=-1))
        a_vv, a_sv, a_ss = gates.chunk(3, dim=-1)
        dv = u * a_vv[:, :, None, :]
        dot = (u * vv).sum(dim=-2)  # [B,A,F]
        ds = a_ss + a_sv * dot
        return ds, dv


class PaiNNLayer(nn.Module):
    """One message+update interaction."""

    def __init__(self, hidden: int, n_rbf: int, use_pallas: str = "off",
                 cdt: torch.dtype = torch.float32):
        super().__init__()
        self.message = PaiNNMessage(hidden, n_rbf, use_pallas, cdt)
        self.update = PaiNNUpdate(hidden, cdt=cdt)

    def forward(self, s, v, feats):
        ds, dv = self.message(s, v, feats)
        s, v = s + ds, v + dv
        ds, dv = self.update(s, v)
        return s + ds, v + dv


@register_model("painn")
class PaiNN(nn.Module):
    """PaiNN on the molecular (non-periodic) path, in float32 or bfloat16.

    Built on `device` (the card unless the caller names another) with
    weights drawn from `generator` with flax's default initialisers
    (truncated lecun-normal Dense kernels, filter and embedding, zero
    biases); `models/convert.load_flax_params` carries JAX weights across.
    """

    derivative_forces = True

    def __init__(
        self,
        hidden: int = 128,
        n_interactions: int = 6,
        n_rbf: int = 100,
        cutoff: float = 5.0,
        max_neighbors: int = 63,
        num_elements: int = 100,
        rbf: str = "gaussian",  # gaussian | bessel
        envelope: str = "polynomial",  # polynomial | cosine
        envelope_exponent: int = 5,
        energy_mean: float = 0.0,
        energy_std: float = 1.0,
        compute_dtype: str = "float32",
        use_pallas: str = "off",  # off | fused
        pbc: bool = False,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cdt = compute_dtype_of(compute_dtype, "PaiNN")
        if pbc:
            raise NotImplementedError("the periodic PaiNN path is not ported yet (ROADMAP)")
        if use_pallas not in ("off", "fused"):
            raise ValueError(f"use_pallas must be off|fused, got {use_pallas!r}")
        if rbf not in ("gaussian", "bessel") or envelope not in ("polynomial", "cosine"):
            raise ValueError(f"unknown basis {rbf!r} / envelope {envelope!r}")
        self.hidden, self.n_rbf, self.cutoff = hidden, n_rbf, cutoff
        self.max_neighbors = max_neighbors
        self.rbf, self.envelope, self.envelope_exponent = rbf, envelope, envelope_exponent
        self.energy_mean, self.energy_std = energy_mean, energy_std
        self.use_pallas = use_pallas
        self.atom_embedding = nn.Embedding(num_elements, hidden)
        self.layers = nn.ModuleList(
            PaiNNLayer(hidden, n_rbf, use_pallas, self.cdt) for _ in range(n_interactions)
        )
        self.energy_head = MLP(hidden, [hidden // 2, 1], activation=shifted_softplus)
        self.reset_parameters(generator)
        self.to(resolve_device(device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            lecun_normal_(self.atom_embedding.weight, fan_in=self.hidden, generator=generator)
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
            for layer in self.layers:
                msg = layer.message
                lecun_normal_(msg.filter_kernel, fan_in=self.n_rbf, generator=generator)
                msg.filter_bias.zero_()

    def _basis(self, d):
        if self.rbf == "gaussian":
            return radial.gaussian_rbf(d, self.n_rbf, self.cutoff)
        return radial.bessel_rbf(d, self.n_rbf, self.cutoff)

    def _envelope(self, d):
        if self.envelope == "polynomial":
            return radial.polynomial_envelope(d / self.cutoff, self.envelope_exponent)
        return radial.cosine_cutoff(d, self.cutoff)

    def _filter(self, d, edge_mask):
        out = self._basis(d) * self._envelope(d)[..., None]
        return torch.where(edge_mask[..., None], out, torch.zeros_like(out))

    def _filter_derivative(self, d, edge_mask):
        """∂(basis·envelope)/∂d in closed form (the product rule over the
        radial ops' jvps), zero off the edges."""
        td = torch.ones_like(d)
        if self.rbf == "gaussian":
            drb = radial.gaussian_rbf_jvp(d, td, self.n_rbf, self.cutoff)
        else:
            drb = radial.bessel_rbf_jvp(d, td, self.n_rbf, self.cutoff)
        if self.envelope == "polynomial":
            denv = radial.polynomial_envelope_jvp(d / self.cutoff, td / self.cutoff,
                                                  self.envelope_exponent)
        else:
            denv = radial.cosine_cutoff_jvp(d, td, self.cutoff)
        out = drb * self._envelope(d)[..., None] + self._basis(d) * denv[..., None]
        return torch.where(edge_mask[..., None], out, torch.zeros_like(out))

    def features(self, batch: MolBatch) -> dict:
        """Pair features of the dense graph (see PaiNNMessage.forward).

        With a dual `pos` (forward AD), every feature carries its tangent
        along pos's; in the fused mode rbf_env's tangent, rbfp ⊙ ṫdist, is
        built from the closed-form radial derivative and kept apart
        (rbf_env_t) for kernel C. Every feature but dist is cast to the
        compute dtype last, after its mask (rbfp, rbf_env_t: the tangents of
        that cast, taken in float32 and cast)."""
        dg = graph.dense_graph(batch.pos, batch.node_mask, self.cutoff)
        adj = graph.dense_topk_mask(dg.dist, dg.adj, self.max_neighbors)
        zero = torch.zeros_like(dg.dist)
        dist = torch.where(adj, dg.dist, zero)
        unit = dg.diff / torch.clamp(dg.dist, min=1e-10)[..., None]
        unit = torch.where(adj[..., None], unit, torch.zeros_like(unit))
        env = self._envelope(dist)
        cdt = self.cdt
        feats = {
            "dist": dist,
            "envf": torch.where(adj, env, zero).to(cdt),
            "unit_t": unit.transpose(2, 3).contiguous().to(cdt),  # [B,A,3,A]
            "rbfp": None,
        }
        if self.use_pallas == "off":
            feats["rbf_env"] = self._filter(dist, adj).to(cdt)
            return feats
        # the kernel backward folds the basis chain rule into g_dist, so
        # the basis tensors themselves carry no autograd graph
        dist_p, dist_t = fwAD.unpack_dual(dist)
        with torch.no_grad():
            feats["rbf_env"] = self._filter(dist_p, adj).to(cdt).contiguous()
            rbfp = self._filter_derivative(dist_p, adj)
        if dist_t is None:
            feats["rbfp"] = rbfp.to(cdt).contiguous()
        else:
            feats["rbf_env_t"] = (rbfp * dist_t[..., None]).to(cdt).contiguous()
        return feats

    def forward(self, batch: MolBatch) -> ModelOutput:
        feats = self.features(batch)
        s = embed(self.atom_embedding, batch.z.long(), self.cdt)
        v = torch.zeros((*s.shape[:2], 3, self.hidden), dtype=s.dtype, device=s.device)
        for layer in self.layers:
            s, v = layer(s, v, feats)
        e_atom = self.energy_head(s.float())[..., 0]  # the head in float32
        e_atom = e_atom * self.energy_std + self.energy_mean
        return {"energy": masked_sum(e_atom, batch.node_mask, dim=1)}
