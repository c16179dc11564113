"""PhiSNet: SE(3)-equivariant prediction of the Hamiltonian, overlap and core matrices.

The port of ``nabladft_tpu/models/phisnet.py`` (the reference's
phisnet/configs/args_nablaDFT_*: order 4, 128 features, 128
exponential-Bernstein basis functions, 5 modules, cutoff 15 Bohr).
Features are per-L tensors ``x[L]: [B, A, C, 2L+1]``; pairs live on the
dense [B, A, A] lattice of the cutoff graph.

  * `num_modules` interaction modules (residual stacks around a message of
    radial-weighted neighbour features and scalar-sourced angular terms)
    accumulate output features;
  * the overlap S comes from an environment-independent branch (the atom's
    own embedding and the pair's angular functions only);
  * H and the core Hamiltonian from diagonal and pair features with
    neighbour terms; each matrix is assembled per shell pair by QHNet's
    wigner-3j `Expansion` and symmetrised;
  * ``predict_energy`` adds an energy head on the pooled scalar channels,
    forces F = -∂E/∂pos.

Pair features are the model's memory: each list is [B, A, A, C, Σ(2L+1)].
The message contracts the unexpanded neighbour features and the pair
inputs stay broadcast views, so only products materialise; the pair
heads project their Expansion weights block by block (the lazy form of
`Expansion`), so the [B, A, A, W] weight tensor never exists. ``remat``
recomputes each interaction module in the backward pass
(`torch.utils.checkpoint`), as the JAX package's `nn.remat`, except with
``predict_energy`` (the forces' autograd pass keeps the activations). Parameters are
named as the flax tree (`models/convert.load_flax_params`). Coordinates are
Bohr (the Hamiltonian DB's convention).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models.base import (
    ModelOutput, init_linear_, lecun_normal_, register_model,
)
from nabladft_tpu_torch.models.qhnet import (
    DEF2_SVP_ORBITALS, Expansion, IrrepsLinear, OrbitalLayout, expansion_weight_counts,
)
from nabladft_tpu_torch.ops import graph, so3
from nabladft_tpu_torch.ops.radial import ExpBernsteinRBF
from nabladft_tpu_torch.utils import resolve_device


def _channel_mix(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A Linear over the channel axis of x [..., C, 2L+1]."""
    return layer(x.transpose(-1, -2)).transpose(-1, -2)


class ResidualStack(nn.Module):
    """Per-L residual blocks: x_L + W_L x_L · sigmoid(gate_L(silu(x_0)))
    (phisnet nn/modules/residual*.py); bias on L = 0 only."""

    def __init__(self, n_blocks: int, channels: int, order: int):
        super().__init__()
        self.n_blocks, self.order = n_blocks, order
        for b in range(n_blocks):
            setattr(self, f"gate_{b}", nn.Linear(channels, (order + 1) * channels))
            for l in range(order + 1):
                setattr(self, f"lin_{b}_{l}", nn.Linear(channels, channels, bias=(l == 0)))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        for b in range(self.n_blocks):
            gates = getattr(self, f"gate_{b}")(F.silu(xs[0][..., 0]))
            parts = torch.chunk(gates, len(xs), dim=-1)
            xs = [x + _channel_mix(getattr(self, f"lin_{b}_{l}"), x)
                  * torch.sigmoid(parts[l])[..., None] for l, x in enumerate(xs)]
        return xs


class PairMixing(nn.Module):
    """fi_L · (rbf W_i,L) + fj_L · (rbf W_j,L) (phisnet nn/modules/pair_mixing.py)."""

    def __init__(self, channels: int, n_basis: int, order: int):
        super().__init__()
        for l in range(order + 1):
            setattr(self, f"rad_i_{l}", nn.Linear(n_basis, channels, bias=False))
            setattr(self, f"rad_j_{l}", nn.Linear(n_basis, channels, bias=False))

    def forward(self, fi, fj, rbf):
        return [a * getattr(self, f"rad_i_{l}")(rbf)[..., None]
                + b * getattr(self, f"rad_j_{l}")(rbf)[..., None]
                for l, (a, b) in enumerate(zip(fi, fj))]


class PhiSNetModule(nn.Module):
    """One interaction module: pre-residuals, the neighbour message
    Σ_j w_L(r_ij) vj_L + Σ_j wa_L(r_ij) vj_0 Y^L(û_ij), post-residuals;
    returns (new state, output features) (phisnet nn/modules/modular_block.py)."""

    def __init__(self, order: int, channels: int, n_basis: int):
        super().__init__()
        self.order = order
        for name in ("pre_x", "pre_vi", "pre_vj", "post_x", "output"):
            setattr(self, name, ResidualStack(1, channels, order))
        for l in range(order + 1):
            setattr(self, f"rad_{l}", nn.Linear(n_basis, channels, bias=False))
            setattr(self, f"rad_ang_{l}", nn.Linear(n_basis, channels, bias=False))

    def forward(self, xs, rbf, sh, adj):
        xs = self.pre_x(xs)
        vi, vj = self.pre_vi(xs), self.pre_vj(xs)
        zero = rbf.new_zeros(())
        s_j = vj[0][:, None, :, :, 0]  # [B,1,A,C]
        msgs = []
        for l in range(self.order + 1):
            w = torch.where(adj[..., None], getattr(self, f"rad_{l}")(rbf), zero)
            term = torch.einsum("bijc,bjcm->bicm", w, vj[l])
            wa = torch.where(adj[..., None], getattr(self, f"rad_ang_{l}")(rbf), zero)
            ang = torch.einsum("bijc,bijm->bicm", wa * s_j, sh[l])
            msgs.append(term + ang)
        xs = self.post_x([x + m for x, m in zip(vi, msgs)])
        return xs, self.output(xs)


@register_model("phisnet")
class PhiSNet(nn.Module):
    """PhiSNet in float32; defaults follow phisnet/configs/args_nablaDFT_*.

    Built on `device` (the card unless the caller names another) with
    weights drawn from `generator` with flax's initialisers (truncated
    lecun-normal Dense kernels and embedding, zero biases, γ = 0.5).
    """

    def __init__(
        self,
        order: int = 4,
        num_features: int = 128,
        num_basis_functions: int = 128,
        num_modules: int = 5,
        cutoff: float = 15.0,
        num_elements: int = 87,
        orbitals: Optional[Dict[int, Sequence[int]]] = None,
        predict_core: bool = True,
        predict_overlap: bool = True,
        predict_energy: bool = False,
        num_energy_features: int = 64,
        remat: bool = True,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        c, nb, L = num_features, num_basis_functions, order
        self.order, self.num_features, self.num_modules = order, c, num_modules
        self.cutoff, self.remat = cutoff, remat
        self.predict_core, self.predict_overlap = predict_core, predict_overlap
        self.predict_energy = predict_energy
        self.layout = OrbitalLayout(orbitals or DEF2_SVP_ORBITALS, num_elements)
        self.rbf = ExpBernsteinRBF(nb, cutoff)
        self.embedding = nn.Embedding(num_elements, c)
        if predict_overlap:
            self.res_over_ii = ResidualStack(2, c, L)
            self.output_over_ii = IrrepsLinear(c, c, L)
            self.mix_s = PairMixing(c, nb, L)
            self.res_over_ij = ResidualStack(2, c, L)
            self.output_over_ij = IrrepsLinear(c, c, L)
        for m in range(num_modules):
            setattr(self, f"module_{m}", PhiSNetModule(L, c, nb))
        self.res_pc = ResidualStack(1, c, L)
        self.res_pn = ResidualStack(1, c, L)
        for l in range(L + 1):
            setattr(self, f"radial_ii_{l}", nn.Linear(nb, c, bias=False))
        self.res_ii = ResidualStack(1, c, L)
        self.mix_ij = PairMixing(c, nb, L)
        self.res_ij = ResidualStack(1, c, L)
        if predict_energy:
            self.energy_ii = nn.Linear(c, num_energy_features)
            self.energy_ij = nn.Linear(c, num_energy_features)
            self.energy_out = nn.Linear(2 * num_energy_features, 1)
        n_w, n_b = expansion_weight_counts(self.layout, c, l_in_max=L)
        for name in self.matrix_names:
            if name != "overlap":
                setattr(self, f"res_{name}_ii", ResidualStack(2, c, L))
                setattr(self, f"output_{name}_ii", IrrepsLinear(c, c, L))
                setattr(self, f"res_{name}_ij", ResidualStack(2, c, L))
                setattr(self, f"output_{name}_ij", IrrepsLinear(c, c, L))
            for side in ("ii", "ij"):
                setattr(self, f"w_{side}_{name}", nn.Linear(c, n_w))
                setattr(self, f"b_{side}_{name}", nn.Linear(c, n_b))
        self.expand = Expansion(self.layout)
        for name, arr in (("norb_t", self.layout.norb), ("valid_t", self.layout.valid),
                          ("rank_t", self.layout.rank)):
            self.register_buffer(name, torch.from_numpy(arr), persistent=False)
        self.reset_parameters(generator)
        self.to(resolve_device(device))

    @property
    def derivative_forces(self) -> bool:
        return self.predict_energy

    @property
    def matrix_names(self) -> Tuple[str, ...]:
        return (("hamiltonian",) + (("core",) if self.predict_core else ())
                + (("overlap",) if self.predict_overlap else ()))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            lecun_normal_(self.embedding.weight, fan_in=self.num_features, generator=generator)
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)

    def _module(self, m: int, xs, rbf, sh, adj):
        mod = getattr(self, f"module_{m}")
        # not under predict_energy: the forces' pass runs the model through
        # functional_call, whose swapped parameters a recomputation would not see
        if self.remat and torch.is_grad_enabled() and not self.predict_energy:
            return checkpoint(mod, xs, rbf, sh, adj, use_reentrant=False)
        return mod(xs, rbf, sh, adj)

    def forward(self, batch: MolBatch) -> ModelOutput:
        c, L = self.num_features, self.order
        z = batch.z.long()
        b, a = z.shape
        dg = graph.dense_graph(batch.pos, batch.node_mask, self.cutoff)
        adj = dg.adj
        zero = batch.pos.new_zeros(())
        dist = torch.where(adj, dg.dist, zero)
        unit = torch.where(adj[..., None],
                           dg.diff / torch.clamp(dg.dist, min=1e-9)[..., None], zero)
        rbf = torch.where(adj[..., None], self.rbf(dist), zero)
        sh_flat = so3.real_sph_harm(unit, L, normalized=False)
        sh = [sh_flat[..., l * l:(l + 1) * (l + 1)] for l in range(L + 1)]

        emb = self.embedding(z)
        xs = [emb[..., None]] + [emb.new_zeros((b, a, c, 2 * l + 1)) for l in range(1, L + 1)]
        pair = (b, a, a, c)
        blocks: Dict[str, Tuple] = {}
        if self.predict_overlap:
            # environment-independent: the atom's embedding and the pair's
            # angular functions only
            fii = self.output_over_ii(self.res_over_ii(xs))
            fi0 = [x[:, :, None].expand(*pair, x.shape[-1]) for x in xs]
            ang = [sh[l][..., None, :].expand(*pair, 2 * l + 1) for l in range(L + 1)]
            fij = self.output_over_ij(self.res_over_ij(self.mix_s(fi0, ang, rbf)))
            blocks["overlap"] = (fii, fij)

        fs = [torch.zeros_like(x) for x in xs]
        for m in range(self.num_modules):
            xs, ys = self._module(m, xs, rbf, sh, adj)
            fs = [f + y for f, y in zip(fs, ys)]
        fpc, fpn = self.res_pc(fs), self.res_pn(fs)
        fii = []
        for l in range(L + 1):
            w = torch.where(adj[..., None], getattr(self, f"radial_ii_{l}")(rbf), zero)
            fii.append(fpc[l] + torch.einsum("bijc,bjcm->bicm", w, fpn[l]))
        fii = self.res_ii(fii)
        fi = [x[:, :, None].expand(*pair, x.shape[-1]) for x in fpc]
        fj = [x[:, None].expand(*pair, x.shape[-1]) for x in fpc]
        fij = self.res_ij(self.mix_ij(fi, fj, rbf))

        extra: ModelOutput = {}
        if self.predict_energy:
            e_ii = F.silu(self.energy_ii(fii[0][..., 0]))  # [B,A,E]
            nmask = batch.node_mask.to(e_ii.dtype)
            e_ii = (e_ii * nmask[..., None]).sum(1) / torch.clamp(nmask.sum(1), min=1.0)[..., None]
            e_ij = F.silu(self.energy_ij(fij[0][..., 0]))  # [B,A,A,E]
            amask = adj.to(e_ij.dtype)
            e_ij = (e_ij * amask[..., None]).sum((1, 2)) / torch.clamp(
                amask.sum((1, 2)), min=1.0)[..., None]
            extra["energy"] = self.energy_out(torch.cat([e_ii, e_ij], dim=-1))[..., 0]

        for name in self.matrix_names:
            if name != "overlap":
                blocks[name] = (
                    getattr(self, f"output_{name}_ii")(getattr(self, f"res_{name}_ii")(fii)),
                    getattr(self, f"output_{name}_ij")(getattr(self, f"res_{name}_ij")(fij)))
        if batch.orb_mask is None:
            return {**blocks, **extra}

        # assembly: P[b,i,r,o], the one-hot projection of each atom's slots
        o_max = batch.orb_mask.shape[-1]
        norb = torch.where(batch.node_mask, self.norb_t[z], torch.zeros_like(z))
        offsets = torch.cumsum(norb, dim=1) - norb
        tgt = offsets[..., None] + self.rank_t[z]
        v = self.valid_t[z] & batch.node_mask[..., None]
        p = F.one_hot(torch.where(v, tgt, torch.full_like(tgt, o_max)), o_max + 1)
        p = p[..., :o_max].to(emb.dtype)  # [B,A,R,O]
        eye = torch.eye(a, dtype=torch.bool, device=z.device)
        off_mask = (~eye[None, :, :, None, None]) & adj[..., None, None]
        result: ModelOutput = {}
        for name in self.matrix_names:
            hii, hij = blocks[name]
            sii, sij = F.silu(hii[0][..., 0]), F.silu(hij[0][..., 0])
            diag = self.expand(hii, getattr(self, f"w_ii_{name}")(sii),
                               getattr(self, f"b_ii_{name}")(sii))
            w_ij = getattr(self, f"w_ij_{name}")
            offd = self.expand(hij, (sij, w_ij.weight.t(), w_ij.bias),
                               getattr(self, f"b_ij_{name}")(sij))
            offd = torch.where(off_mask, offd, zero)
            mat = torch.einsum("biro,birs,bisq->boq", p, diag, p)
            m_right = torch.einsum("bijrs,bjsq->birq", offd, p)  # [B,A,R,O]
            mat = mat + torch.einsum("biro,birq->boq", p, m_right)
            result[name] = 0.5 * (mat + mat.transpose(-1, -2))
        result.update(extra)
        return result
