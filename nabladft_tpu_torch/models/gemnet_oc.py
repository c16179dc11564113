"""GemNet-OC: edge messages over triplets and quadruplets, direct forces.

The port of ``nabladft_tpu/models/gemnet_oc.py`` (the reference's
config/model/gemnet-oc.yaml: 4 blocks, 256 / 512 atom / edge channels, all
four auxiliary interactions, coupled direct forces, Gaussian radial ×
polynomial envelope, K = 30 main / 8 quadruplet neighbours). All geometry is
gathers over the fixed-K neighbour list of `graph.neighbor_list`, taken from
the one dense graph that the atom-atom interaction also reads:

* triplets k→j→i: the production path is the Legendre-addition-theorem
  factorisation (per-sender pair products, one closing contraction over the
  dense j axis, a gather of its K rows and the exact k == i back-triplet
  correction through the reverse-edge map); the explicit [B,A,K,K,S·R]
  lattice runs only while the scale factors are fitted, as in the JAX
  package, so the fitted statistics keep the reference's semantics;
* quadruplets: the c–a–b–d star around each edge (j→i), c a neighbour of
  the receiver i, d of the sender j, with the bend angles φ_cab, φ_abd and
  the plane dihedral θ_cabd; the basis contraction runs over d first, then
  c, so no [B,A,K,C,D,Sq,E] product exists;
* coupled forces: per-edge scalars scattered onto the dense [B,A,A] pair
  lattice, symmetrised 0.5(S + Sᵀ) and gathered back.

Scale factors are the JAX package's "scales" collection: 0-d parameters
named ``scale_*`` that take a gradient (the trainer counts it in the clip
norm) but that no optimizer updates (`scale_factors`); `fit_scale_factors`
fits them from data. ``forward(batch, stats)`` with a dict records each
scale's (variance of its output, variance of its reference) there, as the
JAX package's mutable "scale_stats" collection, and runs the explicit
triplet lattice. ``compute_dtype="bfloat16"`` is not ported and raises;
``remat`` is accepted and, as in the JAX package, not read. Parameters are
named as the flax tree (`models/convert.load_flax_params`).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models.base import ModelOutput, lecun_normal_, register_model
from nabladft_tpu_torch.ops import graph, so3
from nabladft_tpu_torch.ops.radial import gaussian_rbf, polynomial_envelope
from nabladft_tpu_torch.ops.spherical import legendre_polynomials
from nabladft_tpu_torch.utils import resolve_device

Stats = Optional[Dict[str, torch.Tensor]]


def _he_normal_(t: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax's he_normal: truncated normal, variance 2 / fan_in."""
    lecun_normal_(t, fan_in=t.shape[0], generator=generator)
    with torch.no_grad():
        t.mul_(math.sqrt(2.0))


def _variance(x: torch.Tensor) -> torch.Tensor:
    """jnp.var(x, axis=0).mean(): the population variance over the batch
    axis, padding included, then the mean over every other axis."""
    return x.float().var(dim=0, correction=0).mean()


class _Scaled(nn.Module):
    """A module holding scale factors, `scope` its flax path prefix."""

    def __init__(self, scope: str, names: Iterable[str]):
        super().__init__()
        self.scope = scope
        for name in names:
            setattr(self, name, nn.Parameter(torch.ones(())))

    def _scale(self, name: str, x: torch.Tensor, stats: Stats,
               ref: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x times the scale factor `name`; with `stats`, records the
        (output, reference) variances under the parameter's name (the
        reference's variance is 1 without a reference tensor)."""
        y = x * getattr(self, name)
        if stats is not None:
            with torch.no_grad():
                var_ref = _variance(ref) if ref is not None else y.new_ones((), dtype=torch.float32)
                stats[self.scope + name] = torch.stack([_variance(y), var_ref])
        return y


class _Embed(nn.Module):
    """flax nn.Embed's parameter under its name."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))


class Residual(nn.Module):
    def __init__(self, units: int):
        super().__init__()
        self.dense_0 = nn.Linear(units, units, bias=False)
        self.dense_1 = nn.Linear(units, units, bias=False)

    def forward(self, x):
        h = F.silu(self.dense_1(F.silu(self.dense_0(x))))
        return (x + h) * (2 ** -0.5)


def _res_stack(parent: nn.Module, prefix: str, n: int, units: int) -> List[str]:
    names = [f"{prefix}_{i}" for i in range(n)]
    for name in names:
        setattr(parent, name, Residual(units))
    return names


def _run_stack(parent: nn.Module, names: List[str], x):
    for name in names:
        x = getattr(parent, name)(x)
    return x


class TripletInteraction(_Scaled):
    """Edge←edge messages over the angles at the shared atom j; the
    factorised production path and the explicit-lattice fitting path (the
    module docstring)."""

    def __init__(self, emb_edge: int, emb_in: int, emb_out: int, emb_cbf: int,
                 num_spherical: int, scope: str):
        super().__init__(scope, ["scale_cbf_sum"])
        self.num_spherical, self.emb_cbf, self.emb_in = num_spherical, emb_cbf, emb_in
        self.dense_db = nn.Linear(emb_edge, emb_in, bias=False)
        self.mlp_cbf = nn.Parameter(torch.empty(num_spherical * emb_cbf, emb_in))
        self.down = nn.Linear(emb_in, emb_out, bias=False)
        self.up = nn.Linear(emb_out, emb_edge, bias=False)

    def forward(self, m, nl, trip, stats: Stats):
        sq, rc = self.num_spherical, self.emb_cbf
        x = F.silu(self.dense_db(m))
        w = self.mlp_cbf
        zero = x.new_zeros(())
        if "cbf" in trip:
            x_kj = graph.gather_neighbor_edges(x, nl.idx)  # [B,A,K,M,Ein]
            cbf_m = torch.where(trip["trip_mask"][..., None], trip["cbf"], zero)
            g = torch.einsum("bikms,se->bikme", cbf_m, w)
            agg = torch.einsum("bikme,bikme->bike", g, x_kj)
            agg = self._scale("scale_cbf_sum", agg, stats, ref=x_kj)
        else:
            x = torch.where(nl.mask[..., None], x, zero)
            w3 = w.reshape(sq, rc, self.emb_in)
            # per-(j,m) radial projection through the basis weight, then the
            # per-sender SH reduction V (block-diagonal in l)
            d_se = torch.einsum("bakr,sre->bakse", trip["rad_e"], w3)
            ex = d_se * x[:, :, :, None, :]  # [B,A,K,S,Ein]
            y_e = trip["y_e"]
            v = torch.cat([torch.einsum("bakm,bake->bame", y_e[..., l * l:(l + 1) * (l + 1)],
                                        ex[..., l, :]) for l in range(sq)], dim=2)
            # close the triplet over the dense j axis, then gather the K rows
            agg_d = torch.einsum("bijq,bjqe->bije", trip["yc_d"], v)
            bsz, a_ax, k_ax, e_ax = x.shape
            agg = torch.gather(agg_d, 2, nl.idx[..., None].expand(bsz, a_ax, k_ax, e_ax))
            # the k == i back triplet: P_s(1) = 1, the reverse edge's x
            cw = torch.einsum("bakr,re->bake", trip["rad_e"], w3.sum(0))
            x_rev = torch.gather(x.reshape(bsz, a_ax * k_ax, e_ax), 1,
                                 trip["rev_flat"].reshape(bsz, a_ax * k_ax, 1).expand(-1, -1, e_ax))
            x_rev = x_rev.reshape(bsz, a_ax, k_ax, e_ax) * trip["rev_valid"][..., None].to(x.dtype)
            agg = (agg - cw * x_rev) * trip["s_basis"]
            agg = torch.where(nl.mask[..., None], agg, zero)
            agg = self._scale("scale_cbf_sum", agg, stats)
        x = F.silu(self.down(agg))
        return F.silu(self.up(x))


class QuadrupletInteraction(_Scaled):
    """Edge←edge messages over the c–a–b–d quadruplets: the (d→j) edges'
    embeddings modulated by circ(cosφ_abd), contracted against
    circ(cosφ_cab) ⊗ circ(cosθ_cabd)."""

    def __init__(self, emb_edge: int, emb_in: int, emb_out: int, num_spherical: int,
                 num_radial: int, scope: str):
        super().__init__(scope, ["scale_rbf", "scale_cbf_sum", "scale_sbf_sum"])
        self.num_spherical = num_spherical
        self.dense_db = nn.Linear(emb_edge, emb_in, bias=False)
        self.mlp_rbf = nn.Linear(num_radial, emb_in, bias=False)
        self.mlp_cbf = nn.Parameter(torch.empty(num_spherical, emb_in))
        self.mlp_sbf = nn.Parameter(torch.empty(num_spherical * num_spherical, emb_in))
        self.down = nn.Linear(emb_in, emb_out, bias=False)
        self.up = nn.Linear(emb_out, emb_edge, bias=False)

    def forward(self, m, nl, rbf, quad, stats: Stats):
        sq = self.num_spherical
        cos_cab, cos_abd, cos_dih, mask_d, quad_mask = quad
        zero = m.new_zeros(())
        x = F.silu(self.dense_db(m))
        x = self._scale("scale_rbf", x * self.mlp_rbf(rbf), stats, ref=x)
        kq = cos_abd.shape[-1]
        x_db = graph.gather_nodes(x[:, :, :kq], nl.idx)  # [B,A,K,D,Ein]: edges d→j
        leg_abd = legendre_polynomials(cos_abd, sq - 1)  # [B,A,K,D,Sq]
        t = x_db * torch.einsum("bikds,se->bikde", leg_abd, self.mlp_cbf)
        t = self._scale("scale_cbf_sum", torch.where(mask_d[..., None], t, zero), stats,
                        ref=x_db)
        leg_cab = legendre_polynomials(cos_cab, sq - 1)  # [B,A,K,C,Sq]
        leg_dih = legendre_polynomials(cos_dih, sq - 1)  # [B,A,K,C,D,Sq]
        leg_dih = torch.where(quad_mask[..., None], leg_dih, zero)
        # Σ_c Σ_d leg_cab[c,s] leg_dih[c,d,t] t[d,e]: over d first, then c
        u = torch.einsum("bikcdt,bikde->bikcte", leg_dih, t)
        r = torch.einsum("bikcs,bikcte->bikste", leg_cab, u)
        r2 = r.reshape(*r.shape[:3], sq * sq, r.shape[-1])
        agg = torch.einsum("bikqe,qe->bike", r2, self.mlp_sbf)
        agg = self._scale("scale_sbf_sum", agg, stats, ref=t)
        x = F.silu(self.down(agg))
        return F.silu(self.up(x))


class AtomEdgeInteraction(_Scaled):
    """Atom→edge: each edge reads its sender's atom embedding with radial weights."""

    def __init__(self, emb_atom: int, emb_edge: int, num_radial: int, scope: str):
        super().__init__(scope, ["scale_rbf"])
        self.mlp_rbf = nn.Linear(num_radial, emb_atom, bias=False)
        self.proj = nn.Linear(emb_atom, emb_edge, bias=False)

    def forward(self, h, nl, rbf, stats: Stats):
        h_j = graph.gather_nodes(h, nl.idx)  # [B,A,K,H]
        msg = self._scale("scale_rbf", h_j * self.mlp_rbf(rbf), stats, ref=h_j)
        return F.silu(self.proj(msg))


class EdgeAtomInteraction(_Scaled):
    """Edge→atom aggregation with radial weights."""

    def __init__(self, emb_atom: int, emb_edge: int, num_radial: int, scope: str):
        super().__init__(scope, ["scale_sum"])
        self.mlp_rbf = nn.Linear(num_radial, emb_edge, bias=False)
        self.proj = nn.Linear(emb_edge, emb_atom, bias=False)

    def forward(self, m, nl, rbf, stats: Stats):
        agg = torch.where(nl.mask[..., None], m * self.mlp_rbf(rbf), m.new_zeros(())).sum(2)
        agg = self._scale("scale_sum", agg, stats, ref=m)
        return F.silu(self.proj(agg))


class AtomInteraction(_Scaled):
    """Atom→atom over the dense in-cutoff graph with radial weights."""

    def __init__(self, emb_atom: int, num_radial: int, scope: str):
        super().__init__(scope, ["scale_sum"])
        self.mlp_rbf = nn.Linear(num_radial, emb_atom, bias=False)
        self.proj = nn.Linear(emb_atom, emb_atom, bias=False)

    def forward(self, h, adj, rbf_dense, stats: Stats):
        w = self.mlp_rbf(rbf_dense)  # [B,A,A,H]
        agg = torch.where(adj[..., None], w * h[:, None, :, :], w.new_zeros(())).sum(2)
        agg = self._scale("scale_sum", agg, stats, ref=h)
        return F.silu(self.proj(agg))


class OutputBlock(_Scaled):
    """Per-block energy and direct-force contributions."""

    def __init__(self, emb_atom: int, emb_edge: int, num_atom_layers: int, num_radial: int,
                 scope: str):
        super().__init__(scope, ["scale_out_sum"])
        self.mlp_rbf_out = nn.Linear(num_radial, emb_edge, bias=False)
        self.atom_proj = nn.Linear(emb_edge, emb_atom, bias=False)
        self.atom_res = _res_stack(self, "atom_res", num_atom_layers, emb_atom)
        self.force_res = _res_stack(self, "force_res", 2, emb_edge)
        self.force_out = nn.Linear(emb_edge, 1, bias=False)

    def forward(self, h, m, nl, rbf, stats: Stats):
        agg = torch.where(nl.mask[..., None], m * self.mlp_rbf_out(rbf), m.new_zeros(())).sum(2)
        agg = self._scale("scale_out_sum", agg, stats, ref=m)
        x = h + F.silu(self.atom_proj(agg))
        x = _run_stack(self, self.atom_res, x)
        f = _run_stack(self, self.force_res, m)
        return x, self.force_out(f)[..., 0]  # [B,A,K]


@register_model("gemnet_oc")
class GemNetOC(_Scaled):
    """GemNet-OC in float32; defaults follow the reference's
    config/model/gemnet-oc.yaml.

    Built on `device` (the card unless the caller names another) with
    weights drawn from `generator` with flax's initialisers (truncated
    lecun-normal Dense kernels and embedding, he-normal basis weights, zero
    biases) and every scale factor 1.
    """

    derivative_forces = False  # a direct force head

    def __init__(
        self,
        num_blocks: int = 4,
        emb_size_atom: int = 256,
        emb_size_edge: int = 512,
        emb_size_trip_in: int = 64,
        emb_size_trip_out: int = 64,
        emb_size_quad_in: int = 32,
        emb_size_quad_out: int = 32,
        emb_size_rbf: int = 16,
        emb_size_cbf: int = 16,
        emb_size_sbf: int = 32,
        num_radial: int = 128,
        num_spherical: int = 7,
        num_spherical_quad: int = 4,
        num_before_skip: int = 2,
        num_after_skip: int = 2,
        num_atom: int = 3,
        num_global_out_layers: int = 2,
        cutoff: float = 12.0,
        cutoff_qint: float = 12.0,
        cutoff_aint: float = 12.0,
        max_neighbors: int = 30,
        max_neighbors_qint: int = 8,
        max_neighbors_aeaint: int = 20,
        num_elements: int = 100,
        envelope_exponent: int = 5,
        quad_interaction: bool = True,
        atom_edge_interaction: bool = True,
        edge_atom_interaction: bool = True,
        atom_interaction: bool = True,
        forces_coupled: bool = True,
        remat: bool = True,
        compute_dtype: str = "float32",
        energy_mean: float = 0.0,
        energy_std: float = 1.0,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__("", ["scale_cbf_basis"])
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r} is not ported (ROADMAP queue 1: bf16 compute)")
        # emb_size_rbf / emb_size_sbf, cutoff_qint and max_neighbors_aeaint
        # are the reference's; the JAX package reads none of them (one
        # neighbour list serves every interaction graph)
        self.num_blocks, self.num_radial = num_blocks, num_radial
        self.num_spherical, self.emb_size_cbf = num_spherical, emb_size_cbf
        self.cutoff, self.cutoff_aint = cutoff, cutoff_aint
        self.max_neighbors, self.max_neighbors_qint = max_neighbors, max_neighbors_qint
        self.envelope_exponent = envelope_exponent
        self.quad_interaction, self.atom_edge_interaction = quad_interaction, atom_edge_interaction
        self.edge_atom_interaction, self.atom_interaction = edge_atom_interaction, atom_interaction
        self.forces_coupled = forces_coupled
        self.energy_mean, self.energy_std = energy_mean, energy_std
        self.num_global_out_layers = num_global_out_layers
        self.atom_emb = _Embed(num_elements, emb_size_atom)
        self.edge_emb = nn.Linear(2 * emb_size_atom + num_radial, emb_size_edge)
        self.out_0 = OutputBlock(emb_size_atom, emb_size_edge, num_atom, num_radial, "out_0.")
        self.before, self.after = [], []
        for b in range(num_blocks):
            setattr(self, f"trip_{b}", TripletInteraction(
                emb_size_edge, emb_size_trip_in, emb_size_trip_out, emb_size_cbf, num_spherical,
                f"trip_{b}."))
            if quad_interaction:
                setattr(self, f"quad_{b}", QuadrupletInteraction(
                    emb_size_edge, emb_size_quad_in, emb_size_quad_out, num_spherical_quad,
                    num_radial, f"quad_{b}."))
            if atom_edge_interaction:
                setattr(self, f"ae_{b}", AtomEdgeInteraction(
                    emb_size_atom, emb_size_edge, num_radial, f"ae_{b}."))
            self.before.append(_res_stack(self, f"before_{b}", num_before_skip, emb_size_edge))
            self.after.append(_res_stack(self, f"after_{b}", num_after_skip, emb_size_edge))
            if edge_atom_interaction:
                setattr(self, f"ea_{b}", EdgeAtomInteraction(
                    emb_size_atom, emb_size_edge, num_radial, f"ea_{b}."))
            if atom_interaction:
                setattr(self, f"aa_{b}", AtomInteraction(emb_size_atom, num_radial, f"aa_{b}."))
            setattr(self, f"out_{b + 1}", OutputBlock(
                emb_size_atom, emb_size_edge, num_atom, num_radial, f"out_{b + 1}."))
        for i in range(num_global_out_layers):
            setattr(self, f"out_e_{i}", nn.Linear(emb_size_atom, emb_size_atom, bias=False))
        self.energy_out = nn.Linear(emb_size_atom, 1, bias=False)
        # P_s(û_a·û_b) = 4π/(2s+1) Σ_μ Y_sμ(û_a) Y_sμ(û_b); the i-side unit
        # is û_ji = -û_ij, so the dense factor carries the (-1)^s parity too
        c_full = np.concatenate([np.full(2 * l + 1, (-1.0) ** l * 4.0 * np.pi / (2 * l + 1))
                                 for l in range(num_spherical)]).astype(np.float32)
        self.register_buffer("c_full", torch.from_numpy(c_full), persistent=False)
        self.reset_parameters(generator)
        self.to(resolve_device(device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf.startswith("scale_"):
                    p.fill_(1.0)
                elif leaf in ("mlp_cbf", "mlp_sbf"):
                    _he_normal_(p, generator)
                elif leaf == "embedding":
                    lecun_normal_(p, fan_in=p.shape[1], generator=generator)
                elif leaf == "weight":
                    lecun_normal_(p, fan_in=p.shape[1], generator=generator)
                else:  # biases
                    p.zero_()

    def scale_factors(self) -> Dict[str, nn.Parameter]:
        """The fitted scale factors by parameter name: they take a gradient
        but no optimizer step (the JAX package's "scales" collection)."""
        return {n: p for n, p in self.named_parameters()
                if n.rsplit(".", 1)[-1].startswith("scale_")}

    def _rbf(self, d: torch.Tensor) -> torch.Tensor:
        env = polynomial_envelope(d / self.cutoff, self.envelope_exponent)
        return gaussian_rbf(d, self.num_radial, self.cutoff) * env[..., None]

    def _triplet_features(self, nl, dg, stats: Stats) -> dict:
        """The block-independent triplet tensors: the explicit lattice while
        fitting (`stats` given), else the factorised pair features."""
        sq, rc = self.num_spherical, self.emb_size_cbf
        zero = nl.dist.new_zeros(())
        if stats is not None:
            cos_t, trip_mask = graph.triplet_angles(nl)
            leg_t = legendre_polynomials(cos_t, sq - 1)
            d_kj = graph.gather_nodes(nl.dist, nl.idx)
            rad_t = torch.where(trip_mask[..., None], self._rbf(d_kj)[..., :rc], zero)
            cbf = torch.einsum("bikms,bikmr->bikmsr", leg_t, rad_t)
            cbf = self._scale("scale_cbf_basis", cbf.reshape(*cbf.shape[:-2], -1), stats)
            return {"cbf": cbf, "trip_mask": trip_mask}
        a_dim, k_ax = nl.idx.shape[1], nl.idx.shape[2]
        mask3 = nl.mask[..., None]
        y_e = torch.where(mask3, so3.real_sph_harm(nl.unit, sq - 1, normalized=True), zero)
        rad_e = torch.where(mask3, self._rbf(nl.dist)[..., :rc], zero)
        adj3 = dg.adj[..., None]
        unit_d = torch.where(adj3, dg.diff / torch.clamp(dg.dist, min=1e-9)[..., None], zero)
        y_d = so3.real_sph_harm(unit_d, sq - 1, normalized=True)
        yc_d = torch.where(adj3, y_d, zero) * self.c_full
        # reverse-edge map: the first slot of i in the list of j = idx[b,i,n]
        idx_g = graph.gather_nodes(nl.idx, nl.idx)  # [B,A,K,K]
        mask_g = graph.gather_nodes(nl.mask, nl.idx)
        arange = torch.arange(a_dim, device=nl.idx.device)
        eq = (idx_g == arange[None, :, None, None]) & mask_g & mask3
        return {"y_e": y_e, "rad_e": rad_e, "yc_d": yc_d, "rev_valid": eq.any(-1),
                "rev_flat": nl.idx * k_ax + torch.argmax(eq.to(torch.int8), dim=-1),
                "s_basis": self.scale_cbf_basis}

    def _quadruplet_features(self, nl) -> tuple:
        """The c–a–b–d star around each edge (j→i): c ∈ N(i), d ∈ N(j), the
        first max_neighbors_qint of each list."""
        kq = self.max_neighbors_qint
        a_dim = nl.idx.shape[1]
        u_ij = nl.unit  # i→j
        u_ic = nl.unit[:, :, :kq]  # [B,A,C,3]
        idx_c, mask_c = nl.idx[:, :, :kq], nl.mask[:, :, :kq]
        u_jd = graph.gather_nodes(nl.unit[:, :, :kq], nl.idx)  # [B,A,K,D,3]: j→d
        idx_d = graph.gather_nodes(nl.idx[:, :, :kq], nl.idx)
        mask_d = graph.gather_nodes(mask_c, nl.idx) & nl.mask[..., None]
        # cosφ_cab at a = i; cosφ_abd at b = j
        cos_cab = torch.einsum("bicx,bikx->bikc", u_ic, u_ij).clamp(-1.0, 1.0)
        cos_abd = torch.einsum("bikx,bikdx->bikd", u_ij, u_jd).clamp(-1.0, 1.0)
        # the dihedral between planes (c,a,b) and (a,b,d)
        n1 = torch.linalg.cross(u_ic[:, :, None].expand(*nl.idx.shape, u_ic.shape[2], 3),
                                u_ij[:, :, :, None, :], dim=-1)  # [B,A,K,C,3]
        n2 = torch.linalg.cross(u_jd, u_ij[:, :, :, None, :].expand_as(u_jd), dim=-1)
        n1 = n1 / torch.clamp(torch.linalg.vector_norm(n1, dim=-1, keepdim=True), min=1e-9)
        n2 = n2 / torch.clamp(torch.linalg.vector_norm(n2, dim=-1, keepdim=True), min=1e-9)
        cos_dih = torch.einsum("bikcx,bikdx->bikcd", n1, n2).clamp(-1.0, 1.0)
        # exclusions: c != j (a degenerate plane), d != i (the back edge)
        i_ids = torch.arange(a_dim, device=nl.idx.device)[None, :, None, None]
        quad_mask = (nl.mask[:, :, :, None, None]
                     & mask_c[:, :, None, :, None]
                     & (idx_c[:, :, None, :, None] != nl.idx[..., None, None])
                     & mask_d[:, :, :, None, :]
                     & (idx_d[:, :, :, None, :] != i_ids[..., None]))
        return cos_cab, cos_abd, cos_dih, mask_d, quad_mask

    def forward(self, batch: MolBatch, stats: Stats = None) -> ModelOutput:
        """Energy [B] and forces [B,A,3]. With `stats` (a dict), the scale
        factors' variance statistics are recorded into it and the triplets
        run the explicit lattice (the fitting path)."""
        a_dim = batch.z.shape[1]
        dg = graph.dense_graph(batch.pos, batch.node_mask, self.cutoff_aint)
        nl = graph.neighbor_list(batch.pos, batch.node_mask, self.cutoff, self.max_neighbors,
                                 dense=dg if self.cutoff == self.cutoff_aint else None)
        zero = batch.pos.new_zeros(())
        rbf = torch.where(nl.mask[..., None], self._rbf(nl.dist), zero)
        rbf_dense = torch.where(dg.adj[..., None],
                                self._rbf(torch.where(dg.adj, dg.dist, zero)), zero)
        trip = self._triplet_features(nl, dg, stats)
        quad = self._quadruplet_features(nl) if self.quad_interaction else None

        h = self.atom_emb.embedding[batch.z.long()]
        h_j = graph.gather_nodes(h, nl.idx)
        m = F.silu(self.edge_emb(torch.cat([h[:, :, None].expand_as(h_j), h_j, rbf], dim=-1)))
        e_out, f_out = self.out_0(h, m, nl, rbf, stats)
        for b in range(self.num_blocks):
            contributions = [getattr(self, f"trip_{b}")(m, nl, trip, stats)]
            if self.quad_interaction:
                contributions.append(getattr(self, f"quad_{b}")(m, nl, rbf, quad, stats))
            if self.atom_edge_interaction:
                contributions.append(getattr(self, f"ae_{b}")(h, nl, rbf, stats))
            m = (m + sum(contributions)) * (len(contributions) + 1) ** -0.5
            m = _run_stack(self, self.before[b], m)
            m = _run_stack(self, self.after[b], m)
            atom_contrib = []
            if self.edge_atom_interaction:
                atom_contrib.append(getattr(self, f"ea_{b}")(m, nl, rbf, stats))
            if self.atom_interaction:
                atom_contrib.append(getattr(self, f"aa_{b}")(h, dg.adj, rbf_dense, stats))
            if atom_contrib:
                h = (h + sum(atom_contrib)) * (len(atom_contrib) + 1) ** -0.5
            x_b, f_b = getattr(self, f"out_{b + 1}")(h, m, nl, rbf, stats)
            e_out, f_out = e_out + x_b, f_out + f_b

        # the energy head: a global MLP over the summed atom contributions
        e = e_out
        for i in range(self.num_global_out_layers):
            e = F.silu(getattr(self, f"out_e_{i}")(e))
        e_atom = self.energy_out(e)[..., 0] * self.energy_std + self.energy_mean
        energy = torch.where(batch.node_mask, e_atom, zero).sum(1)

        # direct forces, the per-edge scalars symmetrised over (i, j)
        f_scalar = torch.where(nl.mask, f_out, zero)  # [B,A,K]
        if self.forces_coupled:
            s_dense = f_scalar.new_zeros((*f_scalar.shape[:2], a_dim)).scatter_add(
                2, nl.idx, f_scalar)
            s_dense = 0.5 * (s_dense + s_dense.transpose(-1, -2))
            f_scalar = torch.where(nl.mask, torch.gather(s_dense, 2, nl.idx), zero)
        forces = (f_scalar[..., None] * nl.unit).sum(2) * batch.node_mask[..., None]
        return {"energy": energy, "forces": forces}


@torch.no_grad()
def fit_scale_factors(model: nn.Module, batches, rounds: int = 2) -> nn.Module:
    """Fit every scale factor from data, as the JAX package's
    `fit_scale_factors`: per round, sum each scale's (output, reference)
    variances over `batches` (the fitting path's forwards), then update all
    scales at once, s <- s · sqrt(max(ref / max(out, 1e-12), 1e-12)); a
    scale with no statistics keeps ratio 1. In place; returns `model`."""
    scales = model.scale_factors()
    if not scales:
        return model
    device = next(iter(scales.values())).device
    for _ in range(rounds):
        acc: Dict[str, List[float]] = {}
        for batch in batches:
            stats: Dict[str, torch.Tensor] = {}
            model(batch.to(device), stats=stats)
            host = torch.stack(list(stats.values())).cpu().tolist()
            for name, (out, ref) in zip(stats, host):
                got = acc.setdefault(name, [0.0, 0.0])
                got[0] += out
                got[1] += ref
        for name, s in scales.items():
            out, ref = acc.get(name, (1.0, 1.0))
            s.mul_(float(np.sqrt(max(ref / max(out, 1e-12), 1e-12))))
    return model
