"""SchNet: continuous-filter convolutions over padded molecular graphs.

The port of ``nabladft_tpu/models/schnet.py`` (the reference's
config/model/schnet.yaml: 6 interactions, 128 atom basis, GaussianRBF(100),
CosineCutoff(5.0), an Atomwise energy head, forces -∂E/∂pos). Pairs live on
the dense [B, A, A] lattice; the top-k neighbour cap is a mask, and the
cutoff envelope `envf` carries it (rbf itself is not masked). The per-pair
pipeline (filter MLP → envelope → convolve → reduce) runs in one of two
modes:

  * ``use_pallas="off"``   — plain PyTorch (`schnet_message_reference`),
    differentiable to any order;
  * ``use_pallas="fused"`` — `schnet_message`: CUDA kernel E forward and
    kernel F backward, with the basis and envelope chains folded into a
    scalar g_dist (first-order paths: inference and forces). Under a
    forward-AD dual level with a dual `pos` (the surrogate training pass)
    the same module runs `schnet_dual` instead: kernel G forward and kernel
    H backward, the JAX package's ``use_pallas="train"``. On CPU tensors
    the same ops run their plain versions.

Both modes read one parameter layout, the flax tree's: raw filter arrays
``filter_{i}_{w1,b1,w2,b2}``, ``in2f_{i}`` (no bias), ``f2out_{i}_{0,1}``
and the ``atomwise`` MLP.

``compute_dtype="bfloat16"`` runs as the JAX model's, op for op: the pair
features (rbf, envf and, in the fused mode, their tangents rbfp, envp or
rbfd, envfd) cast to bf16 last; the embedding's rows rounded to bf16;
``in2f`` and ``f2out`` bf16 Dense layers, the message in the kernels' bf16
mode (the raw filter arrays stay float32), shifted softplus in bf16
(`base.shifted_softplus`); the stream cast to float32 before the
``atomwise`` MLP, which runs in float32. The parameters are float32 in both
dtypes, so one flax tree drives both.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.autograd.forward_ad as fwAD
from torch import nn

from nabladft_tpu_torch.data.atomref import atomrefs_for
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models.base import (
    MLP, Linear, ModelOutput, compute_dtype_of, dual_lanes, embed, init_linear_, lecun_normal_,
    register_model, shifted_softplus,
)
from nabladft_tpu_torch.ops import graph, radial
from nabladft_tpu_torch.ops.schnet_fused import (
    schnet_dual, schnet_message, schnet_message_reference,
)
from nabladft_tpu_torch.ops.segment import masked_sum
from nabladft_tpu_torch.utils import resolve_device


@register_model("schnet")
class SchNet(nn.Module):
    """SchNet on the molecular path, in float32 or bfloat16.

    Built on `device` (the card unless the caller names another) with
    weights drawn from `generator` with flax's initialisers (truncated
    lecun-normal filter arrays and Dense kernels, zero biases, the embedding
    as PaiNN's); `models/convert.load_flax_params` carries JAX weights
    across. `remat` is accepted so the configs read unchanged: PyTorch keeps
    the activations either way.
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
        energy_mean: float = 0.0,
        energy_std: float = 1.0,
        use_atomrefs: bool = False,
        remat: bool = True,
        compute_dtype: str = "float32",
        use_pallas: str = "off",  # off | fused
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        del remat
        self.cdt = compute_dtype_of(compute_dtype, "SchNet")
        if use_pallas not in ("off", "fused"):
            raise ValueError(f"use_pallas must be off|fused, got {use_pallas!r}")
        f, r = hidden, n_rbf
        self.hidden, self.n_rbf, self.cutoff = hidden, n_rbf, cutoff
        self.n_interactions, self.max_neighbors = n_interactions, max_neighbors
        self.energy_mean, self.energy_std = energy_mean, energy_std
        self.use_pallas = use_pallas
        self.atom_embedding = nn.Embedding(num_elements, f)
        for i in range(n_interactions):
            # raw arrays in the kernels' layout, named as the flax params
            self.register_parameter(f"filter_{i}_w1", nn.Parameter(torch.empty(r, f)))
            self.register_parameter(f"filter_{i}_b1", nn.Parameter(torch.zeros(1, f)))
            self.register_parameter(f"filter_{i}_w2", nn.Parameter(torch.empty(f, f)))
            self.register_parameter(f"filter_{i}_b2", nn.Parameter(torch.zeros(1, f)))
            setattr(self, f"in2f_{i}", Linear(f, f, bias=False, compute_dtype=self.cdt))
            setattr(self, f"f2out_{i}_0", Linear(f, f, compute_dtype=self.cdt))
            setattr(self, f"f2out_{i}_1", Linear(f, f, compute_dtype=self.cdt))
        self.atomwise = MLP(f, [f // 2, 1], activation=shifted_softplus)
        refs = torch.tensor(atomrefs_for(num_elements), dtype=torch.float32)
        self.register_buffer("atomrefs", refs if use_atomrefs else None, persistent=False)
        self.reset_parameters(generator)
        self.to(resolve_device(device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            lecun_normal_(self.atom_embedding.weight, fan_in=self.hidden, generator=generator)
            for i in range(self.n_interactions):
                lecun_normal_(self.filter(i)[0], fan_in=self.n_rbf, generator=generator)
                lecun_normal_(self.filter(i)[2], fan_in=self.hidden, generator=generator)
                self.filter(i)[1].zero_()
                self.filter(i)[3].zero_()
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)

    def filter(self, i: int):
        """(w1 [R,F], b1 [1,F], w2 [F,F], b2 [1,F]) of interaction i."""
        return tuple(getattr(self, f"filter_{i}_{k}") for k in ("w1", "b1", "w2", "b2"))

    def features(self, batch: MolBatch) -> dict:
        """Pair features of the dense graph: dist, rbf [B,A,A,R] and the
        cutoff envelope envf [B,A,A] (zero off the edges). In the fused mode
        also rbfp and envp, their derivatives in dist from the closed-form
        radial jvps, all with no graph; with a dual `pos` (forward AD) the
        tangents rbfd = rbfp ⊙ ṫdist and envfd = envp ⊙ ṫdist instead. Every
        feature but dist is cast to the compute dtype last (the tangents:
        taken in float32 and cast, as the JAX jvp of the cast)."""
        cdt = self.cdt
        dg = graph.dense_graph(batch.pos, batch.node_mask, self.cutoff)
        adj = graph.dense_topk_mask(dg.dist, dg.adj, self.max_neighbors)
        dist = torch.where(adj, dg.dist, torch.zeros_like(dg.dist))
        if self.use_pallas == "off":
            env = radial.cosine_cutoff(dist, self.cutoff)
            return {"rbf": radial.gaussian_rbf(dist, self.n_rbf, self.cutoff).to(cdt),
                    "envf": torch.where(adj, env, torch.zeros_like(env)).to(cdt)}
        # the kernel backward folds the basis and envelope chains into
        # g_dist, so these tensors carry no autograd graph
        dist_p, dist_t = fwAD.unpack_dual(dist)
        with torch.no_grad():
            zero = torch.zeros_like(dist_p)
            ones = torch.ones_like(dist_p)
            rbf = radial.gaussian_rbf(dist_p, self.n_rbf, self.cutoff)
            rbfp = radial.gaussian_rbf_jvp(dist_p, ones, self.n_rbf, self.cutoff)
            envf = torch.where(adj, radial.cosine_cutoff(dist_p, self.cutoff), zero)
            envp = torch.where(adj, radial.cosine_cutoff_jvp(dist_p, ones, self.cutoff), zero)
        feats = {"dist": dist, "rbf": rbf.to(cdt).contiguous(),
                 "envf": envf.to(cdt).contiguous()}
        if dist_t is None:
            feats.update(rbfp=rbfp.to(cdt).contiguous(), envp=envp.to(cdt).contiguous())
        else:
            feats.update(rbfd=(rbfp * dist_t[..., None]).to(cdt).contiguous(),
                         envfd=(envp * dist_t).to(cdt).contiguous())
        return feats

    def message(self, i: int, xin: torch.Tensor, feats: dict) -> torch.Tensor:
        w1, b1, w2, b2 = self.filter(i)
        if self.use_pallas == "off":
            return schnet_message_reference(feats["rbf"], feats["envf"], xin, w1, b1, w2, b2)
        if "rbfd" in feats:
            return _dual_message(feats, xin, (w1, b1, w2, b2))
        return schnet_message(feats["dist"], feats["rbf"], feats["rbfp"], feats["envf"],
                              feats["envp"], xin.contiguous(), w1, b1, w2, b2)

    def forward(self, batch: MolBatch) -> ModelOutput:
        feats = self.features(batch)
        x = embed(self.atom_embedding, batch.z.long(), self.cdt)
        for i in range(self.n_interactions):
            xin = getattr(self, f"in2f_{i}")(x)
            msg = self.message(i, xin, feats).to(self.cdt)
            h = shifted_softplus(getattr(self, f"f2out_{i}_0")(msg))
            x = x + getattr(self, f"f2out_{i}_1")(h)
        e_atom = self.atomwise(x.float())[..., 0] * self.energy_std + self.energy_mean
        if self.atomrefs is not None:
            e_atom = e_atom + self.atomrefs[batch.z.long()]
        return {"energy": masked_sum(e_atom, batch.node_mask, dim=1)}


def _dual_message(feats: dict, xin: torch.Tensor, weights) -> torch.Tensor:
    """Kernel G on the primal and tangent lanes of the message inputs; the
    result is packed back into a dual tensor, so reverse mode through its
    tangent reaches kernel H once, with both lanes' cotangents."""
    if any(fwAD.unpack_dual(w).tangent is not None for w in weights):
        raise ValueError("the dual SchNet message takes no tangent on the filter weights")
    xin_p, xin_t = dual_lanes(xin)
    msg, msgd = schnet_dual(feats["rbf"], feats["rbfd"], feats["envf"], feats["envfd"],
                            xin_p, xin_t, *weights)
    return fwAD.make_dual(msg, msgd)
