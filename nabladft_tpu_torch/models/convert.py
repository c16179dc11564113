"""Carry a JAX (flax) parameter tree into the PyTorch module.

The tree is nested dicts of numpy arrays (``jax.device_get`` of the flax
variables, with or without the top-level ``params`` key). PaiNN's paths:

  atom_embedding/embedding                         [Z, F]
  layer_i/message/MLP_0/Dense_{0,1}/{kernel,bias}
  layer_i/message/{filter_kernel [R,3F], filter_bias [3F]}
  layer_i/update/Dense_{0,1}/kernel                (no bias)
  layer_i/update/MLP_0/Dense_{0,1}/{kernel,bias}
  energy_head/Dense_{0,1}/{kernel,bias}

SchNet's (the torch module names its parameters as the tree does):

  atom_embedding/embedding                         [Z, F]
  filter_i_{w1 [R,F], b1 [1,F], w2 [F,F], b2 [1,F]}  (raw, top level)
  in2f_i/kernel                                    (no bias)
  f2out_i_{0,1}/{kernel,bias}
  atomwise/Dense_{0,1}/{kernel,bias}

QHNet's (module names as the tree's; GateMLPSplit's second Dense and the
RBF's gamma are raw arrays):

  node_embedding/embedding                         [Z, C]
  rbf/gamma                                        []
  conv_i/{linear_pre,linear_in,linear_out}/l{l}/{kernel,bias}   (bias on l0)
  conv_i/norm_gate/gate_mlp/Dense_{0,1}/{kernel,bias}
  conv_i/{fc_rbf,fc_s0}/Dense_0/{kernel,bias}, .../Dense_1/{kernel,bias} (raw)
  self_i/{ng1,ng2,ng3}/gate_mlp/..., self_i/{lin1,lin2,lin3}/l{l}/..., self_i/tp_weights
  pair_i/{lin_inner,lin_n,lin_out}/..., pair_i/{ng_pre,ng_post}/..., pair_i/{fc_rbf,fc_s0}/...
  output_{ii,ij}/l{l}/..., fc_ii, fc_ii_bias, fc_ij_bias/Dense_{0,1}/..., fc_ij (split)

eSCN's (the Pallas layout, the JAX package's canonical one; a tree in the
XLA layout, `layer_i/so2_source/...`, is mapped to it by `escn_params`):

  sphere_embedding/embedding                       [Z, C]
  layer_i/edge_block/{fc_dist,fc_edge}/{kernel,bias}, .../{src_embed,dst_embed}/embedding
  layer_i/{wg, bg, w1_0, w2_0, fc1_m{m}, w2r_m{m}, w2i_m{m}}   (raw, stacked source/target)
  layer_i/{fc1,fc2,fc3}_sphere/kernel              (no bias)
  {energy,force}_fc{1,2}/{kernel,bias}, {energy,force}_fc3/kernel

EquiformerV2's (the Pallas layout, m-shared radial; a tree in the XLA
layout, `block_i/ga/so2_conv_1/...`, is mapped to it by `eqv2_params`; the
reference-compatible variant, ``m_share_rad=False``, has the XLA layout's
names and no other):

  sphere_embedding/embedding, {src_embed,dst_embed}/embedding
  {dist_proj,edge_degree_proj}/{kernel,bias}
  block_i/{norm_1,norm_2}/ln0/{scale,bias}, .../gain_{l}   (and norm_final/...)
  block_i/ga/{w_rad, b_rad, w1, fc1_m{m}, w2, fc2_m{m}, ln_scale, ln_bias, alpha_dot}  (raw)
  block_i/ga/proj_l{l}/kernel (+ bias on l0)        (and force_block/...)
  block_i/ffn/Dense_{0,1,2}/kernel, energy_ffn/Dense_{0,1,2}/kernel

PhiSNet's (module names as the tree's; per-L Denses carry a bias on L = 0):

  embedding/embedding, rbf/gamma
  {res_*,module_m/{pre_x,pre_vi,pre_vj,post_x,output}}/gate_{b}/{kernel,bias}
  .../lin_{b}_{l}/kernel                           (bias on l = 0)
  module_m/{rad_l,rad_ang_l}/kernel, radial_ii_l/kernel, {mix_s,mix_ij}/{rad_i_l,rad_j_l}/kernel
  output_{over,hamiltonian,core}_{ii,ij}/l{l}/..., {w,b}_{ii,ij}_{name}/{kernel,bias}
  energy_{ii,ij,out}/{kernel,bias}                 (predict_energy)

DimeNet++'s (Dense_i auto-named inside the residual layers and the head):

  rbf_freq, atom_embedding/embedding, {rbf_embed,edge_embed}/{kernel,bias}
  interaction_b/{lin_ji,lin_kj,skip}/{kernel,bias}, .../{rbf1,rbf2,down,up}/kernel
  interaction_b/{sbf1_kernel,sbf2_kernel}           (raw)
  interaction_b/{before_skip_k,after_skip_k}/Dense_{0,1}/{kernel,bias}
  output_b/{lin_rbf,lin_up,lin_out}/kernel, output_b/lin_k/{kernel,bias}
  Dense_{0..3}/{kernel,bias}

GemNet-OC's (the "scales" collection, the fitted scale factors, beside
"params"; Residuals' Denses auto-named):

  atom_emb/embedding, edge_emb/{kernel,bias}, out_e_i/kernel, energy_out/kernel
  trip_b/{dense_db,down,up}/kernel, trip_b/mlp_cbf      (raw)
  quad_b/{dense_db,mlp_rbf,down,up}/kernel, quad_b/{mlp_cbf,mlp_sbf}   (raw)
  {ae,ea,aa}_b/{mlp_rbf,proj}/kernel, {before,after}_b_k/Dense_{0,1}/kernel
  out_b/{mlp_rbf_out,atom_proj,force_out}/kernel, out_b/{atom_res,force_res}_k/Dense_{0,1}/kernel
  scales: scale_cbf_basis, trip_b/scale_cbf_sum, quad_b/scale_{rbf,cbf_sum,sbf_sum},
          ae_b/scale_rbf, {ea,aa}_b/scale_sum, out_b/scale_out_sum   ([] each)

Graphormer3D's (nn.Embeds named *_encoder, energy_agg_factor and gbf's two):

  gbf/Embed_{0,1}/embedding, gbf/{means,stds}, {tag,atom}_encoder/embedding
  {edge_proj,bias_proj_0,bias_proj_1,energy_proj_0,energy_proj_1}/{kernel,bias}
  layer_i/LayerNorm_{0,1}/{scale,bias}, layer_i/Dense_{0..3}/{kernel,bias}
  final_ln/{scale,bias}, energy_agg_factor/embedding, force_head/Dense_{0..5}/{kernel,bias}

A flax ``Dense.kernel`` is [in, out] and becomes the transposed
``Linear.weight``; the raw filter arrays keep their layout, which the
kernels take as is; an ``SO3_LinearV2``'s stacked [L+1, in, out] `weight`
keeps its name and layout. Every parameter of the module must be matched
and every leaf of the tree used. `flax_params_of` is the inverse map: the
module's own weights as the flax tree (the converters' template).

The layout maps (`escn_params`, `eqv2_params`, `convert_params`) are the port
of ``nabladft_tpu/models/param_convert.py``: the fused kernels take the per-m
SO(2) weights packed into stacked or concatenated arrays, the XLA path keeps
each m as a submodule; the packing is slice and concat, so each map is
exactly invertible.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


# module names whose `weight` is an nn.Embed's `embedding`
_EMBED_SUFFIXES = ("embedding", "embed", "_encoder", "agg_factor")


def _flax_path(name: str) -> Tuple[Tuple[str, ...], bool]:
    """Torch parameter name -> (flax path, transpose?)."""
    parts = name.split(".")
    out = []
    transpose = False
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "layers" and not out:  # the interaction stack
            out.append(f"layer_{parts[i + 1]}")
            i += 1
        elif p == "layers":  # inside an MLP
            out.append(f"Dense_{parts[i + 1]}")
            i += 1
        elif p == "mlp":
            out.append("MLP_0")
        elif p.startswith("dense_") and p[len("dense_"):].isdigit():
            out.append("Dense_" + p[len("dense_"):])
        elif p.startswith("embed_"):
            out.append("Embed_" + p[len("embed_"):])
        elif p.startswith("layernorm_"):
            out.append("LayerNorm_" + p[len("layernorm_"):])
        elif p == "weight" and out and (out[-1].endswith(_EMBED_SUFFIXES)
                                        or out[-1].startswith("Embed_")):
            out.append("embedding")
        elif p == "weight" and out and out[-1].startswith("so3_linear"):
            out.append("weight")  # SO3_LinearV2's stacked [L+1, in, out]
        elif p == "weight":
            out.append("kernel")
            transpose = True
        else:
            out.append(p)
        i += 1
    return tuple(out), transpose


def _leaves(tree: Mapping[str, Any], prefix=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _nest(leaves: Mapping[Tuple[str, ...], Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in leaves.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _copy_tree(tree):
    return {k: _copy_tree(v) for k, v in tree.items()} if isinstance(tree, Mapping) else tree


def flax_params_of(model: nn.Module) -> Dict[str, Any]:
    """The module's weights as the flax variables dict it loads from
    (`load_flax_params`'s inverse): {"params": tree} of float32 numpy
    arrays, plus {"scales": ...} for fitted scale factors (GemNet-OC)."""
    scales = set(model.scale_factors()) if hasattr(model, "scale_factors") else set()
    colls: Dict[str, Dict[Tuple[str, ...], Any]] = {"params": {}}
    for name, p in model.named_parameters():
        path, transpose = _flax_path(name)
        arr = p.detach().to("cpu", torch.float32).numpy()
        # copy(order="C") keeps 0-d leaves 0-d (np.ascontiguousarray does not)
        colls.setdefault("scales" if name in scales else "params", {})[path] = (
            arr.T if transpose else arr).copy(order="C")
    return {k: _nest(v) for k, v in colls.items()}


def flax_tensors(model: nn.Module, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Each parameter name of `model` -> its float32 CPU tensor from the
    flax tree `params` (either layout, see `convert_params`). Raises on a
    parameter with no leaf, a shape that differs, or a leaf left over."""
    params = convert_params(model, params)
    leaves = _leaves(params.get("params", params))
    if "params" in params and "scales" in params:
        leaves.update(_leaves(params["scales"]))
    out, used = {}, set()
    for name, p in model.named_parameters():
        path, transpose = _flax_path(name)
        if path not in leaves:
            raise KeyError(f"no flax leaf {'/'.join(path)} for parameter {name}")
        leaf = leaves[path]
        if isinstance(leaf, torch.Tensor):  # a bfloat16 leaf of the msgpack reader
            leaf = leaf.float().numpy()
        arr = np.array(leaf, np.float32)  # a writable copy
        if transpose:
            arr = arr.T
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: flax {arr.shape} vs torch {tuple(p.shape)}")
        out[name] = torch.from_numpy(arr.copy(order="C"))  # keeps 0-d leaves 0-d
        used.add(path)
    unused = sorted("/".join(k) for k in leaves if k not in used)
    if unused:
        raise KeyError(f"flax leaves with no torch parameter: {unused}")
    return out


def load_flax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Copy a flax parameter tree of any ported family (PaiNN, SchNet,
    QHNet, PhiSNet, eSCN, EquiformerV2, DimeNet++, Graphormer3D, GemNet-OC)
    into `model` in place; returns it. A variables dict's "scales"
    collection (GemNet-OC's fitted scale factors) is read beside its
    "params". eSCN and EquiformerV2 trees may come in either layout."""
    tensors = flax_tensors(model, params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(tensors[name])
    return model


# ---------------------------------------------------------------------------
# layout maps (nabladft_tpu/models/param_convert.py)
# ---------------------------------------------------------------------------


def _split_collections(params: Mapping[str, Any]):
    """Accept {"params": ...} or a bare param dict; return (inner, wrapped)."""
    if "params" in params and isinstance(params["params"], Mapping):
        return dict(params["params"]), True
    return dict(params), False


def _wrap(inner, wrapped: bool, original):
    if wrapped:
        out = dict(original)
        out["params"] = inner
        return out
    return inner


def _escn_layer_pallas_to_xla(lp: Dict[str, Any]) -> Dict[str, Any]:
    lp = dict(lp)
    wg, bg = lp.pop("wg"), lp.pop("bg")
    w1_0, w2_0 = lp.pop("w1_0"), lp.pop("w2_0")
    h = w1_0.shape[-1]
    m_max = 0
    while f"fc1_m{m_max + 1}" in lp:
        m_max += 1
    for bi, bname in ((0, "so2_source"), (1, "so2_target")):
        blk = {
            "fc_dist0": {"kernel": wg[bi][:, :h], "bias": bg[bi][0, :h]},
            "fc1_m0": {"kernel": w1_0[bi]},
            "fc2_m0": {"kernel": w2_0[bi]},
        }
        for m in range(1, m_max + 1):
            fc1 = lp[f"fc1_m{m}"]
            blk[f"so2_m{m}"] = {
                "fc_dist": {"kernel": wg[bi][:, (2 * m - 1) * h:(2 * m + 1) * h],
                            "bias": bg[bi][0, (2 * m - 1) * h:(2 * m + 1) * h]},
                "fc1_r": {"kernel": fc1[bi][:, :h]},
                "fc1_i": {"kernel": fc1[bi][:, h:]},
                "fc2_r": {"kernel": lp[f"w2r_m{m}"][bi]},
                "fc2_i": {"kernel": lp[f"w2i_m{m}"][bi]},
            }
        lp[bname] = blk
    for m in range(1, m_max + 1):
        for k in (f"fc1_m{m}", f"w2r_m{m}", f"w2i_m{m}"):
            lp.pop(k, None)
    return lp


def _escn_layer_xla_to_pallas(lp: Dict[str, Any]) -> Dict[str, Any]:
    lp = dict(lp)
    blocks = [lp.pop("so2_source"), lp.pop("so2_target")]
    m_max = 0
    while f"so2_m{m_max + 1}" in blocks[0]:
        m_max += 1
    cat, ms = np.concatenate, range(1, m_max + 1)
    lp["wg"] = np.stack([cat([blk["fc_dist0"]["kernel"]]
                             + [blk[f"so2_m{m}"]["fc_dist"]["kernel"] for m in ms], axis=1)
                         for blk in blocks])
    lp["bg"] = np.stack([cat([blk["fc_dist0"]["bias"]]
                             + [blk[f"so2_m{m}"]["fc_dist"]["bias"] for m in ms], axis=0)[None, :]
                         for blk in blocks])
    lp["w1_0"] = np.stack([blk["fc1_m0"]["kernel"] for blk in blocks])
    lp["w2_0"] = np.stack([blk["fc2_m0"]["kernel"] for blk in blocks])
    for m in ms:
        lp[f"fc1_m{m}"] = np.stack([cat([blk[f"so2_m{m}"]["fc1_r"]["kernel"],
                                         blk[f"so2_m{m}"]["fc1_i"]["kernel"]], axis=1)
                                    for blk in blocks])
        lp[f"w2r_m{m}"] = np.stack([blk[f"so2_m{m}"]["fc2_r"]["kernel"] for blk in blocks])
        lp[f"w2i_m{m}"] = np.stack([blk[f"so2_m{m}"]["fc2_i"]["kernel"] for blk in blocks])
    return lp


def escn_params(params, to: str):
    """An eSCN tree in layout `to` ("pallas" or "xla"); the tree itself when
    it is in that layout already."""
    inner, wrapped = _split_collections(_copy_tree(params))
    layers = [k for k in inner if k.startswith("layer_")]
    if not layers or ("pallas" if "wg" in inner[layers[0]] else "xla") == to:
        return params
    fn = _escn_layer_pallas_to_xla if to == "xla" else _escn_layer_xla_to_pallas
    for name in layers:
        inner[name] = fn(inner[name])
    return _wrap(inner, wrapped, params)


def _eqv2_ga_pallas_to_xla(ga: Dict[str, Any], l_max: int, co: int) -> Dict[str, Any]:
    out = {"rad_func": {"kernel": ga["w_rad"], "bias": ga["b_rad"][0]},
           "alpha_norm": {"scale": ga["ln_scale"][0], "bias": ga["ln_bias"][0]},
           "alpha_dot": ga["alpha_dot"]}
    c1, c2 = {"fc_m0": {"kernel": ga["w1"]}}, {"fc_m0": {"kernel": ga["w2"]}}
    m = 1
    while f"fc1_m{m}" in ga:
        n_l = l_max + 1 - m
        c1[f"fc_r_m{m}"] = {"kernel": ga[f"fc1_m{m}"][:, :n_l * co]}
        c1[f"fc_i_m{m}"] = {"kernel": ga[f"fc1_m{m}"][:, n_l * co:]}
        c2[f"fc_r_m{m}"] = {"kernel": ga[f"fc2_m{m}"][:, :n_l * co]}
        c2[f"fc_i_m{m}"] = {"kernel": ga[f"fc2_m{m}"][:, n_l * co:]}
        m += 1
    out["so2_conv_1"], out["so2_conv_2"] = c1, c2
    out.update({k: v for k, v in ga.items() if k.startswith("proj_l")})
    return out


def _eqv2_ga_xla_to_pallas(ga: Dict[str, Any]) -> Dict[str, Any]:
    cat, c1, c2 = np.concatenate, ga["so2_conv_1"], ga["so2_conv_2"]
    out = {"w_rad": ga["rad_func"]["kernel"], "b_rad": ga["rad_func"]["bias"][None, :],
           "w1": c1["fc_m0"]["kernel"], "w2": c2["fc_m0"]["kernel"],
           "ln_scale": ga["alpha_norm"]["scale"][None, :],
           "ln_bias": ga["alpha_norm"]["bias"][None, :], "alpha_dot": ga["alpha_dot"]}
    m = 1
    while f"fc_r_m{m}" in c1:
        out[f"fc1_m{m}"] = cat([c1[f"fc_r_m{m}"]["kernel"], c1[f"fc_i_m{m}"]["kernel"]], axis=1)
        out[f"fc2_m{m}"] = cat([c2[f"fc_r_m{m}"]["kernel"], c2[f"fc_i_m{m}"]["kernel"]], axis=1)
        m += 1
    out.update({k: v for k, v in ga.items() if k.startswith("proj_l")})
    return out


def eqv2_params(params, to: str, l_max: int, co: int):
    """An m-shared EquiformerV2 tree in layout `to` (m_max is the tree's
    own); co = num_heads · attn_value_channels splits the concatenated real
    / imaginary columns on the pallas → xla direction."""
    inner, wrapped = _split_collections(_copy_tree(params))
    names = [k for k in inner if k.startswith("block_") or k == "force_block"]
    if not names:
        return params
    first = inner[names[0]]
    ga0 = first.get("ga", first)
    if ("pallas" if "w_rad" in ga0 else "xla") == to:
        return params

    def conv(ga):
        return _eqv2_ga_pallas_to_xla(ga, l_max, co) if to == "xla" else _eqv2_ga_xla_to_pallas(ga)

    for name in names:
        if name == "force_block":
            inner[name] = conv(inner[name])
        else:
            inner[name] = dict(inner[name], ga=conv(inner[name]["ga"]))
    return _wrap(inner, wrapped, params)


def convert_params(model: nn.Module, params):
    """`params` (either layout) in the layout `model` takes: the Pallas
    layout for eSCN and the m-shared EquiformerV2 on every device (the port's
    plain versions share it), the XLA layout's names for the
    reference-compatible EquiformerV2 (``m_share_rad=False``), which has
    only that one. The tree itself for every other family."""
    name = type(model).__name__
    if name == "ESCN":
        return escn_params(params, "pallas")
    if name == "EquiformerV2" and model.m_share_rad:
        return eqv2_params(params, "pallas", model.l_max,
                           model.num_heads * model.attn_value_channels)
    return params
