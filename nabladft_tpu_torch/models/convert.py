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

eSCN's (the Pallas layout, the JAX package's canonical one; the XLA
layout's `layer_i/so2_source/...` raises: convert it with
`param_convert.escn_params(p, "pallas")` first):

  sphere_embedding/embedding                       [Z, C]
  layer_i/edge_block/{fc_dist,fc_edge}/{kernel,bias}, .../{src_embed,dst_embed}/embedding
  layer_i/{wg, bg, w1_0, w2_0, fc1_m{m}, w2r_m{m}, w2i_m{m}}   (raw, stacked source/target)
  layer_i/{fc1,fc2,fc3}_sphere/kernel              (no bias)
  {energy,force}_fc{1,2}/{kernel,bias}, {energy,force}_fc3/kernel

EquiformerV2's (the Pallas layout, m-shared radial; the XLA layout's
`block_i/ga/so2_conv_1/...` raises: convert it with
`param_convert.eqv2_params(p, "pallas", l_max, m_max, co)` first):

  sphere_embedding/embedding, {src_embed,dst_embed}/embedding
  {dist_proj,edge_degree_proj}/{kernel,bias}
  block_i/{norm_1,norm_2}/ln0/{scale,bias}, .../gain_{l}   (and norm_final/...)
  block_i/ga/{w_rad, b_rad, w1, fc1_m{m}, w2, fc2_m{m}, ln_scale, ln_bias, alpha_dot}  (raw)
  block_i/ga/proj_l{l}/kernel (+ bias on l0)        (and force_block/...)
  block_i/ffn/Dense_{0,1,2}/kernel, energy_ffn/Dense_{0,1,2}/kernel

A flax ``Dense.kernel`` is [in, out] and becomes the transposed
``Linear.weight``; the raw filter arrays keep their layout, which the
kernels take as is. Every parameter of the module must be matched and
every leaf of the tree used.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


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
        elif p.startswith("dense_"):
            out.append("Dense_" + p[len("dense_"):])
        elif p == "weight" and out and out[-1].endswith(("embedding", "embed")):
            out.append("embedding")
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


def load_flax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Copy a flax PaiNN, SchNet, QHNet, eSCN or EquiformerV2 parameter tree
    into `model` in place; returns it."""
    tree = params.get("params", params)
    leaves = _leaves(tree)
    if any("so2_source" in k for k in leaves):
        raise ValueError(
            "this eSCN tree is in the XLA layout (layer_i/so2_source/...); the port "
            "takes the Pallas layout: convert it with param_convert.escn_params(p, 'pallas')")
    if any("so2_conv_1" in k for k in leaves):
        raise ValueError(
            "this EquiformerV2 tree is in the XLA layout (block_i/ga/so2_conv_1/...); the port "
            "takes the Pallas layout: convert it with "
            "param_convert.eqv2_params(p, 'pallas', l_max, m_max, co)")
    used = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            path, transpose = _flax_path(name)
            if path not in leaves:
                raise KeyError(f"no flax leaf {'/'.join(path)} for parameter {name}")
            arr = np.array(leaves[path], np.float32)  # a writable copy
            if transpose:
                arr = arr.T
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: flax {arr.shape} vs torch {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr.copy(order="C")))  # keeps 0-d leaves 0-d
            used.add(path)
    unused = sorted("/".join(k) for k in leaves if k not in used)
    if unused:
        raise KeyError(f"flax leaves with no torch parameter: {unused}")
    return model
