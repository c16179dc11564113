"""Carry a JAX (flax) PaiNN parameter tree into the PyTorch module.

The tree is nested dicts of numpy arrays (``jax.device_get`` of the flax
variables, with or without the top-level ``params`` key). Paths:

  atom_embedding/embedding                         [Z, F]
  layer_i/message/MLP_0/Dense_{0,1}/{kernel,bias}
  layer_i/message/{filter_kernel [R,3F], filter_bias [3F]}
  layer_i/update/Dense_{0,1}/kernel                (no bias)
  layer_i/update/MLP_0/Dense_{0,1}/{kernel,bias}
  energy_head/Dense_{0,1}/{kernel,bias}

A flax ``Dense.kernel`` is [in, out] and becomes the transposed
``Linear.weight``; ``filter_kernel`` keeps its [R, 3F] layout, which the
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
        elif p == "weight" and out == ["atom_embedding"]:
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
    """Copy a flax PaiNN parameter tree into `model` in place; returns it."""
    tree = params.get("params", params)
    leaves = _leaves(tree)
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
            p.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            used.add(path)
    unused = sorted("/".join(k) for k in leaves if k not in used)
    if unused:
        raise KeyError(f"flax leaves with no torch parameter: {unused}")
    return model
