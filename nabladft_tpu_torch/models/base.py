"""Model base: the NNP protocol, force computation, and the registry.

The counterpart of ``nabladft_tpu/models/base.py``. Every model is an
``nn.Module`` whose ``forward(batch: MolBatch)`` returns at least
``energy:[B]``. Models declare ``derivative_forces = True`` when forces are
``-∂E/∂pos``; `forward` below then takes them with one autograd pass over
the whole padded batch.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Type, Union

import torch
import torch.nn.functional as F
from torch import nn

from nabladft_tpu_torch.data.batch import MolBatch

ModelOutput = Dict[str, torch.Tensor]

_LOG2 = math.log(2.0)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - log(2): zero at x=0 (SchNet's activation)."""
    return F.softplus(x) - _LOG2


class MLP(nn.Module):
    """Linear stack with configurable activation; last layer linear.
    Layer i corresponds to the flax MLP's ``Dense_i``."""

    def __init__(self, in_features: int, features: Sequence[int],
                 activation: Callable = F.silu, bias: bool = True):
        super().__init__()
        dims = [in_features, *features]
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], bias=bias) for i in range(len(features))
        )
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.activation(x)
        return x


def forward(model: nn.Module, batch: MolBatch) -> ModelOutput:
    """Run a model, deriving forces by autograd when the model requires it.

    The energy gradient of molecule b only touches pos[b], so one gradient
    of the summed real-molecule energies yields all per-molecule forces;
    masks keep padding gradients at exactly zero. Outputs are detached.
    """
    if not getattr(model, "derivative_forces", False):
        with torch.no_grad():
            return model(batch)
    with torch.enable_grad():
        pos = batch.pos.detach().requires_grad_(True)
        out = model(batch.replace(pos=pos))
        e = torch.where(batch.graph_mask, out["energy"], torch.zeros_like(out["energy"]))
        (grad,) = torch.autograd.grad(e.sum(), pos)
    out = {k: t.detach() for k, t in out.items()}
    out["forces"] = -grad * batch.node_mask[..., None]
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

MODEL_REGISTRY: Dict[str, Type[nn.Module]] = {}


def register_model(name: str):
    def deco(cls: Type[nn.Module]) -> Type[nn.Module]:
        MODEL_REGISTRY[name.lower()] = cls
        cls.registry_name = name.lower()
        return cls

    return deco


def create_model(name: str, device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None, **kwargs) -> nn.Module:
    """Build a registered model on `device` (the card unless the caller
    names another), its weights drawn from `generator` (a CPU
    torch.Generator; torch's global generator when None)."""
    key = name.lower()
    if key not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[key](**kwargs, device=device, generator=generator)


def init_linear_(layer: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """flax Dense defaults: lecun-normal (truncated) weight, zero bias."""
    lecun_normal_(layer.weight, fan_in=layer.in_features, generator=generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    # std of a unit normal truncated to [-2, 2]; flax rescales by it
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(std)

