"""Model base: the NNP protocol, force computation, and the registry.

The counterpart of ``nabladft_tpu/models/base.py``. Every model is an
``nn.Module`` whose ``forward(batch: MolBatch)`` returns at least
``energy:[B]``. Models declare ``derivative_forces = True`` when forces are
``-∂E/∂pos``; `forward` below then takes them with one autograd pass over
the whole padded batch, with the parameters held fixed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Type, Union

import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from nabladft_tpu_torch.data.batch import MolBatch

ModelOutput = Dict[str, torch.Tensor]

_LOG2 = math.log(2.0)


class _Logistic(torch.autograd.Function):
    """The logistic σ(x) in a low-precision dtype as XLA evaluates
    jax.nn.sigmoid there: 1 / (1 + exp(-x)) one op at a time, each rounding;
    its derivative JAX's rule, t · (σ · (1 - σ)), each op rounding, in
    reverse and forward mode. It reads the output σ, so both derivatives are
    differentiable again (the forces' double backward, the surrogate's
    reverse pass over its tangents)."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        ctx.save_for_forward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))

    @staticmethod
    def jvp(ctx, t):
        (s,) = ctx.saved_tensors
        return t * (s * (1 - s))


def weak_const(c: float, x: torch.Tensor) -> float:
    """The Python constant c as JAX applies a weakly typed constant to x:
    rounded to x's dtype where that is narrower than float32."""
    return c if x.dtype.itemsize >= 4 else float(torch.tensor(c).to(x.dtype))


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu, x · σ(x). In float32 F.silu; in bf16 the product of x and
    `_Logistic` (XLA's evaluation there, each op rounding to bf16)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * _Logistic.apply(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=False), the exact erf form. In float32
    F.gelu; in bf16 0.5 · x · erfc(-x · √½) one op at a time, each rounding
    to bf16 (√½ itself a bf16 constant), as JAX writes it."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    return 0.5 * x * torch.erfc(-x * weak_const(math.sqrt(0.5), x))


class _Softplus(torch.autograd.Function):
    """jax.nn.softplus in a low-precision dtype as XLA evaluates it there:
    logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)) one op at a time, each
    rounding; its derivative JAX's logaddexp rule, t · exp(x - softplus(x)),
    each op rounding, in reverse and forward mode. Both derivatives read x
    and the output, so they are differentiable again."""

    @staticmethod
    def forward(ctx, x):
        y = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, y)
        ctx.save_for_forward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.exp(x - y)

    @staticmethod
    def jvp(ctx, t):
        x, y = ctx.saved_tensors
        return t * torch.exp(x - y)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - log(2): zero at x=0 (SchNet's activation). In float32
    F.softplus; in bf16 `_Softplus` (XLA's evaluation, each op rounding to
    bf16) less log 2 rounded to bf16, as JAX rounds the weakly typed
    constant."""
    if x.dtype == torch.float32:
        return F.softplus(x) - _LOG2
    return _Softplus.apply(x) - weak_const(_LOG2, x)


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(name: str, family: str) -> torch.dtype:
    """The torch dtype of a model's `compute_dtype` setting; raises for one
    the port does not take."""
    if name not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype={name!r}: the port's {family} takes {', '.join(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


class Linear(nn.Linear):
    """nn.Linear run in `compute_dtype` as flax's ``Dense(dtype=...)`` runs:
    the input, weight and bias cast to it, the product rounded to it and
    then the bias added in it (a bias under half an ulp of the product adds
    nothing, as in the JAX model), the parameters float32. None or float32
    runs nn.Linear as it is."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None or dt == torch.float32:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


def embed(table: nn.Embedding, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Embed(dtype=...)``: the looked-up rows cast to `dtype`."""
    return table(idx).to(dtype)


class MLP(nn.Module):
    """Linear stack with configurable activation; last layer linear.
    Layer i corresponds to the flax MLP's ``Dense_i``; `compute_dtype` as
    the flax MLP's ``dtype``."""

    def __init__(self, in_features: int, features: Sequence[int],
                 activation: Callable = silu, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims = [in_features, *features]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], bias=bias, compute_dtype=compute_dtype)
            for i in range(len(features))
        )
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.activation(x)
        return x


class DenseParams(nn.Module):
    """A flax Dense's parameters under flax's names (kernel [in, out], bias
    [out]), for layers applied by hand or handed to a kernel."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))


class LayerNormParams(nn.Module):
    """flax LayerNorm's parameters (scale, bias)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


def forward(model: nn.Module, batch: MolBatch,
            params: Optional[Dict[str, torch.Tensor]] = None) -> ModelOutput:
    """Run a model, deriving forces by autograd when the model requires it.

    The model runs on `params` (name -> tensor, e.g. an EMA copy) or, by
    default, on its own parameters detached: forces need ∂E/∂pos only, so
    no parameter gradient is asked for (the fused message's backward then
    skips its weight-gradient stage) and the module's trainable flags stay
    as they are. The energy gradient of molecule b only touches pos[b], so
    one gradient of the summed real-molecule energies yields all
    per-molecule forces; masks keep padding gradients at exactly zero.
    Outputs are detached.
    """
    if params is None:
        params = {name: p.detach() for name, p in model.named_parameters()}
    if not getattr(model, "derivative_forces", False):
        with torch.no_grad():
            return functional_call(model, params, (batch,))
    with torch.enable_grad():
        pos = batch.pos.detach().requires_grad_(True)
        out = functional_call(model, params, (batch.replace(pos=pos),))
        e = torch.where(batch.graph_mask, out["energy"], torch.zeros_like(out["energy"]))
        (grad,) = torch.autograd.grad(e.sum(), pos)
    out = {k: t.detach() for k, t in out.items()}
    out["forces"] = -grad * batch.node_mask[..., None]
    return out


def dual_lanes(x: torch.Tensor):
    """(primal, tangent) of a forward-AD dual tensor as contiguous plain
    tensors, for the dual message kernels; a missing tangent (a value that
    does not depend on pos) is zeros."""
    p, t = fwAD.unpack_dual(x)
    return p.contiguous(), (torch.zeros_like(p) if t is None else t.contiguous())


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

