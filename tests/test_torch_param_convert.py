"""The port's eSCN / EquiformerV2 layout maps against the JAX package's.

`models/convert.escn_params` and `eqv2_params` (the port of
``nabladft_tpu/models/param_convert.py``) on trees of the JAX XLA models'
``init``: the fused layout equals the JAX map's bit for bit and has the
keys and shapes of the port module's own tree (`flax_params_of`); the
round trip back to the XLA layout is the identity; and an XLA-layout JAX
eSCN tree loaded straight into the port (`load_flax_params` maps it) gives
JAX's energy and forces (E rtol 2e-4 / atol 1e-5, F rtol 2e-3 / atol 2e-4).
"""

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models.param_convert import eqv2_params as jax_eqv2_params
from nabladft_tpu.models.param_convert import escn_params as jax_escn_params
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models.convert import (
    _leaves, eqv2_params, escn_params, flax_params_of, load_flax_params,
)
from tests.models.test_param_convert import EQV2_KW, ESCN_KW, _batch
from tests.test_torch_pretrained import outputs_match


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert set(la) == set(lb)
    for k in la:
        assert np.array_equal(np.asarray(la[k]), np.asarray(lb[k])), "/".join(k)


@pytest.mark.parametrize("family", ["escn", "equiformer_v2"])
def test_layout_maps_match_jax_and_round_trip(family):
    kw = ESCN_KW if family == "escn" else EQV2_KW
    jb = _batch(np.random.default_rng(0))
    xla = _np(jax.jit(jax_create_model(family, use_pallas=False, **kw).init)(
        jax.random.PRNGKey(0), jb))
    if family == "escn":
        to, back = (lambda t: escn_params(t, "pallas")), (lambda t: escn_params(t, "xla"))
        want = _np(jax_escn_params(xla, "pallas"))
    else:
        co = kw["num_heads"] * kw["attn_value_channels"]
        to = lambda t: eqv2_params(t, "pallas", kw["l_max"], co)  # noqa: E731
        back = lambda t: eqv2_params(t, "xla", kw["l_max"], co)  # noqa: E731
        want = _np(jax_eqv2_params(xla, "pallas", kw["l_max"], kw["m_max"], co))
    fused = to(xla)
    _same(fused, want)
    _same(back(fused), xla)
    assert to(fused) is fused  # already in the layout: the tree itself
    port = flax_params_of(create_model(family, device="cpu", **kw))
    assert {k: np.shape(v) for k, v in _leaves(port["params"]).items()} == {
        k: np.shape(v) for k, v in _leaves(fused["params"]).items()}


def test_xla_escn_tree_gives_jax_energy_in_the_port():
    jb = _batch(np.random.default_rng(1))
    jax_model = jax_create_model("escn", use_pallas=False, remat=False, **ESCN_KW)
    xla = _np(jax.jit(jax_model.init)(jax.random.PRNGKey(3), jb))
    port = load_flax_params(create_model("escn", device="cpu", **ESCN_KW), xla)
    outputs_match(port, jax_model, xla, jb)
