"""Pretrained restore of eSCN, EquiformerV2 and QHNet against the JAX package.

As ``test_torch_pretrained.py`` for the other four families: one seeded
reference-named state dict (from the JAX package's golden tests) through
JAX's `convert_state_dict` and the port's; the module's template against
the tree of JAX's ``model.init``, the two converted trees bit for bit, and
the outputs of the two models (E rtol 2e-4 / atol 1e-5, F rtol 2e-3 /
atol 2e-4, QHNet's H within 1e-4 × max |H|). eSCN's converter fills the XLA
layout, which the port maps to its fused layout (the JAX tree is compared
after the same map); EquiformerV2's runs the reference-compatible variant
(``m_share_rad=False``, the plain path), QHNet's ``ref_compat=True``. The JAX
tests' functional-torch goldens of these three need the reference's Jd.pt
and skip, as those tests do, where it is missing.
"""

import numpy as np
import pytest
import torch

from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models.convert import escn_params, flax_params_of, load_flax_params
from tests.models import test_pretrained_eqv2 as eqv2_golden
from tests.models import test_pretrained_escn as escn_golden
from tests.models import test_pretrained_qhnet as qhnet_golden
from tests.test_torch_pretrained import (
    assert_same_trees, convert_both, outputs_match, torch_batch,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ESCN = dict(num_layers=escn_golden.LAYERS, l_max=escn_golden.L, m_max=escn_golden.M,
            sphere_channels=escn_golden.C, hidden=escn_golden.H, edge_channels=escn_golden.EC,
            cutoff=escn_golden.CUTOFF, max_neighbors=5, num_sphere_samples=escn_golden.SAMPLES,
            distance_resolution=escn_golden.RES, grid_points_factor=escn_golden.GPF)
EQV2 = dict(num_layers=eqv2_golden.LAYERS, sphere_channels=eqv2_golden.C,
            num_heads=eqv2_golden.H, attn_alpha_channels=eqv2_golden.VA,
            attn_value_channels=eqv2_golden.VC, attn_hidden_channels=eqv2_golden.HID,
            ffn_hidden_channels=eqv2_golden.FFN_H, l_max=eqv2_golden.L, m_max=eqv2_golden.M,
            edge_channels=eqv2_golden.EC, num_distance_basis=eqv2_golden.NB,
            cutoff=eqv2_golden.CUTOFF, max_neighbors=5, grid_points_factor=eqv2_golden.GPF,
            m_share_rad=False, avg_num_nodes=eqv2_golden.AVG_NODES,
            avg_degree=eqv2_golden.AVG_DEG)
QHNET = dict(hidden=qhnet_golden.C, bottle_hidden=qhnet_golden.CB, num_layers=3,
             radius_cutoff=qhnet_golden.CUTOFF, rbf_dim=qhnet_golden.RBF, start_layer=1,
             orbitals=qhnet_golden.ORBITALS, ref_compat=True, remat=False)


def _port(family, **kw):
    return create_model(family, device="cpu", generator=torch.Generator().manual_seed(0), **kw)


def test_escn_converter_matches_jax():
    jb = escn_golden.mk_batch(np.random.default_rng(0))
    state = escn_golden.escn_state(np.random.default_rng(23))
    jax_model = jax_create_model("escn", use_pallas=False, remat=False, **ESCN)
    port = _port("escn", **ESCN)
    template = escn_params(flax_params_of(port), "xla")
    port_tree, jax_xla = convert_both("escn", state, jax_model, port, jb)
    assert_same_trees(escn_params(port_tree, "xla"), jax_xla, template)
    assert_same_trees(port_tree, escn_params(jax_xla, "pallas"))
    outputs_match(load_flax_params(port, port_tree), jax_model, jax_xla, jb)


def test_eqv2_converter_matches_jax():
    jb = escn_golden.mk_batch(np.random.default_rng(0))
    state = eqv2_golden.eqv2_state(np.random.default_rng(31))
    jax_model = jax_create_model("equiformer_v2", use_pallas=False, remat=False, **EQV2)
    port = _port("equiformer_v2", **EQV2)
    assert port.use_pallas == "off"
    port_tree, jax_tree = convert_both("equiformer_v2", state, jax_model, port, jb)
    assert_same_trees(port_tree, jax_tree, flax_params_of(port))
    outputs_match(load_flax_params(port, port_tree), jax_model, jax_tree, jb)


def test_eqv2_converter_needs_the_reference_variant():
    port = _port("equiformer_v2", **dict(EQV2, m_share_rad=True))
    state = {k: v.numpy() for k, v in eqv2_golden.eqv2_state(np.random.default_rng(31)).items()}
    from nabladft_tpu_torch.models.pretrained import convert_state_dict

    with pytest.raises(ValueError, match="m_share_rad"):
        convert_state_dict("equiformer_v2", state, port)
    with pytest.raises(ValueError, match="no fused kernel"):
        _port("equiformer_v2", **EQV2, use_pallas="fused")


def test_qhnet_converter_matches_jax(monkeypatch):
    # the JAX test's state dict at 3 layers, self / pair heads from layer 2
    monkeypatch.setattr(qhnet_golden, "LAYERS", QHNET["num_layers"])
    monkeypatch.setattr(qhnet_golden, "START", QHNET["start_layer"])
    jb = qhnet_golden.mk_batch(np.random.default_rng(0))
    state = qhnet_golden.qhnet_state(np.random.default_rng(31))
    jax_model = jax_create_model("qhnet", use_pallas=False, **QHNET)
    port = _port("qhnet", **QHNET)
    port_tree, jax_tree = convert_both("qhnet", state, jax_model, port, jb)
    rows = {"node_embedding/embedding": len(state["node_embedding.weight"])}
    assert_same_trees(port_tree, jax_tree, flax_params_of(port), rows)
    import jax

    want = np.asarray(jax.jit(jax_model.apply)(jax_tree, jb)["hamiltonian"])
    with torch.no_grad():
        got = load_flax_params(port, port_tree).eval()(torch_batch(jb))["hamiltonian"].numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("name", ["escn", "eqv2", "qhnet"])
def test_port_matches_the_reference_golden(name, monkeypatch):
    """The JAX tests' functional-torch reference forwards (they need the
    reference's Jd.pt and skip without it, as the JAX tests do)."""
    if name == "qhnet":
        monkeypatch.setattr(qhnet_golden, "LAYERS", QHNET["num_layers"])
        monkeypatch.setattr(qhnet_golden, "START", QHNET["start_layer"])
        jb = qhnet_golden.mk_batch(np.random.default_rng(0))
        state = qhnet_golden.qhnet_state(np.random.default_rng(31))
        ref = qhnet_golden.qhnet_torch_forward(state, jb)
        port = _port("qhnet", **QHNET)
    else:
        mod, family, kw, seed = ((escn_golden, "escn", ESCN, 23) if name == "escn"
                                 else (eqv2_golden, "equiformer_v2", EQV2, 31))
        jb = escn_golden.mk_batch(np.random.default_rng(0))
        state = (mod.escn_state if name == "escn" else mod.eqv2_state)(np.random.default_rng(seed))
        ref = (mod.escn_torch_forward if name == "escn" else mod.eqv2_torch_forward)(state, jb)
        port = _port(family, **kw)
    from nabladft_tpu_torch.models.pretrained import convert_state_dict

    tree = convert_state_dict("qhnet" if name == "qhnet" else family,
                              {k: v.numpy() for k, v in state.items()}, port)
    with torch.no_grad():
        out = load_flax_params(port, tree).eval()(torch_batch(jb))
    if name == "qhnet":
        for b, h in enumerate(ref):
            n = h.shape[0]
            np.testing.assert_allclose(out["hamiltonian"][b, :n, :n].numpy(), h, rtol=2e-4,
                                       atol=3e-4 * np.abs(h).max())
        return
    golden_e, golden_f = ref
    np.testing.assert_allclose(out["energy"].numpy(), golden_e, rtol=2e-4, atol=1e-6)
    for b, f in enumerate(golden_f):
        np.testing.assert_allclose(out["forces"][b, :len(f)].numpy(), f, rtol=2e-4, atol=1e-6)
