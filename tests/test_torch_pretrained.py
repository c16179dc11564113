"""Pretrained restore in the port against the JAX package's converters.

For SchNet, PaiNN, DimeNet++ and Graphormer3D (the equivariant three are in
``test_torch_pretrained_equivariant.py``) one seeded state dict under the
reference's parameter names (from the JAX package's golden tests) goes
through JAX's `convert_state_dict` and through the port's:

* the module's template (`flax_params_of`) has the keys and shapes of the
  tree JAX's ``model.init`` gives;
* the two converted trees have equal keys, shapes and bits;
* E and F of the two models agree (E rtol 2e-4 / atol 1e-5, F rtol 2e-3 /
  atol 2e-4), and the port's E matches the JAX tests' functional-torch
  golden of the reference forward within those tests' own tolerance.

Around them: the registry-name resolver over all 42 names (the JAX package
refuses ``Equiformer-v2_*``; the port resolves it), the Lightning ``.ckpt``
reader with a hyper-parameter object whose class cannot be imported, and
`get_pretrained_params` reaching a checkpoint through the registry's cache
with ``urlopen`` patched to raise.
"""

import hashlib
import json
import pickle
import sys
import types
import urllib.request

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models import pretrained as jax_pretrained
from nabladft_tpu.models.base import forward as jax_forward
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.data.registry import CheckpointRegistry, checkpoint_registry
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models import pretrained
from nabladft_tpu_torch.models.base import forward
from nabladft_tpu_torch.models.convert import _leaves, flax_params_of, load_flax_params
from tests.models import test_pretrained_converters as golden

E_TOL = dict(rtol=2e-4, atol=1e-5)
F_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def torch_batch(jb) -> MolBatch:
    b, a = jb.z.shape
    return MolBatch(z=torch.from_numpy(np.asarray(jb.z)), pos=torch.from_numpy(np.asarray(jb.pos)),
                    node_mask=torch.from_numpy(np.asarray(jb.node_mask)),
                    graph_mask=torch.from_numpy(np.asarray(jb.graph_mask)),
                    energy=torch.zeros(b), forces=torch.zeros(b, a, 3),
                    mol_id=torch.from_numpy(np.asarray(jb.mol_id)),
                    orb_mask=(None if jb.orb_mask is None
                              else torch.from_numpy(np.asarray(jb.orb_mask))))


def assert_same_trees(port_tree, jax_tree, template=None, rows=None):
    """Equal keys, shapes and bits; the template (if given) has the JAX
    tree's keys and shapes. `rows` {path: n}: tables the converter fills
    only up to the checkpoint's n rows (the rest keep each side's own
    initial values), compared on those rows."""
    pl, jl = _leaves(port_tree["params"]), _leaves(jax_tree["params"])
    if template is not None:
        tl = _leaves(template["params"])
        assert set(tl) == set(jl)
        assert all(tl[k].shape == np.shape(jl[k]) for k in jl)
    assert set(pl) == set(jl)
    for k in jl:
        assert pl[k].shape == np.shape(jl[k]), k
        a, b = pl[k], np.asarray(jl[k], np.float32)
        n = (rows or {}).get("/".join(k))
        if n is not None:
            a, b = a[:n], b[:n]
        assert np.array_equal(a, b), "/".join(k)


def convert_both(family, state_t, jax_model, port_model, jb, jax_tree_fn=None):
    """(port tree, JAX tree) of one state dict; `jax_tree_fn` maps JAX's
    result to the port's layout."""
    np_state = {k: v.numpy() for k, v in state_t.items()}
    jax_tree = jax_pretrained.convert_state_dict(family, np_state, jax_model, jb)
    if jax_tree_fn is not None:
        jax_tree = jax_tree_fn(jax_tree)
    return pretrained.convert_state_dict(family, np_state, port_model), jax_tree


def outputs_match(port_model, jax_model, jax_tree_for_apply, jb, keys=("energy", "forces")):
    """The port's outputs (eval mode), after checking them against JAX's."""
    with torch.no_grad():
        out = forward(port_model.eval(), torch_batch(jb))
    want = jax.jit(lambda p, b: jax_forward(jax_model, p, b))(jax_tree_for_apply, jb)
    for k in keys:
        got, ref = out[k].detach().numpy(), np.asarray(want[k])
        np.testing.assert_allclose(got, ref, **(F_TOL if k == "forces" else E_TOL), err_msg=k)
    return out


SCHNET = dict(hidden=golden.F, n_interactions=golden.L, n_rbf=golden.R, cutoff=golden.CUTOFF,
              max_neighbors=63)
PAINN = dict(hidden=golden.F, n_interactions=golden.L, n_rbf=golden.R, cutoff=golden.CUTOFF,
             max_neighbors=63, envelope="cosine")
CASES = {
    # family: (state dict, seed, JAX kwargs, port kwargs, batch kwargs, golden forward, tol)
    "schnet": (golden.schnet_state, 11, SCHNET, SCHNET, {}, golden.schnet_torch_forward,
               dict(rtol=1e-5, atol=1e-5)),
    "painn": (golden.painn_state, 13, dict(PAINN, remat=False), PAINN, {},
              golden.painn_torch_forward, dict(rtol=1e-4, atol=1e-5)),
    "dimenetpp": (golden.dimenetpp_state, 13, golden.DPP, golden.DPP, dict(B=3, A=8),
                  golden.dimenetpp_torch_forward, dict(rtol=2e-4, atol=2e-5)),
    "graphormer3d": (golden.graphormer_state, 17, golden.G3D, golden.G3D, dict(B=3, A=8),
                     lambda s, b: golden.graphormer_torch_forward(s, b)[0],
                     dict(rtol=2e-4, atol=2e-5)),
}


@pytest.mark.parametrize("family", sorted(CASES))
def test_converter_matches_jax_and_the_golden(family):
    build, seed, jkw, pkw, bkw, golden_fwd, tol = CASES[family]
    jb = golden.mk_batch(np.random.default_rng(0), **bkw)
    state = build(np.random.default_rng(seed))
    jax_model = jax_create_model(family, **jkw)
    port_model = create_model(family, device="cpu", generator=torch.Generator().manual_seed(0),
                              **pkw)
    template = flax_params_of(port_model)
    port_tree, jax_tree = convert_both(family, state, jax_model, port_model, jb)
    assert_same_trees(port_tree, jax_tree, template)
    load_flax_params(port_model, port_tree)
    out = outputs_match(port_model, jax_model, jax_tree, jb)
    np.testing.assert_allclose(out["energy"].numpy(), golden_fwd(state, jb).numpy(), **tol)


# ---------------------------------------------------------------------------
# names, files and the registry
# ---------------------------------------------------------------------------


def test_every_registry_name_resolves():
    names = checkpoint_registry.list_checkpoints()
    assert len(names) == 42
    families = {n: pretrained.family_of(n) for n in names}
    convertible = set(pretrained.convertible_families())
    assert convertible == {"schnet", "painn", "dimenetpp", "graphormer3d", "escn",
                           "equiformer_v2", "qhnet"}
    assert set(families.values()) == convertible | set(pretrained.NOT_CONVERTIBLE)
    assert sum(f in convertible for f in families.values()) == 29
    for name, family in families.items():
        if family in pretrained.NOT_CONVERTIBLE:
            with pytest.raises(NotImplementedError, match=pretrained.NOT_CONVERTIBLE[family][:20]):
                pretrained.get_pretrained_params(name, None)


def test_jax_refuses_equiformer_v2_names_and_the_port_resolves_them():
    """The JAX package's resolver lower-cases 'Equiformer-v2' to
    'equiformerv2', which is neither an alias nor a converter name there."""
    with pytest.raises(NotImplementedError, match="equiformerv2"):
        jax_pretrained.get_pretrained_params("Equiformer-v2_train_tiny", None, None)
    assert pretrained.family_of("Equiformer-v2_train_tiny") == "equiformer_v2"
    assert "equiformer_v2" in pretrained.convertible_families()


def _lightning_ckpt(path, state):
    """A Lightning-shaped .ckpt whose hyper_parameters hold an object of a
    class from a module that is gone when the file is read."""
    mod = types.ModuleType("vanished_lightning_module")

    class AttributeDict(dict):
        pass

    class Hyper:
        def __init__(self):
            self.lr = 1e-3

    for cls in (AttributeDict, Hyper):
        cls.__module__, cls.__qualname__ = mod.__name__, cls.__name__
        setattr(mod, cls.__name__, cls)
    sys.modules[mod.__name__] = mod
    try:
        hp = AttributeDict(net=Hyper(), lr=5e-4)
        torch.save({"state_dict": state, "hyper_parameters": hp, "epoch": 3}, path)
    finally:
        del sys.modules[mod.__name__]


def test_lightning_checkpoint_reads_without_its_classes(tmp_path):
    state = {"net.a.weight": torch.arange(6.0).reshape(2, 3), "net.steps": torch.tensor(4)}
    _lightning_ckpt(tmp_path / "x.ckpt", state)
    with pytest.raises(pickle.UnpicklingError):
        torch.load(tmp_path / "x.ckpt", weights_only=True)
    got = pretrained.load_torch_state_dict(tmp_path / "x.ckpt")
    assert set(got) == set(state)
    for k, v in state.items():
        assert np.array_equal(got[k], v.numpy())
    torch.save(state, tmp_path / "plain.pt")  # the weights_only route
    assert set(pretrained.load_torch_state_dict(tmp_path / "plain.pt")) == set(state)


def _cached_checkpoint(tmp_path, name, state):
    cache = tmp_path / "cache"
    cache.mkdir()
    _lightning_ckpt(cache / f"{name}.ckpt", state)
    md5 = hashlib.md5((cache / f"{name}.ckpt").read_bytes()).hexdigest()
    links = tmp_path / "links.json"
    links.write_text(json.dumps({"checkpoints": {
        name: {"url": "https://checkpoints.invalid/x.ckpt", "etag": md5}}}))
    return cache, CheckpointRegistry(links)


def test_get_pretrained_params_reads_the_cache_and_fetches_nothing(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("urlopen called")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    torch_state = golden.schnet_state(np.random.default_rng(11))
    cache, reg = _cached_checkpoint(tmp_path, "SchNet_train_tiny", torch_state)
    model = create_model("schnet", device="cpu", **SCHNET)
    got = pretrained.get_pretrained_params("SchNet_train_tiny", model, cache, reg)
    want = pretrained.convert_state_dict("schnet", {k: v.numpy() for k, v in torch_state.items()},
                                         model)
    assert_same_trees(got, want)
    # a file that is not the one the links file names is fetched again: refused here
    (cache / "SchNet_train_tiny.ckpt").write_bytes(b"changed")
    with pytest.raises(AssertionError, match="urlopen called"):
        pretrained.get_pretrained_params("SchNet_train_tiny", model, cache, reg)


def test_chip_smoke_painn_config_is_the_composed_yaml():
    """chip_smoke's configs/painn.yaml (its pretrained_painn phase)."""
    from pathlib import Path

    from nabladft_tpu_torch.config import load_config

    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(repo))
    want = load_config(repo / "configs" / "painn.yaml", overrides={
        "job_type": "predict", "output_db": "/db/out.db",
        "datamodule": {"source": "/db/in.db", "root": "/db"}})
    assert chip_smoke.smoke_config("/db/in.db", "/db/out.db", "/db", config="painn") == want
