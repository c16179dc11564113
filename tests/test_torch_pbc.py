"""The port's periodic neighbour list and periodic PaiNN against the JAX
package's, on the CPU (the cases of tests/ops/test_pbc.py).

* `graph.pbc_neighbor_list` on each case of the JAX test: brute force over
  the images, the per-axis pbc flags, the strict top-k truncation, the
  counter-edge symmetrisation and an atom's own periodic images: the same
  (receiver, sender, image) sets as JAX's and as the brute force, distances
  within 1e-6 Å of JAX's;
* PaiNN with pbc=True at a small width (hidden 16, 2 interactions, 8 RBF),
  on one seeded flax tree, over a periodic batch of two molecules (one
  padded) in skewed cells: E within 1e-5 × max |E|, F within 1e-4 × max
  |F|, and the parameter gradients of Σ E + Σ F² (through the forces)
  within 1e-4 × max |g| per tensor of JAX's; in a huge cell the periodic
  path equals the molecular one; a lattice translation of one atom leaves E
  unchanged; without a cell both packages raise the same ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxMolBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.ops import graph as jax_graph
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models import create_model, forward
from nabladft_tpu_torch.models.convert import flax_params_of, load_flax_params
from nabladft_tpu_torch.ops import graph
from tests.ops.test_pbc import brute_force_edges, nl_edges

KW = dict(hidden=16, n_interactions=2, n_rbf=8, cutoff=3.0, max_neighbors=12)
E_REL, F_REL, G_REL = 1e-5, 1e-4, 1e-4
DIST_ATOL = 1e-6  # Å


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(pos, cell, node_mask=None, **kw):
    """The port's and JAX's lists on one molecule."""
    node_mask = np.ones(len(pos), bool) if node_mask is None else node_mask
    args = [np.asarray(x, dt)[None] for x, dt in ((pos, np.float32), (node_mask, bool),
                                                  (cell, np.float32))]
    port = graph.pbc_neighbor_list(*(torch.from_numpy(a) for a in args), **kw)
    # one compile of the whole list (eager JAX compiles op by op)
    ref = jax.jit(lambda *a: jax_graph.pbc_neighbor_list(*a, **kw))(*args)
    return port, ref


def _same_lists(port, ref):
    got, got_d = nl_edges(port)
    want, want_d = nl_edges(ref)
    assert got == want
    for e in want:
        assert abs(got_d[e] - want_d[e]) <= DIST_ATOL, e
    return got, got_d


def test_brute_force():
    rng = np.random.default_rng(0)
    cell = np.diag([4.0, 5.0, 6.0]) + rng.normal(0, 0.2, (3, 3))
    pos = rng.uniform(0, 4.0, (6, 3))
    ref_edges, ref_d = brute_force_edges(pos, cell, 3.5, 1)
    got, got_d = _same_lists(*_both(pos, cell, cutoff=3.5, max_neighbors=len(ref_edges) + 8,
                                    n_images=1, symmetrize=False))
    assert got == ref_edges
    for e in ref_edges:
        assert got_d[e] == pytest.approx(ref_d[e], abs=1e-4)


@pytest.mark.parametrize("pbc", [(True, False, False), (False, True, True),
                                 (False, False, False)])
def test_axis_flags(pbc):
    pos, cell = np.array([[0.1, 0.1, 0.1], [2.9, 2.9, 2.9]]), np.diag([3.0, 3.0, 3.0])
    got, _ = _same_lists(*_both(pos, cell, cutoff=1.5, max_neighbors=30, pbc=pbc,
                                symmetrize=False))
    assert got == brute_force_edges(pos, cell, 1.5, 1, pbc)[0]


def test_topk_truncation_keeps_nearest():
    pos = np.array([[0.0, 0, 0], [1.0, 0, 0], [0, 1.5, 0], [0, 0, 2.0]])
    got, _ = _same_lists(*_both(pos, np.diag([50.0] * 3), cutoff=3.0, max_neighbors=2,
                                symmetrize=False))
    assert {e for e in got if e[0] == 0} == {(0, 1, 0, 0, 0), (0, 2, 0, 0, 0)}


def test_symmetrization_adds_counter_edges():
    pos = np.array([[0.0, 0, 0], [0.6, 0, 0], [0, 0.7, 0], [0, 0, 0.8], [0, 0, -2.4]])
    kw = dict(cutoff=3.0, max_neighbors=3, n_images=1)
    plain, _ = _same_lists(*_both(pos, np.diag([60.0] * 3), symmetrize=False, **kw))
    assert (4, 0, 0, 0, 0) in plain and (0, 4, 0, 0, 0) not in plain
    sym, _ = _same_lists(*_both(pos, np.diag([60.0] * 3), symmetrize=True, **kw))
    assert all((j, i, -ox, -oy, -oz) in sym for (i, j, ox, oy, oz) in sym)
    assert (0, 4, 0, 0, 0) in sym


def test_self_image_neighbors():
    got, got_d = _same_lists(*_both(np.array([[0.5, 5.0, 5.0]]), np.diag([2.0, 10.0, 10.0]),
                                    cutoff=2.5, max_neighbors=8, symmetrize=False))
    assert (0, 0, 1, 0, 0) in got and (0, 0, -1, 0, 0) in got
    assert got_d[(0, 0, 1, 0, 0)] == pytest.approx(2.0, abs=1e-5)


def test_padded_atoms_have_no_edges():
    pos = np.random.default_rng(3).uniform(0, 3.0, (5, 3))
    mask = np.array([True, True, True, False, False])
    port, ref = _both(pos, np.diag([3.2, 3.4, 3.6]), node_mask=mask, cutoff=3.0,
                      max_neighbors=40)
    got, _ = _same_lists(port, ref)
    assert got and all(i < 3 and j < 3 for i, j, *_ in got)


# -- periodic PaiNN ------------------------------------------------------------


def periodic_batch(seed: int = 0) -> dict:
    """Two molecules of 5 and 4 atoms in skewed cells of ~3.5 Å (every atom
    sees its own images within the cutoff)."""
    rng = np.random.default_rng(seed)
    b, a = 2, 5
    node_mask = np.ones((b, a), bool)
    node_mask[1, 4] = False
    cell = (np.diag([3.5, 3.8, 4.1]) + rng.normal(0, 0.15, (b, 3, 3))).astype(np.float32)
    pos = (rng.uniform(0, 1, (b, a, 3)) @ cell).astype(np.float32) * node_mask[..., None]
    z = np.where(node_mask, rng.integers(1, 9, (b, a)), 0).astype(np.int32)
    return dict(z=z, pos=pos, node_mask=node_mask, graph_mask=np.ones(b, bool),
                energy=np.zeros(b, np.float32), forces=np.zeros((b, a, 3), np.float32),
                mol_id=np.arange(b, dtype=np.int32), cell=cell)


def _tb(f: dict) -> MolBatch:
    return MolBatch(**{k: torch.from_numpy(np.array(v)) for k, v in f.items()})


@pytest.fixture(scope="module")
def params():
    return flax_params_of(create_model("painn", device="cpu",
                                       generator=torch.Generator().manual_seed(0), **KW))


def _port(params, **kw):
    return load_flax_params(create_model("painn", device="cpu", **dict(KW, **kw)), params)


def _jax_outputs(params, f: dict, pbc: bool = True):
    """E, F and the parameter gradient of Σ E + Σ F² (through F)."""
    model = jax_create_model("painn", pbc=pbc, remat=False, **KW)
    jb = JaxMolBatch(**f)

    def energy(p, pos):
        e = model.apply(p, jb.replace(pos=pos))["energy"]
        return jnp.where(jb.graph_mask, e, 0.0).sum(), e

    @jax.jit
    def run(p):
        (_, e), g = jax.value_and_grad(energy, argnums=1, has_aux=True)(p, jb.pos)

        def loss(q):
            (es, _), gq = jax.value_and_grad(energy, argnums=1, has_aux=True)(q, jb.pos)
            return es + jnp.sum((gq * jb.node_mask[..., None]) ** 2)

        return e, -g * jb.node_mask[..., None], jax.grad(loss)(p)

    return jax.device_get(run(params))


def _port_outputs(model, f: dict):
    batch = _tb(f)
    out = forward(model, batch)
    pos = batch.pos.clone().requires_grad_(True)
    e = model(batch.replace(pos=pos))["energy"]
    (g,) = torch.autograd.grad(torch.where(batch.graph_mask, e, 0.0).sum(), pos,
                               create_graph=True)
    (e.sum() + ((g * batch.node_mask[..., None]) ** 2).sum()).backward()
    return out["energy"].numpy(), out["forces"].numpy(), model


def test_periodic_painn_matches_jax(params):
    f = periodic_batch()
    e_jax, f_jax, g_jax = _jax_outputs(params, f)
    e, forces, model = _port_outputs(_port(params, pbc=True), f)
    assert np.abs(e - e_jax).max() <= E_REL * np.abs(e_jax).max()
    assert np.abs(forces - f_jax).max() <= F_REL * np.abs(f_jax).max()
    assert np.abs(f_jax).max() > 1e-2
    twin = load_flax_params(create_model("painn", device="cpu", **KW), g_jax)
    for (name, p), (_, w) in zip(model.named_parameters(), twin.named_parameters()):
        w = w.detach().numpy()
        assert np.abs(p.grad.numpy() - w).max() <= G_REL * np.abs(w).max() + 1e-9, name


def test_huge_cell_equals_the_molecular_path(params):
    f = periodic_batch(1)
    f["cell"] = np.broadcast_to(np.diag([80.0] * 3), (2, 3, 3)).astype(np.float32).copy()
    e_pbc = forward(_port(params, pbc=True), _tb(f))
    e_mol = forward(_port(params), _tb(f))
    np.testing.assert_allclose(e_pbc["energy"].numpy(), e_mol["energy"].numpy(), rtol=1e-5)
    np.testing.assert_allclose(e_pbc["forces"].numpy(), e_mol["forces"].numpy(), rtol=1e-4,
                               atol=1e-6)


def test_lattice_translation_invariance(params):
    f = periodic_batch(2)
    model = _port(params, pbc=True)
    moved = dict(f, pos=f["pos"].copy())
    moved["pos"][0, 2] += f["cell"][0, 0] + f["cell"][0, 2]
    e1, e2 = (forward(model, _tb(x))["energy"].numpy() for x in (f, moved))
    np.testing.assert_allclose(e1, e2, rtol=2e-5)


def test_a_missing_cell_raises_as_in_jax(params):
    f = dict(periodic_batch())
    f.pop("cell")
    with pytest.raises(ValueError, match=r"requires batch.cell") as port_err:
        forward(_port(params, pbc=True), _tb(f))
    with pytest.raises(ValueError, match=r"requires batch.cell") as jax_err:
        jax_create_model("painn", pbc=True, **KW).apply(params, JaxMolBatch(**f))
    assert str(port_err.value) == str(jax_err.value)
