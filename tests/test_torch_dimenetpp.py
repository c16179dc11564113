"""The port's DimeNet++ and spherical bases against the JAX package's.

* every function of `ops/spherical.py` (Legendre polynomials, spherical
  Bessel j_l and its series, the Bessel zeros, the DimeNet spherical basis
  and radial part, the enveloped Bessel radial basis) and
  `dimenet_bessel_rbf` with trainable frequencies, on seeded distances and
  angles: within rtol 1e-5 / atol 1e-6 (the zeros exactly);
* DimeNet++ at a small width (hidden 16, two blocks, 3 spherical × 3
  radial, K = 4 neighbours of up to 5, so the top-K cut and the back-
  triplet map's missing reverse edges both occur), the JAX model's flax
  tree (perturbed, so the zero-initialised output projections carry
  weight) carried across: E within rtol 2e-4 / atol 1e-5 and F =
  -∂E/∂pos within rtol 2e-3 / atol 2e-4, and the parameter gradients of
  the energy + force loss (second order: the force loss is differentiated
  through the forces) within 2e-3 × max |g| per tensor, against JAX's
  three layouts: compact with `take` gathers, compact with one-hot
  matmuls, and dense;
* a tie in the neighbour list: four neighbours at one distance and K = 2
  keep the two lower indices, as `lax.top_k`, and E and F equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxMolBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.ops import radial as jax_radial
from nabladft_tpu.ops import spherical as jax_sph
from nabladft_tpu.train.losses import multitask_loss as jax_multitask_loss
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models import create_model, forward
from nabladft_tpu_torch.models.convert import flax_params_of, load_flax_params
from nabladft_tpu_torch.ops import graph, radial, spherical
from nabladft_tpu_torch.train.losses import multitask_loss


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(hidden=16, num_blocks=2, int_emb_size=8, basis_emb_size=4, out_emb_channels=16,
          num_spherical=3, num_radial=3, max_neighbors=4, node_latent_dim=8,
          energy_mean=-1.0, energy_std=2.0)
SPEC = {"energy": "l1", "forces": "l1"}
COEF = {"energy": 1.0, "forces": 1.0}
BASIS_TOL = dict(rtol=1e-5, atol=1e-6)
E_TOL = dict(rtol=2e-4, atol=1e-5)
F_TOL = dict(rtol=2e-3, atol=2e-4)
G_REL = 2e-3
LAYOUTS = {"compact_take": dict(compact=True, gather_mode="take"),
           "compact_onehot": dict(compact=True, gather_mode="onehot"),
           "dense": dict(compact=False)}


def energy_batch(seed=0, b=3, a=6) -> dict:
    rng = np.random.default_rng(seed)
    z = rng.integers(1, 9, (b, a)).astype(np.int32)
    pos = rng.uniform(-1.6, 1.6, (b, a, 3)).astype(np.float32)
    node_mask = np.ones((b, a), bool)
    node_mask[1:, 4:] = False
    node_mask[2:] = False  # a padding molecule
    z[~node_mask] = 0
    pos[~node_mask] = 0.0
    return dict(z=z, pos=pos, node_mask=node_mask, graph_mask=node_mask.any(1),
                energy=rng.normal(size=b).astype(np.float32),
                forces=(rng.normal(size=(b, a, 3)) * node_mask[..., None]).astype(np.float32),
                mol_id=np.arange(b, dtype=np.int32))


def torch_batch(f: dict) -> MolBatch:
    return MolBatch(**{k: torch.from_numpy(np.array(v)) for k, v in f.items()})


def _jax_reference(model, params, f: dict, grads: bool = True):
    """E, F and (with `grads`) the parameter gradient of the E + F loss
    (through F)."""
    jb = JaxMolBatch(**f)

    def outputs(params, pos):
        out = model.apply(params, jb.replace(pos=pos))
        return jnp.where(jb.graph_mask, out["energy"], 0.0).sum(), out

    @jax.jit
    def run(params):
        (_, out), g = jax.value_and_grad(outputs, argnums=1, has_aux=True)(params, jb.pos)

        def loss(p):
            g, out = jax.grad(outputs, argnums=1, has_aux=True)(p, jb.pos)
            o = {"energy": out["energy"], "forces": -g * jb.node_mask[..., None]}
            return jax_multitask_loss(o, jb, SPEC, COEF)["total"]

        forces = -g * jb.node_mask[..., None]
        return out["energy"], forces, (jax.grad(loss)(params) if grads else None)

    return jax.device_get(run(params))


@pytest.fixture(scope="module")
def params():
    """The port's seeded initial weights as the flax tree (no JAX init to
    compile), perturbed (the zero-initialised output projections then carry
    weight)."""
    p = flax_params_of(create_model("dimenetpp", device="cpu",
                                    generator=torch.Generator().manual_seed(0), **KW))
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.normal(size=np.shape(x))).astype(np.float32), p)


@pytest.fixture(scope="module")
def port_result(params):
    """The port's E, F and loss gradients on the same batch and weights."""
    model = load_flax_params(create_model("dimenetpp", device="cpu", **KW), params)
    batch = torch_batch(energy_batch())
    out = forward(model, batch)
    pos = batch.pos.clone().requires_grad_(True)
    e = model(batch.replace(pos=pos))["energy"]
    (g,) = torch.autograd.grad(torch.where(batch.graph_mask, e, 0.0).sum(), pos,
                               create_graph=True)
    losses = multitask_loss({"energy": e, "forces": -g * batch.node_mask[..., None]}, batch,
                            SPEC, COEF)
    losses["total"].backward()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    return out["energy"].numpy(), out["forces"].numpy(), grads


# -- bases -------------------------------------------------------------------


def test_legendre_and_bessel_match_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, 50).astype(np.float32)
    np.testing.assert_allclose(spherical.legendre_polynomials(torch.from_numpy(x), 6).numpy(),
                               jax_sph.legendre_polynomials(jnp.asarray(x), 6), **BASIS_TOL)
    r = np.concatenate([[0.0, 1e-7], rng.uniform(0, 20, 60)]).astype(np.float32)
    np.testing.assert_allclose(spherical.spherical_bessel_jl(torch.from_numpy(r), 6).numpy(),
                               jax_sph.spherical_bessel_jl(jnp.asarray(r), 6), **BASIS_TOL)
    for l in (2, 5):
        np.testing.assert_allclose(
            spherical._jl_series(torch.from_numpy(r[:20] + 1e-3), l).numpy(),
            jax_sph._jl_series(jnp.asarray(r[:20] + 1e-3), l), **BASIS_TOL)
    assert spherical.spherical_bessel_zeros(6, 6) == jax_sph.spherical_bessel_zeros(6, 6)


def test_dimenet_bases_match_jax():
    rng = np.random.default_rng(3)
    d = np.concatenate([[0.0], rng.uniform(0, 5.5, (4, 7)).ravel()]).astype(np.float32)
    cos = rng.uniform(-1, 1, d.shape).astype(np.float32)
    td, tc = torch.from_numpy(d), torch.from_numpy(cos)
    np.testing.assert_allclose(
        spherical.dimenet_spherical_basis(td, tc, 7, 6, 5.0).numpy(),
        jax_sph.dimenet_spherical_basis(jnp.asarray(d), jnp.asarray(cos), 7, 6, 5.0),
        **BASIS_TOL)
    np.testing.assert_allclose(spherical.dimenet_radial_part(td, 7, 6, 5.0).numpy(),
                               jax_sph.dimenet_radial_part(jnp.asarray(d), 7, 6, 5.0),
                               **BASIS_TOL)
    np.testing.assert_allclose(
        spherical.bessel_radial_basis_with_envelope(td, 6, 5.0).numpy(),
        jax_sph.bessel_radial_basis_with_envelope(jnp.asarray(d), 6, 5.0), **BASIS_TOL)
    freqs = (np.arange(1, 7) * np.pi + rng.normal(size=6) * 0.1).astype(np.float32)
    for fr in (None, freqs):
        np.testing.assert_allclose(
            radial.dimenet_bessel_rbf(td, 6, 5.0, freqs=None if fr is None
                                      else torch.from_numpy(fr)).numpy(),
            jax_radial.dimenet_bessel_rbf(jnp.asarray(d), 6, 5.0,
                                          freqs=None if fr is None else jnp.asarray(fr)),
            **BASIS_TOL)


# -- the model ---------------------------------------------------------------


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_energy_forces_and_second_order_gradients_match_jax(params, port_result, layout):
    model = jax_create_model("dimenetpp", remat=False, **KW, **LAYOUTS[layout])
    e_jax, f_jax, g_jax = _jax_reference(model, params, energy_batch())
    e, f, grads = port_result
    np.testing.assert_allclose(e, e_jax, **E_TOL)
    np.testing.assert_allclose(f, f_jax, **F_TOL)
    assert np.abs(f_jax).max() > 1e-2
    twin = load_flax_params(create_model("dimenetpp", device="cpu", **KW), g_jax)
    for name, w in twin.named_parameters():
        w = w.detach().numpy()
        assert np.abs(grads[name] - w).max() <= G_REL * np.abs(w).max() + 1e-7, name


def test_the_full_tree_loads_with_no_leaf_left(params):
    model = create_model("dimenetpp", device="cpu", **KW)
    load_flax_params(model, params)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert n_leaves == len(list(model.parameters()))
    extra = {"params": dict(params["params"], stray={"kernel": np.zeros((1, 1), np.float32)})}
    with pytest.raises(KeyError, match="stray"):
        load_flax_params(model, extra)


def test_unported_layouts_raise(params):
    """compact=False still raises; compute_dtype="bfloat16" (ported) builds
    and runs: finite float32 E and F, parameters kept in float32. A dtype
    neither package has raises."""
    with pytest.raises(NotImplementedError, match="dense"):
        create_model("dimenetpp", device="cpu", compact=False)
    model = load_flax_params(create_model("dimenetpp", device="cpu", compute_dtype="bfloat16",
                                          **KW), params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    out = forward(model, torch_batch(energy_batch()))
    for key in ("energy", "forces"):
        assert out[key].dtype == torch.float32 and bool(torch.isfinite(out[key]).all()), key
    with pytest.raises(NotImplementedError, match="float16"):
        create_model("dimenetpp", device="cpu", compute_dtype="float16")


def test_a_neighbour_tie_keeps_the_lower_indices(params):
    """Atom 0 at the origin, atoms 1-4 at distance 1 on the axes, atom 5
    farther: with K = 2 atom 0 keeps 1 and 2, as lax.top_k does."""
    f = energy_batch(b=1)
    f["pos"][0] = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0],
                            [0.3, 0.2, 1.7]], np.float32)
    kw = dict(KW, max_neighbors=2)
    nl = graph.neighbor_list(torch.from_numpy(f["pos"]), torch.from_numpy(f["node_mask"]),
                             5.0, 2)
    assert nl.idx[0, 0].tolist() == [1, 2]
    e_jax, f_jax, _ = _jax_reference(jax_create_model("dimenetpp", remat=False, **kw), params, f,
                                     grads=False)
    model = load_flax_params(create_model("dimenetpp", device="cpu", **kw), params)
    out = forward(model, torch_batch(f))
    np.testing.assert_allclose(out["energy"].numpy(), e_jax, **E_TOL)
    np.testing.assert_allclose(out["forces"].numpy(), f_jax, **F_TOL)
