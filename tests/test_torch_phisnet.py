"""The port's PhiSNet against the JAX package's, with the same weights.

PhiSNet at a small width (order 2, 8 features, 8 basis functions, two
modules) with the energy head on. The weights are the port's, seeded, as
the flax tree (`flax_params_of`); that tree has the paths and shapes of
the JAX model's own `model.init` (evaluated abstractly), and
`load_flax_params` uses every leaf of it. The JAX reference runs with
remat off (the same values); its outputs, forces and matrix-loss gradients
come from one jitted function.

* `ResidualStack`, `PairMixing` and `PhiSNetModule` alone, on seeded inputs
  and the tree's own sub-trees: within 1e-5 × max |out|;
* the whole model's H, S and core within 1e-4 × max |matrix| (fp32 sums in
  another order over the Expansion's paths), E within rtol 2e-4 / atol
  1e-5, F = -∂E/∂pos within rtol 2e-3 / atol 2e-4;
* the parameter gradients of the H + S + core rmse_mae loss, the port with
  remat on, within 1e-3 × max |g| per tensor of `jax.grad`'s (zero on the
  energy head, which the loss does not reach);
* SE(3) covariance H(R·pos) = T(R) H T(R)ᵀ (and S, core), symmetry, and
  S unchanged in the blocks of the other atoms when one atom's species
  changes (the environment-independent branch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxMolBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models import phisnet as jax_phisnet
from nabladft_tpu.train.losses import multitask_loss as jax_multitask_loss
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models import create_model, forward
from nabladft_tpu_torch.models import phisnet
from nabladft_tpu_torch.models.convert import flax_params_of, load_flax_params
from nabladft_tpu_torch.ops import so3
from nabladft_tpu_torch.train.losses import multitask_loss


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ORBITALS = {1: (0, 0, 1), 6: (0, 0, 0, 1, 1, 2), 7: (0, 0, 0, 1, 1, 2), 8: (0, 0, 0, 1, 1, 2)}
NORB = {z: sum(2 * l + 1 for l in o) for z, o in ORBITALS.items()}
KW = dict(order=2, num_features=8, num_basis_functions=8, num_modules=2, orbitals=ORBITALS)
MATS = ("hamiltonian", "overlap", "core")
SPEC = {m: "rmse_mae" for m in MATS}
COEF = {m: 1.0 for m in MATS}
M_REL, G_REL, PART_REL = 1e-4, 1e-3, 1e-5
E_TOL = dict(rtol=2e-4, atol=1e-5)
F_TOL = dict(rtol=2e-3, atol=2e-4)


def hamiltonian_batch(rng, mols=((6, 1, 1, 8), (8, 1, 1)), max_atoms=5, o_max=40) -> dict:
    """numpy fields of a padded Hamiltonian batch (Bohr) with symmetric H,
    S and core targets, and one padding molecule."""
    b = len(mols) + 1
    f = dict(z=np.zeros((b, max_atoms), np.int32), pos=np.zeros((b, max_atoms, 3), np.float32),
             node_mask=np.zeros((b, max_atoms), bool), graph_mask=np.zeros((b,), bool),
             orb_mask=np.zeros((b, o_max), bool), energy=np.zeros(b, np.float32),
             forces=np.zeros((b, max_atoms, 3), np.float32), mol_id=np.arange(b, dtype=np.int32),
             **{m: np.zeros((b, o_max, o_max), np.float32) for m in MATS})
    for i, zs in enumerate(mols):
        n, no = len(zs), sum(NORB[q] for q in zs)
        f["z"][i, :n] = zs
        f["pos"][i, :n] = rng.uniform(-2.5, 2.5, (n, 3))
        f["node_mask"][i, :n] = f["graph_mask"][i] = True
        f["orb_mask"][i, :no] = True
        f["energy"][i] = rng.normal()
        for m in MATS:
            x = rng.normal(size=(no, no)).astype(np.float32)
            f[m][i, :no, :no] = x + x.T
    return f


def torch_batch(f: dict) -> MolBatch:
    return MolBatch(**{k: torch.from_numpy(np.array(v)) for k, v in f.items()})


def orbital_rotation(zs, rot: torch.Tensor, o_max: int) -> torch.Tensor:
    """Block-diagonal Wigner-D over one molecule's orbital shells."""
    ds = [d[0] for d in so3.wigner_d(rot[None].double(), 2)]
    t = torch.eye(o_max, dtype=torch.float64)
    off = 0
    for z in zs:
        for l in ORBITALS[int(z)]:
            k = 2 * l + 1
            t[off:off + k, off:off + k] = ds[l]
            off += k
    return t


@pytest.fixture(scope="module")
def ref():
    f = hamiltonian_batch(np.random.default_rng(0))
    jb = JaxMolBatch(**f)
    model = jax_create_model("phisnet", remat=False, predict_energy=True, **KW)
    # the port's seeded weights as the flax tree (no JAX init to compile)
    params = flax_params_of(create_model("phisnet", device="cpu",
                                         generator=torch.Generator().manual_seed(0),
                                         **dict(KW, predict_energy=True)))
    init = jax.eval_shape(model.init, jax.random.PRNGKey(0), jb)

    @jax.jit
    def outputs(params, pos):
        def e_sum(pos):
            out = model.apply(params, jb.replace(pos=pos))
            return jnp.where(jb.graph_mask, out["energy"], 0.0).sum(), out

        (_, out), g = jax.value_and_grad(e_sum, has_aux=True)(pos)
        loss, grads = jax.value_and_grad(
            lambda p: jax_multitask_loss(model.apply(p, jb), jb, SPEC, COEF)["total"])(params)
        return out, -g, loss, grads

    out, forces, loss, grads = jax.device_get(outputs(params, jb.pos))
    return dict(fields=f, params=params, init=init, out=out, forces=forces, loss=float(loss),
                grads=grads)


def tree_shapes(tree):
    """Each leaf's path in a flax tree -> its shape."""
    return {jax.tree_util.keystr(path): tuple(np.shape(x))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port(ref, **kw):
    model = create_model("phisnet", device="cpu", **dict(KW, predict_energy=True, **kw))
    return load_flax_params(model, ref["params"])


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), np.abs(got - want).max()


def _xs(rng, lead, c=8, order=2):
    return [rng.normal(size=(*lead, c, 2 * l + 1)).astype(np.float32) for l in range(order + 1)]


def test_the_tree_is_jax_init_tree_and_loads_whole(ref):
    """The port's tree has the paths and shapes of JAX's `model.init` tree,
    and loading it uses every leaf (a port-only parameter, or a JAX leaf the
    port lacks, fails here)."""
    assert tree_shapes(ref["params"]) == tree_shapes(dict(ref["init"]))
    model = _port(ref)
    assert len(jax.tree_util.tree_leaves(ref["init"])) == len(list(model.parameters()))


def test_residual_stack_matches_jax(ref):
    rng = np.random.default_rng(1)
    xs = _xs(rng, (2, 5))
    sub = ref["params"]["params"]["res_over_ii"]
    want = jax_phisnet.ResidualStack(2, 8).apply({"params": sub}, [jnp.asarray(x) for x in xs])
    mod = load_flax_params(phisnet.ResidualStack(2, 8, 2), sub)
    with torch.no_grad():
        got = mod([torch.from_numpy(x) for x in xs])
    for g, w in zip(got, want):
        _close(g, w, PART_REL)


def test_pair_mixing_matches_jax(ref):
    rng = np.random.default_rng(2)
    fi, fj = _xs(rng, (2, 5, 5)), _xs(rng, (2, 5, 5))
    rbf = rng.uniform(size=(2, 5, 5, 8)).astype(np.float32)
    sub = ref["params"]["params"]["mix_ij"]
    want = jax_phisnet.PairMixing(8).apply({"params": sub}, [jnp.asarray(x) for x in fi],
                                           [jnp.asarray(x) for x in fj], jnp.asarray(rbf))
    mod = load_flax_params(phisnet.PairMixing(8, 8, 2), sub)
    with torch.no_grad():
        got = mod([torch.from_numpy(x) for x in fi], [torch.from_numpy(x) for x in fj],
                  torch.from_numpy(rbf))
    for g, w in zip(got, want):
        _close(g, w, PART_REL)


def test_module_matches_jax(ref):
    rng = np.random.default_rng(3)
    xs = _xs(rng, (2, 5))
    rbf = rng.uniform(size=(2, 5, 5, 8)).astype(np.float32)
    adj = rng.uniform(size=(2, 5, 5)) < 0.7
    np.einsum("bii->bi", adj)[:] = False
    unit = rng.normal(size=(2, 5, 5, 3))
    unit = (unit / np.linalg.norm(unit, axis=-1, keepdims=True)).astype(np.float32)
    sh = so3.real_sph_harm(torch.from_numpy(unit), 2, normalized=False).numpy()
    sh = [sh[..., l * l:(l + 1) * (l + 1)] for l in range(3)]
    sub = ref["params"]["params"]["module_0"]
    want = jax_phisnet.PhiSNetModule(2, 8).apply(
        {"params": sub}, [jnp.asarray(x) for x in xs], jnp.asarray(rbf),
        [jnp.asarray(s) for s in sh], jnp.asarray(adj))
    mod = load_flax_params(phisnet.PhiSNetModule(2, 8, 8), sub)
    with torch.no_grad():
        got = mod([torch.from_numpy(x) for x in xs], torch.from_numpy(rbf),
                  [torch.from_numpy(s) for s in sh], torch.from_numpy(adj))
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            _close(g, w, PART_REL)


def test_matrices_energy_and_forces_match_jax(ref):
    out = forward(_port(ref), torch_batch(ref["fields"]))
    for m in MATS:
        _close(out[m], ref["out"][m], M_REL)
    np.testing.assert_allclose(out["energy"].numpy(), ref["out"]["energy"], **E_TOL)
    np.testing.assert_allclose(out["forces"].numpy(), ref["forces"], **F_TOL)
    assert np.abs(ref["forces"]).max() > 1e-3  # the forces are not trivially zero


def test_matrix_loss_gradients_match_jax(ref):
    model = _port(ref, remat=True)
    batch = torch_batch(ref["fields"])
    loss = multitask_loss(model(batch), batch, SPEC, COEF)["total"]
    loss.backward()
    assert float(loss.detach()) == pytest.approx(ref["loss"], rel=1e-4)
    twin = load_flax_params(create_model("phisnet", device="cpu", predict_energy=True, **KW),
                            ref["grads"])
    want = dict(twin.named_parameters())
    for name, p in model.named_parameters():
        w = want[name].detach().numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        if name.startswith("energy_"):
            assert not np.any(w) and not np.any(g), name
            continue
        assert np.abs(g - w).max() <= G_REL * np.abs(w).max() + 1e-7, name


def rotation(seed: int = 5) -> torch.Tensor:
    """A seeded proper rotation."""
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return torch.from_numpy(q.astype(np.float32))


def test_matrices_rotate_with_the_orbitals(ref):
    model = _port(ref)
    batch = torch_batch(ref["fields"])
    rot = rotation()
    with torch.no_grad():
        out = model(batch)
        out_r = model(batch.replace(pos=batch.pos @ rot.T))
    for m in MATS:
        mat, mat_r = out[m].double(), out_r[m].double()
        scale = float(mat.abs().max())
        assert torch.equal(out[m], out[m].transpose(-1, -2)), m
        for k in range(2):
            zs = batch.z[k][batch.node_mask[k]].tolist()
            t = orbital_rotation(zs, rot, mat.shape[-1])
            err = float((mat_r[k] - t @ mat[k] @ t.T).abs().max())
            assert err <= 1e-5 * scale, (m, k, err)


def test_overlap_ignores_a_neighbours_species(ref):
    """The atoms of the first molecule: C H H O. O -> N keeps every
    element's orbital layout; S's blocks among C, H, H stay the same, H's
    change."""
    model = _port(ref)
    batch = torch_batch(ref["fields"])
    z2 = batch.z.clone()
    z2[0, 3] = 7
    with torch.no_grad():
        out, out2 = model(batch), model(batch.replace(z=z2))
    n = NORB[6] + 2 * NORB[1]  # the orbitals of C, H, H
    s, s2 = out["overlap"][0, :n, :n], out2["overlap"][0, :n, :n]
    assert torch.allclose(s, s2, rtol=0, atol=1e-6 * float(s.abs().max()))
    h, h2 = out["hamiltonian"][0, :n, :n], out2["hamiltonian"][0, :n, :n]
    assert float((h - h2).abs().max()) > 1e-3 * float(h.abs().max())
