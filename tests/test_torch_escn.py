"""The port's eSCN against the JAX package's, with the same weights.

eSCN at tests/models/test_energy_models.py's size (2 layers, l_max 3, m_max
2, 16 sphere channels, hidden 32, 16 edge channels, 8 neighbours, cutoff 6 Å,
32 sphere samples), two molecules of 9 and 7 atoms and a padding molecule.
The port's seeded weights are written out as a flax tree in the Pallas
layout (the inverse of load_flax_params' name map), converted to the XLA
layout with the JAX package's `param_convert.escn_params`, and run through
the JAX model on its XLA path (`use_pallas=False`); load_flax_params reads
the Pallas tree back (and the XLA-layout tree into the same weights).

* E within rtol 2e-4, F within rtol 2e-3 / atol 1e-6 of JAX's (the
  tolerances of tests/ops/test_escn_layer.py), for `use_pallas` "off" and
  "fused" (on the CPU "fused" runs the autograd Function over the plain
  versions);
* one train step's parameter gradients (energy L1 + 100 × forces L2-norm,
  configs/model/escn-oc.yaml) within 2e-3 × max |g| per tensor of jax.grad
  of the same loss, for both modes;
* the plain module cast to float64 gives the same E, F and gradients
  within the same tolerances;
* under a random rotation, relative to the outputs' largest magnitude
  (at random weights max |E| and max |F| are ~3e-5, below the JAX test's
  absolute tolerances): E invariant within 1e-4 (2.3e-5 measured); F
  co-rotating below F_ROT_REL (0.34 measured: the truncated grid, 2M+1
  longitudes in each edge's frame, aliases the activation's |m| > M
  products, so eSCN is equivariant only up to that aliasing, as the
  reference's SO3_Grid); the fused and plain modules' outputs on the rotated
  batch within 1e-5; a translation changes nothing beyond fp32 rounding;
  padded atoms and the padding molecule give exact zeros.
"""

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxMolBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models.param_convert import escn_params
from nabladft_tpu.train.losses import multitask_loss as jax_multitask_loss
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models.convert import _flax_path, load_flax_params
from nabladft_tpu_torch.train import seeded_generator
from nabladft_tpu_torch.train.losses import multitask_loss


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(num_layers=2, l_max=3, m_max=2, sphere_channels=16, hidden=32, edge_channels=16,
          max_neighbors=8, num_sphere_samples=32, cutoff=6.0, distance_resolution=0.25)
SPEC, COEF = {"energy": "l1", "forces": "l2norm"}, {"energy": 1.0, "forces": 100.0}
E_TOL, F_TOL, G_REL = dict(rtol=2e-4, atol=0.0), dict(rtol=2e-3, atol=1e-6), 2e-3
# under a rotation, relative to the largest magnitude: E (2.3e-5 measured)
# and F's co-rotation error (0.34 measured, the truncated grid's aliasing)
E_ROT_REL, F_ROT_REL = 1e-4, 0.5


def _fields(rng, n_atoms=(9, 7), max_atoms=12) -> dict:
    b = len(n_atoms) + 1
    f = dict(z=np.zeros((b, max_atoms), np.int32), pos=np.zeros((b, max_atoms, 3), np.float32),
             node_mask=np.zeros((b, max_atoms), bool), graph_mask=np.zeros((b,), bool),
             energy=np.zeros(b, np.float32), forces=np.zeros((b, max_atoms, 3), np.float32),
             mol_id=np.arange(b, dtype=np.int32))
    for i, n in enumerate(n_atoms):
        f["z"][i, :n] = rng.integers(1, 17, n)
        f["pos"][i, :n] = rng.uniform(-3, 3, (n, 3))
        f["node_mask"][i, :n] = f["graph_mask"][i] = True
        f["energy"][i] = rng.normal()
        f["forces"][i, :n] = rng.normal(size=(n, 3)) * 0.1
    return f


def _torch_batch(f: dict) -> MolBatch:
    return MolBatch(**{k: torch.from_numpy(v) for k, v in f.items()})


def _flax_tree(model) -> dict:
    """The module's parameters as a flax tree in the Pallas layout."""
    tree: dict = {}
    for name, p in model.named_parameters():
        path, transpose = _flax_path(name)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        arr = p.detach().numpy()
        node[path[-1]] = np.ascontiguousarray(arr.T) if transpose else arr.copy()
    return {"params": tree}


@pytest.fixture(scope="module")
def ref():
    f = _fields(np.random.default_rng(0))
    jb = JaxMolBatch(**f)
    seeded = create_model("escn", device="cpu", generator=seeded_generator(0), **KW)
    pallas = _flax_tree(seeded)
    xla = escn_params(pallas, "xla")
    model = jax_create_model("escn", use_pallas=False, remat=False, **KW)

    def loss(p):
        out = model.apply(p, jb)
        return jax_multitask_loss(out, jb, SPEC, COEF)["total"], out

    (lval, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(xla)
    g_pallas = escn_params(jax.device_get(grads), "pallas")
    return dict(fields=f, pallas=pallas, xla=xla, energy=np.asarray(out["energy"]),
                forces=np.asarray(out["forces"]), loss=float(lval), grads=g_pallas)


def _port(ref, **kw):
    model = create_model("escn", device="cpu", **dict(KW, **kw))
    return load_flax_params(model, ref["pallas"])


def _assert_grads_match(model, ref) -> None:
    """Each parameter's .grad within G_REL x max |g| of jax.grad's."""
    leaves = ref["grads"]["params"]
    for name, p in model.named_parameters():
        path, transpose = _flax_path(name)
        want = leaves
        for key in path:
            want = want[key]
        want = np.asarray(want).T if transpose else np.asarray(want)
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= G_REL * np.abs(want).max() + 1e-30, (name, err, np.abs(want).max())


@pytest.mark.parametrize("mode", ["off", "fused"])
def test_energy_and_forces_match_jax(ref, mode):
    with torch.no_grad():
        out = _port(ref, use_pallas=mode)(_torch_batch(ref["fields"]))
    np.testing.assert_allclose(out["energy"].numpy(), ref["energy"], **E_TOL)
    np.testing.assert_allclose(out["forces"].numpy(), ref["forces"], **F_TOL)


@pytest.mark.parametrize("mode", ["off", "fused"])
def test_train_step_gradients_match_jax(ref, mode):
    model = _port(ref, use_pallas=mode)
    batch = _torch_batch(ref["fields"])
    loss = multitask_loss(model(batch), batch, SPEC, COEF)["total"]
    loss.backward()
    assert loss.item() == pytest.approx(ref["loss"], rel=1e-4)
    _assert_grads_match(model, ref)


def test_float64_plain_module_matches_jax(ref):
    """The plain module cast to float64 (chip_smoke's reference for the
    gradients' rounding) runs and equals JAX's fp32 model as the fp32 port does."""
    model = _port(ref, use_pallas="off").double()
    f = _torch_batch(ref["fields"])
    batch = f.replace(**{k: getattr(f, k).double() for k in ("pos", "energy", "forces")})
    out = model(batch)
    assert out["energy"].dtype == out["forces"].dtype == torch.float64
    np.testing.assert_allclose(out["energy"].detach().numpy(), ref["energy"], **E_TOL)
    np.testing.assert_allclose(out["forces"].detach().numpy(), ref["forces"], **F_TOL)
    multitask_loss(out, batch, SPEC, COEF)["total"].backward()
    _assert_grads_match(model, ref)


def test_rotation_equivariance_and_padding(ref):
    model, plain = _port(ref, use_pallas="fused"), _port(ref, use_pallas="off")
    batch = _torch_batch(ref["fields"])
    q, _ = np.linalg.qr(np.random.default_rng(1).normal(size=(3, 3)))
    rot = torch.from_numpy(q * np.sign(np.linalg.det(q))).float()
    rotated = batch.replace(pos=batch.pos @ rot.T)
    with torch.no_grad():
        out = model(batch)
        out_r, out_pr = model(rotated), plain(rotated)
        out_t = model(batch.replace(pos=batch.pos + torch.tensor([1.7, -0.4, 2.2])))
    e, f = out["energy"], out["forces"]
    e_max, f_max = float(e.abs().max()), float(f.abs().max())
    assert float((out_r["energy"] - e).abs().max()) <= E_ROT_REL * e_max
    assert float((out_r["forces"] - f @ rot.T).abs().max()) <= F_ROT_REL * f_max
    assert float((out_r["energy"] - out_pr["energy"]).abs().max()) <= 1e-5 * e_max
    assert float((out_r["forces"] - out_pr["forces"]).abs().max()) <= 1e-5 * f_max
    np.testing.assert_allclose(out_t["energy"].numpy(), e.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(out_t["forces"].numpy(), f.numpy(), rtol=1e-4, atol=1e-8)
    pad = ~batch.node_mask
    assert float(f[pad].abs().max()) == 0.0
    assert float(e[2]) == 0.0


def test_xla_layout_and_bad_options_raise(ref):
    """An XLA-layout tree (the JAX package's `escn_params` of the Pallas
    one) loads into the same weights as the Pallas tree; bad options raise."""
    from_xla = load_flax_params(create_model("escn", device="cpu", **KW), ref["xla"])
    for (n, p), q in zip(from_xla.named_parameters(), _port(ref).parameters()):
        assert torch.equal(p, q), n
    with pytest.raises(NotImplementedError, match="float32"):
        create_model("escn", device="cpu", compute_dtype="bfloat16", **KW)
    with pytest.raises(ValueError, match="use_pallas"):
        create_model("escn", device="cpu", use_pallas="auto", **KW)
