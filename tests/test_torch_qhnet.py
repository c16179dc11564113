"""The port's QHNet against the JAX package's, with the same weights.

QHNet at a small width and the full LMAX 4 (hidden 8, bottle_hidden 4, two
ConvNet layers, start_layer 0 so one Self and one Pair layer, 8 RBF), with
the same weights in both packages: the port's seeded weights written out as
a flax tree by the inverse of load_flax_params' name map, which
load_flax_params reads back. The JAX reference runs the einsum path with
remat off (the same values); only its forward is jitted, once for the
module (no JAX init, no model-level jax.grad: the gradients are held
against JAX where the kernels are, in tests/test_torch_qhnet_tp.py).

* `use_pallas` "off" and "fused" give H within 1e-4 × max |H| of JAX's
  (fp32 sums over 65 paths and 2 layers in another order), and the same
  Hamiltonian loss and metrics;
* block space (`assemble_matrix=False`) equals the full matrix in the loss
  and the metrics;
* one train step's parameter gradients (full-matrix rmse_mae), "fused"
  against "off", within 1e-3 × max |g| per tensor; remat changes none;
* SE(3) covariance H(R·pos) = T(R) H T(R)ᵀ, translation invariance,
  symmetry, zeros outside the orbital mask.
"""

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxMolBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.train.losses import multitask_loss as jax_multitask_loss
from nabladft_tpu.train.metrics import batch_metric_sums as jax_metric_sums
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models.convert import _flax_path, load_flax_params
from nabladft_tpu_torch.ops import so3
from nabladft_tpu_torch.train import seeded_generator
from nabladft_tpu_torch.train.losses import multitask_loss
from nabladft_tpu_torch.train.metrics import batch_metric_sums


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ORBITALS = {1: (0, 0, 1), 6: (0, 0, 0, 1, 1, 2), 8: (0, 0, 0, 1, 1, 2)}
NORB = {z: sum(2 * l + 1 for l in o) for z, o in ORBITALS.items()}
KW = dict(hidden=8, bottle_hidden=4, num_layers=2, rbf_dim=8, start_layer=0, orbitals=ORBITALS)
H_REL, G_REL = 1e-4, 1e-3
SPEC, COEF = {"hamiltonian": "rmse_mae"}, {"hamiltonian": 1.0}


def _batch(rng, mols=((6, 1, 1, 8), (8, 1, 1)), max_atoms=6, o_max=40) -> dict:
    """numpy fields of a padded Hamiltonian batch (one padding molecule)."""
    b = len(mols) + 1
    f = dict(z=np.zeros((b, max_atoms), np.int32), pos=np.zeros((b, max_atoms, 3), np.float32),
             node_mask=np.zeros((b, max_atoms), bool), graph_mask=np.zeros((b,), bool),
             orb_mask=np.zeros((b, o_max), bool), hamiltonian=np.zeros((b, o_max, o_max), np.float32),
             energy=np.zeros(b, np.float32), forces=np.zeros((b, max_atoms, 3), np.float32),
             mol_id=np.arange(b, dtype=np.int32))
    for i, zs in enumerate(mols):
        n, no = len(zs), sum(NORB[q] for q in zs)
        f["z"][i, :n] = zs
        f["pos"][i, :n] = rng.uniform(-2, 2, (n, 3))
        f["node_mask"][i, :n] = f["graph_mask"][i] = True
        f["orb_mask"][i, :no] = True
        m = rng.normal(size=(no, no)).astype(np.float32)
        f["hamiltonian"][i, :no, :no] = m + m.T
    return f


def _torch_batch(f: dict) -> MolBatch:
    return MolBatch(**{k: torch.from_numpy(v) for k, v in f.items()})


def _flax_tree(model) -> dict:
    """The module's parameters as a flax variable tree (numpy leaves)."""
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
    f = _batch(np.random.default_rng(0))
    jb = JaxMolBatch(**f)
    seeded = create_model("qhnet", device="cpu", generator=seeded_generator(0), **KW)
    variables = _flax_tree(seeded)
    model = jax_create_model("qhnet", use_pallas=False, remat=False, **KW)
    out = jax.jit(model.apply)(variables, jb)
    return dict(fields=f, params=variables, h=np.asarray(out["hamiltonian"]),
                loss=float(jax_multitask_loss(out, jb, SPEC, COEF)["total"]),
                sums={k: float(v) for k, v in jax_metric_sums(out, jb).items()})


def _port(ref, **kw):
    model = create_model("qhnet", device="cpu", **dict(KW, **kw))
    return load_flax_params(model, ref["params"])


def _assert_h(got, want):
    assert np.abs(got - want).max() <= H_REL * np.abs(want).max()


@pytest.mark.parametrize("mode", ["off", "fused"])
def test_hamiltonian_matches_jax(ref, mode):
    batch = _torch_batch(ref["fields"])
    with torch.no_grad():
        out = _port(ref, use_pallas=mode)(batch)
    _assert_h(out["hamiltonian"].numpy(), ref["h"])
    loss = float(multitask_loss(out, batch, SPEC, COEF)["total"])
    assert loss == pytest.approx(ref["loss"], rel=1e-5)
    sums = {k: float(v) for k, v in batch_metric_sums(out, batch).items()}
    assert sums["hamiltonian/count"] == ref["sums"]["hamiltonian/count"]
    assert sums["hamiltonian/abs_sum"] == pytest.approx(ref["sums"]["hamiltonian/abs_sum"],
                                                        rel=1e-5)


def test_block_space_equals_full_matrix(ref):
    batch = _torch_batch(ref["fields"])
    with torch.no_grad():
        full = _port(ref)(batch)
        blk = _port(ref, assemble_matrix=False)(batch)
    l_full = float(multitask_loss(full, batch, SPEC, COEF)["total"])
    l_blk = float(multitask_loss(blk, batch, SPEC, COEF)["total"])
    assert l_blk == pytest.approx(l_full, rel=1e-5)
    s_full, s_blk = batch_metric_sums(full, batch), batch_metric_sums(blk, batch)
    assert float(s_blk["hamiltonian/abs_sum"]) == pytest.approx(
        float(s_full["hamiltonian/abs_sum"]), rel=1e-5)
    assert float(s_blk["hamiltonian/count"]) == float(s_full["hamiltonian/count"])


def _grads(model, batch):
    multitask_loss(model(batch), batch, SPEC, COEF)["total"].backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def off_grads(ref):
    return _grads(_port(ref, use_pallas="off", remat=False), _torch_batch(ref["fields"]))


@pytest.mark.parametrize("mode,remat", [("fused", True), ("fused", False), ("off", True)])
def test_train_step_gradients_match_the_plain_path(ref, off_grads, mode, remat):
    got = _grads(_port(ref, use_pallas=mode, remat=remat), _torch_batch(ref["fields"]))
    assert set(got) == set(off_grads)
    for n, g in got.items():
        want = off_grads[n]
        assert float((g - want).abs().max()) <= G_REL * float(want.abs().max()) + 1e-30, n
    assert float(got["rbf.gamma"].abs()) > 0  # the basis' γ trains through h_r


def _orbital_rotation(zs, rot, o_max):
    ds = so3.wigner_d(rot[None], 2)
    t = torch.eye(o_max, dtype=rot.dtype)
    off = 0
    for z in zs:
        for l in ORBITALS[int(z)]:
            t[off:off + 2 * l + 1, off:off + 2 * l + 1] = ds[l][0]
            off += 2 * l + 1
    return t


def test_rotation_covariance_and_translation_invariance(ref):
    model = _port(ref, use_pallas="fused")
    batch = _torch_batch(ref["fields"])
    q, _ = np.linalg.qr(np.random.default_rng(1).normal(size=(3, 3)))
    rot = torch.from_numpy(q * np.sign(np.linalg.det(q))).float()
    with torch.no_grad():
        h = model(batch)["hamiltonian"]
        h_rot = model(batch.replace(pos=batch.pos @ rot.T))["hamiltonian"]
        h_tr = model(batch.replace(pos=batch.pos + torch.tensor([1.0, -2.0, 0.5])))["hamiltonian"]
    scale = float(h.abs().max())
    for b in range(2):
        t = _orbital_rotation(batch.z[b][batch.node_mask[b]].tolist(), rot, h.shape[-1])
        assert float((h_rot[b] - t @ h[b] @ t.T).abs().max()) <= 1e-4 * scale
    assert float((h_tr - h).abs().max()) <= 1e-4 * scale


def test_symmetric_and_zero_outside_the_orbital_mask(ref):
    with torch.no_grad():
        h = _port(ref)(_torch_batch(ref["fields"]))["hamiltonian"]
    torch.testing.assert_close(h, h.transpose(-1, -2), rtol=0, atol=1e-6)
    om = torch.from_numpy(ref["fields"]["orb_mask"])
    assert float(h[~(om[:, :, None] & om[:, None, :])].abs().max()) == 0.0


def test_ref_compat_and_bad_modes_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model("qhnet", device="cpu", ref_compat=True, **KW)
    with pytest.raises(ValueError, match="off|fused"):
        create_model("qhnet", device="cpu", use_pallas="auto", **KW)
