"""The port's PaiNN against the JAX model on the same weights.

JAX params are carried across with `load_flax_params`; energies and forces
(-∂E/∂pos) must agree for use_pallas="off" and "fused" (JAX kernels in
interpret mode, the port's fused op on its plain CPU versions), at the
tolerances of tests/ops/test_painn_fused.py:198-199. Plus rotation
invariance of E and equivariance of F on the port alone.
"""

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models.base import forward as jax_forward
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models import create_model, forward
from nabladft_tpu_torch.models.convert import load_flax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(hidden=16, n_interactions=2, n_rbf=8, max_neighbors=7)
E_TOL = dict(rtol=2e-4, atol=1e-5)
F_TOL = dict(rtol=2e-3, atol=2e-4)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    b, a = 3, 10
    z = rng.integers(1, 9, (b, a)).astype(np.int32)
    pos = rng.uniform(-3, 3, (b, a, 3)).astype(np.float32)
    node_mask = np.ones((b, a), bool)
    node_mask[1, 8:] = False
    node_mask[2, 6:] = False
    z[~node_mask] = 0
    pos[~node_mask] = 0.0
    graph_mask = np.ones((b,), bool)
    return dict(z=z, pos=pos, node_mask=node_mask, graph_mask=graph_mask,
                energy=np.zeros(b, np.float32), forces=np.zeros((b, a, 3), np.float32),
                mol_id=np.arange(b, dtype=np.int32))


def _torch_batch(arrs):
    return MolBatch(**{k: torch.from_numpy(v) for k, v in arrs.items()})


@pytest.fixture(scope="module")
def arrays():
    return _arrays()


@pytest.fixture(scope="module")
def flax_params(arrays):
    model = jax_create_model("painn", **KW)
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), JaxBatch(**arrays)))


@pytest.fixture(scope="module", params=["off", "fused"])
def both(request, arrays, flax_params):
    """(JAX energy, forces), (port energy, forces) for one use_pallas mode."""
    mode = request.param
    jm = jax_create_model("painn", **KW, use_pallas=mode, remat=False)
    jout = jax.jit(lambda p, b: jax_forward(jm, p, b))(flax_params, JaxBatch(**arrays))
    tm = load_flax_params(create_model("painn", device="cpu", **KW, use_pallas=mode),
                          flax_params)
    tout = forward(tm, _torch_batch(arrays))
    return (np.asarray(jout["energy"]), np.asarray(jout["forces"])), (
        tout["energy"].numpy(), tout["forces"].numpy())


def test_energy_matches_jax(both):
    (je, _), (te, _) = both
    np.testing.assert_allclose(te, je, **E_TOL)


def test_forces_match_jax(both):
    (_, jf), (_, tf) = both
    np.testing.assert_allclose(tf, jf, **F_TOL)


def _rotation(seed=5):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


@pytest.mark.parametrize("mode", ["off", "fused"])
def test_rotation_invariance_and_equivariance(arrays, flax_params, mode):
    model = load_flax_params(create_model("painn", device="cpu", **KW, use_pallas=mode),
                             flax_params)
    rot = _rotation()
    out = forward(model, _torch_batch(arrays))
    rotated = dict(arrays, pos=(arrays["pos"] @ rot.T).astype(np.float32))
    out_r = forward(model, _torch_batch(rotated))
    np.testing.assert_allclose(out_r["energy"].numpy(), out["energy"].numpy(), **E_TOL)
    np.testing.assert_allclose(out_r["forces"].numpy(), out["forces"].numpy() @ rot.T, **F_TOL)
    assert (out["forces"].numpy()[~arrays["node_mask"]] == 0).all()


def test_fused_and_plain_share_parameter_layout(flax_params):
    off = create_model("painn", device="cpu", **KW)
    fused = create_model("painn", device="cpu", **KW, use_pallas="fused")
    assert [n for n, _ in off.named_parameters()] == [n for n, _ in fused.named_parameters()]
    assert fused.layers[0].message.filter_kernel.shape == (8, 48)


def test_load_flax_params_is_strict(flax_params):
    model = create_model("painn", device="cpu", **KW)
    extra = {"params": dict(flax_params["params"], stray={"kernel": np.zeros((1, 1))})}
    with pytest.raises(KeyError, match="stray"):
        load_flax_params(model, extra)
    missing = {"params": {k: v for k, v in flax_params["params"].items() if k != "energy_head"}}
    with pytest.raises(KeyError, match="energy_head"):
        load_flax_params(model, missing)


def test_seeded_init_is_reproducible():
    from nabladft_tpu_torch.train import seeded_generator

    a = create_model("painn", device="cpu", generator=seeded_generator(7), **KW)
    b = create_model("painn", device="cpu", generator=seeded_generator(7), **KW)
    for (_, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y)


def test_model_constructor_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("painn", **KW)


def test_predict_step_skips_the_weight_gradient(arrays, flax_params, monkeypatch):
    """The predict engine freezes the weights, so each layer's kernel-B call
    runs without its weight-gradient stage (forces need d/dpos only)."""
    from nabladft_tpu_torch.ops import painn_fused as pf
    from nabladft_tpu_torch.train import Trainer

    seen = []
    real = pf.painn_bwd

    def spy(*args, need_gw=True):
        seen.append(need_gw)
        return real(*args, need_gw=need_gw)

    monkeypatch.setattr(pf, "painn_bwd", spy)
    model = load_flax_params(create_model("painn", device="cpu", **KW, use_pallas="fused"),
                             flax_params)
    out = Trainer(model, "cpu")._predict_step(_torch_batch(arrays))
    assert seen == [False] * KW["n_interactions"]
    assert torch.isfinite(out["forces"]).all()
