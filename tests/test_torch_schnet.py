"""The port's SchNet against the JAX model on the same weights.

JAX params are carried across with `load_flax_params`; energies and forces
(-∂E/∂pos) must agree for use_pallas="off" and "fused" (JAX kernels in
interpret mode, the port's fused ops on their plain CPU versions), with and
without atom reference energies, within rtol 1e-5 for E and 2e-4 for F
(tests/ops/test_schnet_fused.py:49-62). Rotation invariance of E and
equivariance of F on the port alone. One train step's parameter gradients
(the port's `pallas` route through E-H's plain versions, and its
`surrogate` and `direct` routes) against the JAX engine's surrogate with
force_grads="pallas", within rtol 5e-3 (tests/train/test_surrogate_grads.py).
"""

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models.base import forward as jax_forward
from nabladft_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models import create_model, forward
from nabladft_tpu_torch.models.convert import load_flax_params
from nabladft_tpu_torch.train import Trainer, TrainerConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(hidden=16, n_interactions=2, n_rbf=12, max_neighbors=7)
E_TOL = dict(rtol=1e-5, atol=1e-5)
F_TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-5)
LOSSES = dict(loss_specs={"energy": "mse", "forces": "mse"},
              loss_coefs={"energy": 1.0, "forces": 2.0})


def _arrays(seed=0, b=4, a=9):
    rng = np.random.default_rng(seed)
    z = rng.integers(1, 9, (b, a)).astype(np.int32)
    pos = rng.uniform(-2.5, 2.5, (b, a, 3)).astype(np.float32)
    node_mask = np.ones((b, a), bool)
    node_mask[1, 7:] = False
    node_mask[2, 5:] = False
    z[~node_mask] = 0
    pos[~node_mask] = 0.0
    graph_mask = np.ones((b,), bool)
    graph_mask[3] = False  # a padding molecule
    forces = (rng.normal(size=(b, a, 3)) * node_mask[..., None]).astype(np.float32)
    return dict(z=z, pos=pos, node_mask=node_mask, graph_mask=graph_mask,
                energy=rng.normal(size=b).astype(np.float32), forces=forces,
                mol_id=np.arange(b, dtype=np.int32))


def _tb(arrs):
    return MolBatch(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()})


def _port(params, mode="off", **kw):
    return load_flax_params(create_model("schnet", device="cpu", use_pallas=mode, **KW, **kw),
                            params)


@pytest.fixture(scope="module")
def arrays():
    return _arrays()


@pytest.fixture(scope="module")
def flax_params(arrays):
    model = jax_create_model("schnet", **KW)
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), JaxBatch(**arrays)))


@pytest.fixture(scope="module", params=[("off", False), ("fused", False), ("fused", True)],
                ids=["off", "fused", "fused-atomrefs"])
def both(request, arrays, flax_params):
    """(JAX energy, forces), (port energy, forces) for one use_pallas mode,
    with or without atom reference energies."""
    mode, refs = request.param
    jm = jax_create_model("schnet", **KW, use_pallas=mode, use_atomrefs=refs, remat=False)
    jout = jax.jit(lambda p, b: jax_forward(jm, p, b))(flax_params, JaxBatch(**arrays))
    tout = forward(_port(flax_params, mode, use_atomrefs=refs), _tb(arrays))
    return (np.asarray(jout["energy"]), np.asarray(jout["forces"])), (
        tout["energy"].numpy(), tout["forces"].numpy())


def test_energy_matches_jax(both):
    (je, _), (te, _) = both
    np.testing.assert_allclose(te, je, **E_TOL)


def test_forces_match_jax(both):
    (_, jf), (_, tf) = both
    np.testing.assert_allclose(tf, jf, **F_TOL)


def test_atomrefs_add_the_reference_energies(arrays, flax_params):
    from nabladft_tpu_torch.data.atomref import atomrefs_for

    batch = _tb(arrays)
    e0 = forward(_port(flax_params, "fused"), batch)["energy"]
    e1 = forward(_port(flax_params, "fused", use_atomrefs=True), batch)["energy"]
    refs = torch.tensor(atomrefs_for(100), dtype=torch.float32)[batch.z.long()]
    want = (refs * batch.node_mask).sum(dim=1)
    np.testing.assert_allclose((e1 - e0).numpy(), want.numpy(), rtol=1e-6)
    assert float(want.abs().min()) > 1.0  # the offsets are large (Eh per atom)


def _rotation(seed=5):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


@pytest.mark.parametrize("mode", ["off", "fused"])
def test_rotation_invariance_and_equivariance(arrays, flax_params, mode):
    model = _port(flax_params, mode)
    rot = _rotation()
    out = forward(model, _tb(arrays))
    rotated = dict(arrays, pos=(arrays["pos"] @ rot.T).astype(np.float32))
    out_r = forward(model, _tb(rotated))
    np.testing.assert_allclose(out_r["energy"].numpy(), out["energy"].numpy(),
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(out_r["forces"].numpy(), out["forces"].numpy() @ rot.T,
                               rtol=2e-3, atol=1e-4)
    assert (out["forces"].numpy()[~arrays["node_mask"]] == 0).all()


def test_parameter_layout_is_the_flax_tree(flax_params):
    off = create_model("schnet", device="cpu", **KW)
    fused = create_model("schnet", device="cpu", **KW, use_pallas="fused")
    assert [n for n, _ in off.named_parameters()] == [n for n, _ in fused.named_parameters()]
    assert fused.filter_0_w1.shape == (12, 16) and fused.filter_1_b2.shape == (1, 16)
    model = create_model("schnet", device="cpu", **KW)
    extra = {"params": dict(flax_params["params"], stray={"kernel": np.zeros((1, 1))})}
    with pytest.raises(KeyError, match="stray"):
        load_flax_params(model, extra)


def test_seeded_init_is_reproducible_and_flax_shaped():
    from nabladft_tpu_torch.train import seeded_generator

    a = create_model("schnet", device="cpu", generator=seeded_generator(7), **KW)
    b = create_model("schnet", device="cpu", generator=seeded_generator(7), **KW)
    for (_, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y)
    assert (a.filter_0_b1 == 0).all() and (a.filter_0_b2 == 0).all()
    # truncated lecun-normal: std sqrt(1 / fan_in), nothing beyond 2 std
    bound = 2.0 / np.sqrt(KW["n_rbf"]) / 0.87962566103423978
    assert float(a.filter_0_w1.detach().abs().max()) <= bound + 1e-6


@pytest.mark.parametrize("kw", [dict(compute_dtype="float16"), dict(use_pallas="train")])
def test_unsupported_options_raise(kw):
    with pytest.raises((NotImplementedError, ValueError)):
        create_model("schnet", device="cpu", **dict(KW, **kw))


@pytest.fixture(scope="module")
def jax_surrogate(arrays):
    """JAX pallas-route gradients, losses and initial params on one batch."""
    model = jax_create_model("schnet", **KW, remat=False)
    trainer = JaxTrainer(model, JaxConfig(schedule="constant", n_dp=1, force_grads="pallas",
                                          **LOSSES))
    batch = JaxBatch(**arrays)
    trainer.init_state(batch)
    params = jax.device_get(trainer.state.params)
    # jitted once: the interpret-mode kernels run op by op otherwise
    grads, losses, _ = jax.jit(lambda p, b: trainer._surrogate_grads(p, b, None))(
        trainer.state.params, batch)
    twin = _port(params)
    load_flax_params(twin, jax.device_get(grads))
    return params, {n: p.detach().clone() for n, p in twin.named_parameters()}, {
        k: float(v) for k, v in losses.items()}


@pytest.mark.parametrize("route,mode", [("pallas", "fused"), ("surrogate", "off"),
                                        ("direct", "off")])
def test_train_step_grads_match_jax_surrogate(arrays, jax_surrogate, route, mode):
    params, g_jax, l_jax = jax_surrogate
    model = _port(params, mode)
    trainer = Trainer(model, "cpu", TrainerConfig(schedule="constant", force_grads=route,
                                                  **LOSSES))
    losses = trainer._compute_grads(_tb(arrays))
    for k in ("energy", "forces", "total"):
        assert float(losses[k]) == pytest.approx(l_jax[k], rel=1e-4), k
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g_jax[name].numpy(), **GRAD_TOL,
                                   err_msg=name)


def test_pallas_route_runs_g_h_and_f_without_weight_gradient(arrays, jax_surrogate,
                                                             monkeypatch):
    """Per layer: G and H once each (the dual pass, H with the weight
    gradient), E once and F once without its weight-gradient stage (the
    force pass holds the weights fixed)."""
    from nabladft_tpu_torch.ops import schnet_fused as sf

    calls = []
    for name in ("schnet_fwd", "schnet_bwd", "schnet_dual_fwd", "schnet_dual_bwd"):
        real = getattr(sf, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("need_gw")))
            return _real(*args, **kw)

        monkeypatch.setattr(sf, name, spy)
    model = _port(jax_surrogate[0], "fused")
    Trainer(model, "cpu", TrainerConfig(force_grads="pallas", **LOSSES))._compute_grads(
        _tb(arrays))
    n = KW["n_interactions"]
    assert calls.count(("schnet_fwd", None)) == n
    assert calls.count(("schnet_bwd", False)) == n
    assert calls.count(("schnet_dual_fwd", None)) == n
    assert calls.count(("schnet_dual_bwd", True)) == n
    assert len(calls) == 4 * n


def test_dual_message_refuses_a_weight_tangent(arrays, jax_surrogate):
    import torch.autograd.forward_ad as fwAD

    from nabladft_tpu_torch.models.schnet import _dual_message

    model = _port(jax_surrogate[0], "fused")
    batch = _tb(arrays)
    with fwAD.dual_level():
        feats = model.features(batch.replace(pos=fwAD.make_dual(batch.pos,
                                                               torch.ones_like(batch.pos))))
        w1, b1, w2, b2 = model.filter(0)
        w1_dual = fwAD.make_dual(w1.detach(), torch.ones_like(w1))
        xin = torch.zeros(*batch.z.shape, KW["hidden"])
        with pytest.raises(ValueError, match="filter weights"):
            _dual_message(feats, xin, (w1_dual, b1, w2, b2))


def test_fused_features_are_zero_off_the_edges_and_rbf_is_not(arrays, flax_params):
    model = _port(flax_params, "fused")
    feats = model.features(_tb(arrays))
    dead = feats["envf"] == 0
    assert dead.any() and (feats["envp"][dead] == 0).all()
    assert (feats["rbf"][dead].abs().sum(dim=-1) > 0).all()
