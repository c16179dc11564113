"""The port's EquiformerV2 against the JAX package's, with the same weights.

EquiformerV2 at tests/models/test_energy_models.py's size (2 layers, l_max 3,
m_max 2, 16 sphere channels, 2 heads × 4 value and 8 alpha channels, FFN 16,
16 edge channels, 16 Gaussians, 8 neighbours, cutoff 6 Å), two molecules of
9 and 7 atoms and a padding molecule. The port's seeded weights are written
out as a flax tree in the Pallas layout (the inverse of load_flax_params'
name map), converted to the XLA layout with the JAX package's
`param_convert.eqv2_params`, and run through the JAX model on its XLA path
(`use_pallas=False`, jitted once per reference); load_flax_params reads the
Pallas tree back (and the XLA-layout tree into the same weights).

* In eval mode (no dropout), for `use_pallas` "off" and "fused" (on the CPU
  "fused" runs the autograd Function over the plain versions): E within
  rtol 2e-4 and F within 2e-3 × max |F| of JAX's; one train step's
  parameter gradients (energy L1 + 100 × forces L2-norm,
  configs/model/equiformer_v2.yaml) within 2e-3 × max |g| per tensor of
  jax.grad of the same loss. The plain module in float64 holds the same.
* In train mode, with the same seeded numpy keep masks fed to both sides
  (the port's `bernoulli_keep`, JAX's `jax.random.bernoulli`; the JAX model
  built `deterministic=False`, as the JAX train job builds it): E, F and
  the gradients within the same tolerances.
* Under a random rotation E and F move by the truncated grid's aliasing
  (2M+1 longitudes in each edge's frame: the model's own, JAX's XLA model
  moves by the same 1.6 % of max |E| and 3.5 % of max |F| at this size and
  seed), held below E_ROT × max |E| and F_ROT × max |F|; the fused and
  plain modules' outputs on the rotated batch agree within 1e-5 of their
  largest magnitude; padded atoms and the padding molecule give exact zeros.
"""

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxMolBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models.param_convert import eqv2_params
from nabladft_tpu.train.losses import multitask_loss as jax_multitask_loss
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models.convert import _flax_path, load_flax_params
from nabladft_tpu_torch.train import seeded_generator
from nabladft_tpu_torch.train.losses import multitask_loss
from tests.test_torch_escn import _fields, _flax_tree, _torch_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(num_layers=2, l_max=3, m_max=2, sphere_channels=16, attn_alpha_channels=8, num_heads=2,
          attn_value_channels=4, ffn_hidden_channels=16, edge_channels=16, num_distance_basis=16,
          cutoff=6.0, max_neighbors=8)
CO = KW["num_heads"] * KW["attn_value_channels"]
SPEC, COEF = {"energy": "l1", "forces": "l2norm"}, {"energy": 1.0, "forces": 100.0}
E_RTOL, F_REL, G_REL = 2e-4, 2e-3, 2e-3
# rotation errors relative to the largest magnitude at this size and seed:
# E 0.016, F 0.035 measured (the port and JAX's XLA model alike)
E_ROT, F_ROT = 0.05, 0.1


def _masks(seed: int, b: int, a: int, k: int) -> list:
    """Seeded keep masks in the order both models draw them: per block the
    alpha mask [B,A,K,NH] and two drop-path masks [B,1,1,1]; then the force
    block's alpha mask."""
    rng = np.random.default_rng(seed)
    alpha = lambda: rng.random((b, a, k, KW["num_heads"])) > 0.1  # noqa: E731
    out = []
    for _ in range(KW["num_layers"]):
        out += [alpha(), rng.random((b, 1, 1, 1)) > 0.05, rng.random((b, 1, 1, 1)) > 0.05]
    return out + [alpha()]


def _jax_run(fields, xla, deterministic: bool, masks=None):
    """JAX's loss, outputs and parameter gradients (Pallas layout) on its XLA
    path; `masks` replace jax.random.bernoulli's draws in order."""
    jb = JaxMolBatch(**fields)
    model = jax_create_model("equiformer_v2", use_pallas=False, remat=False,
                             deterministic=deterministic, **KW)
    rngs = None if deterministic else {"dropout": jax.random.PRNGKey(0)}

    def loss(p):
        out = model.apply(p, jb, rngs=rngs)
        return jax_multitask_loss(out, jb, SPEC, COEF)["total"], out

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    if masks is None:
        (lval, out), grads = fn(xla)
    else:
        queue = list(masks)
        real = jax.random.bernoulli

        def fed(key, p=0.5, shape=None, **kw):
            m = queue.pop(0)
            assert tuple(shape) == m.shape, (shape, m.shape)
            return jax.numpy.asarray(m)

        jax.random.bernoulli = fed
        try:
            (lval, out), grads = fn(xla)
        finally:
            jax.random.bernoulli = real
        assert not queue
    g = eqv2_params(jax.device_get(grads), "pallas", KW["l_max"], KW["m_max"], CO)
    return dict(energy=np.asarray(out["energy"]), forces=np.asarray(out["forces"]),
                loss=float(lval), grads=g)


@pytest.fixture(scope="module")
def ref():
    f = _fields(np.random.default_rng(0))
    seeded = create_model("equiformer_v2", device="cpu", generator=seeded_generator(0), **KW)
    pallas = _flax_tree(seeded)
    xla = eqv2_params(pallas, "xla", KW["l_max"], KW["m_max"], CO)
    b, a = f["z"].shape
    masks = _masks(1, b, a, min(KW["max_neighbors"], a))
    return dict(fields=f, pallas=pallas, xla=xla, masks=masks,
                eval=_jax_run(f, xla, True), train=_jax_run(f, xla, False, masks))


def _port(ref, **kw):
    model = create_model("equiformer_v2", device="cpu", **dict(KW, **kw))
    return load_flax_params(model, ref["pallas"])


def _feed(model, masks) -> list:
    """Make `model` draw `masks` in order; returns the queue."""
    queue = list(masks)

    def fed(shape, keep_prob, device):
        m = queue.pop(0)
        assert tuple(shape) == m.shape, (shape, m.shape)
        return torch.from_numpy(m)

    model.bernoulli_keep = fed
    return queue


def _assert_grads_match(model, grads) -> None:
    """Each parameter's .grad within G_REL x max |g| of jax.grad's."""
    for name, p in model.named_parameters():
        path, transpose = _flax_path(name)
        want = grads["params"]
        for key in path:
            want = want[key]
        want = np.asarray(want).T if transpose else np.asarray(want)
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= G_REL * np.abs(want).max() + 1e-30, (name, err, np.abs(want).max())


def _assert_outputs(out, want) -> None:
    np.testing.assert_allclose(out["energy"].detach().numpy(), want["energy"], rtol=E_RTOL)
    f = out["forces"].detach().numpy()
    assert np.abs(f - want["forces"]).max() <= F_REL * np.abs(want["forces"]).max()


@pytest.mark.parametrize("mode", ["off", "fused"])
def test_energy_and_forces_match_jax(ref, mode):
    model = _port(ref, use_pallas=mode).eval()
    with torch.no_grad():
        out = model(_torch_batch(ref["fields"]))
    _assert_outputs(out, ref["eval"])


@pytest.mark.parametrize("mode", ["off", "fused"])
def test_train_step_gradients_match_jax(ref, mode):
    model = _port(ref, use_pallas=mode).eval()
    batch = _torch_batch(ref["fields"])
    loss = multitask_loss(model(batch), batch, SPEC, COEF)["total"]
    loss.backward()
    assert loss.item() == pytest.approx(ref["eval"]["loss"], rel=1e-4)
    _assert_grads_match(model, ref["eval"]["grads"])


@pytest.mark.parametrize("mode", ["off", "fused"])
def test_dropout_masks_match_jax(ref, mode):
    """Train mode: alpha dropout (into the kernel's dropk) and drop-path, fed
    the same masks as the JAX model built non-deterministic."""
    model = _port(ref, use_pallas=mode).train()
    queue = _feed(model, ref["masks"])
    batch = _torch_batch(ref["fields"])
    out = model(batch)
    assert not queue
    _assert_outputs(out, ref["train"])
    loss = multitask_loss(out, batch, SPEC, COEF)["total"]
    loss.backward()
    assert loss.item() == pytest.approx(ref["train"]["loss"], rel=1e-4)
    _assert_grads_match(model, ref["train"]["grads"])
    # the masks changed the result
    assert abs(ref["train"]["loss"] - ref["eval"]["loss"]) > 1e-3 * abs(ref["eval"]["loss"])


def test_float64_plain_module_matches_jax(ref):
    model = _port(ref, use_pallas="off").double().eval()
    f = _torch_batch(ref["fields"])
    batch = f.replace(**{k: getattr(f, k).double() for k in ("pos", "energy", "forces")})
    out = model(batch)
    assert out["energy"].dtype == out["forces"].dtype == torch.float64
    _assert_outputs(out, ref["eval"])
    multitask_loss(out, batch, SPEC, COEF)["total"].backward()
    _assert_grads_match(model, ref["eval"]["grads"])


def count_dropout_draws(monkeypatch) -> dict:
    """Counts of the masks drawn through torch.rand from now on: "alpha"
    ([B, A, K, NH]) and "drop_path" ([B, 1, 1, 1]), each from
    `dropout_generator`."""
    draws = {"alpha": 0, "drop_path": 0}
    rand = torch.rand

    def counting(size, *args, generator=None, **kwargs):
        draws["drop_path" if tuple(size)[1:] == (1, 1, 1) else "alpha"] += 1
        return rand(size, *args, generator=generator, **kwargs)

    monkeypatch.setattr(torch, "rand", counting)
    return draws


def test_train_mode_draws_and_eval_mode_does_not(ref, monkeypatch):
    """Train mode draws 1 alpha mask per attention and 2 drop-path masks per
    block from `dropout_generator` (the same seed, the same result); eval
    mode draws none and is deterministic."""
    model = _port(ref, use_pallas="fused")
    batch = _torch_batch(ref["fields"])
    draws = count_dropout_draws(monkeypatch)
    with torch.no_grad():
        e_eval = model.eval()(batch)["energy"]
        assert draws == {"alpha": 0, "drop_path": 0}
        model.train()
        outs = []
        for seed in (3, 3, 4):
            model.dropout_generator = torch.Generator().manual_seed(seed)
            outs.append(model(batch)["energy"])
    n = KW["num_layers"]
    assert draws == {"alpha": 3 * (n + 1), "drop_path": 3 * 2 * n}
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2]) and not torch.equal(outs[0], e_eval)


def test_rotation_equivariance_and_padding(ref):
    fused, plain = _port(ref, use_pallas="fused").eval(), _port(ref, use_pallas="off").eval()
    batch = _torch_batch(ref["fields"])
    q, _ = np.linalg.qr(np.random.default_rng(1).normal(size=(3, 3)))
    rot = torch.from_numpy(q * np.sign(np.linalg.det(q))).float()
    rotated = batch.replace(pos=batch.pos @ rot.T)
    with torch.no_grad():
        out, out_r, out_pr = fused(batch), fused(rotated), plain(rotated)
    e, f = out["energy"], out["forces"]
    e_max, f_max = float(e.abs().max()), float(f.abs().max())
    assert float((out_r["energy"] - e).abs().max()) <= E_ROT * e_max
    assert float((out_r["forces"] - f @ rot.T).abs().max()) <= F_ROT * f_max
    assert float((out_r["energy"] - out_pr["energy"]).abs().max()) <= 1e-5 * e_max
    assert float((out_r["forces"] - out_pr["forces"]).abs().max()) <= 1e-5 * f_max
    assert float(f[~batch.node_mask].abs().max()) == 0.0
    assert float(e[2]) == 0.0


def test_xla_layout_and_bad_options_raise(ref):
    """An XLA-layout tree (the JAX package's `eqv2_params` of the Pallas
    one) loads into the same weights as the Pallas tree; bad options raise,
    the fused path of the reference-compatible variant among them."""
    from_xla = load_flax_params(create_model("equiformer_v2", device="cpu", **KW), ref["xla"])
    for (n, p), q in zip(from_xla.named_parameters(), _port(ref).parameters()):
        assert torch.equal(p, q), n
    with pytest.raises(NotImplementedError, match="float32, bfloat16"):
        create_model("equiformer_v2", device="cpu", compute_dtype="float16", **KW)
    with pytest.raises(ValueError, match="m_share_rad=False"):
        create_model("equiformer_v2", device="cpu", compute_dtype="bfloat16", m_share_rad=False,
                     use_pallas="fused", **KW)
    with pytest.raises(ValueError, match="m_share_rad=False"):
        create_model("equiformer_v2", device="cpu", m_share_rad=False, use_pallas="fused", **KW)
    with pytest.raises(ValueError, match="use_pallas"):
        create_model("equiformer_v2", device="cpu", use_pallas="auto", **KW)


def test_full_width_matches_jax_and_shares_its_rotation_error():
    """configs/equiformer_v2.yaml's full width and depth (12 layers, l_max 6,
    C 128, 8 heads, 30 neighbours; the plain module, eval mode) on two
    seeded molecules of 24 and 17 atoms: E and F equal JAX's XLA model on the
    same weights within 1e-6 and 1e-4 of their largest magnitude, and under a
    rotation both move by the same amount, the truncated grid's aliasing
    (E ~4.7e-3 and F ~5.7e-2 of their largest magnitude measured)."""
    from nabladft_tpu_torch.data.synthetic import random_molecule

    rng = np.random.default_rng(0)
    b, a = 2, 24
    f = dict(z=np.zeros((b, a), np.int32), pos=np.zeros((b, a, 3), np.float32),
             node_mask=np.zeros((b, a), bool), graph_mask=np.ones(b, bool),
             energy=np.zeros(b, np.float32), forces=np.zeros((b, a, 3), np.float32),
             mol_id=np.arange(b, dtype=np.int32))
    for i, n in enumerate((24, 17)):
        f["z"][i, :n], f["pos"][i, :n] = random_molecule(rng, n)
        f["node_mask"][i, :n] = True
    q, _ = np.linalg.qr(np.random.default_rng(5).normal(size=(3, 3)))
    rot = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    f_rot = dict(f, pos=f["pos"] @ rot.T)

    model = create_model("equiformer_v2", device="cpu", generator=seeded_generator(42)).eval()
    with torch.no_grad():
        port = [model(_torch_batch(x)) for x in (f, f_rot)]
    jm = jax_create_model("equiformer_v2", use_pallas=False, remat=False)
    xla = eqv2_params(_flax_tree(model), "xla", 6, 2, 128)
    fn = jax.jit(jm.apply)
    ref = [fn(xla, JaxMolBatch(**x)) for x in (f, f_rot)]

    def rot_err(out, key):
        e, e_r = (np.asarray(o[key], np.float64) for o in out)
        return np.abs(e_r - (e @ rot.T if key == "forces" else e)).max() / np.abs(e).max()

    for p, r in zip(port, ref):
        for k, rel in (("energy", 1e-6), ("forces", 1e-4)):
            want = np.asarray(r[k])
            assert np.abs(p[k].numpy() - want).max() <= rel * np.abs(want).max(), k
    for k in ("energy", "forces"):
        e_port, e_jax = rot_err([{n: v.numpy() for n, v in o.items()} for o in port], k), \
            rot_err(ref, k)
        assert abs(e_port - e_jax) <= 0.01 * e_jax, (k, e_port, e_jax)
    assert rot_err(ref, "energy") < E_ROT
