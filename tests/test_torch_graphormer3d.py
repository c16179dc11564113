"""The port's Graphormer3D against the JAX package's, with the same weights.

Graphormer3D at a small width (one block of two shared layers, 32 dim, 4
heads, 8 Gaussian kernels) with a per-atom energy mean and std, the JAX
model's own initial flax tree carried across by `load_flax_params` (every
leaf used, gbf's and the encoders' nn.Embeds included):

* eval mode (the JAX model deterministic): E within rtol 2e-4 / atol 1e-5,
  the direct forces within rtol 2e-3 / atol 2e-4;
* padding insensitivity: the same molecules padded to more atom slots give
  the same E and F (the per-atom energy is standardised before padding is
  masked, so the mean never enters through padded slots), as in JAX;
* train mode draws its dropout masks from the given generator (the same
  seed gives the same output, another seed another) and changes the output
  against eval mode; with every configured rate at 0 the encoder's output
  equals eval mode's and only the heads' two fixed 0.1 sites draw; eval
  mode draws nothing.
"""

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxMolBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models.convert import load_flax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(blocks=1, layers=2, embed_dim=32, ffn_embed_dim=32, attention_heads=4, num_kernel=8,
          energy_mean=-1.5, energy_std=2.0)
NO_DROPOUT = dict(input_dropout=0.0, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
E_TOL = dict(rtol=2e-4, atol=1e-5)
F_TOL = dict(rtol=2e-3, atol=2e-4)


def energy_batch(seed=0, b=3, a=6) -> dict:
    rng = np.random.default_rng(seed)
    z = rng.integers(1, 9, (b, a)).astype(np.int32)
    pos = rng.uniform(-1.6, 1.6, (b, a, 3)).astype(np.float32)
    node_mask = np.ones((b, a), bool)
    node_mask[1, 4:] = False
    node_mask[2] = False  # a padding molecule
    z[~node_mask] = 0
    pos[~node_mask] = 0.0
    return dict(z=z, pos=pos, node_mask=node_mask, graph_mask=node_mask.any(1),
                energy=np.zeros(b, np.float32), forces=np.zeros((b, a, 3), np.float32),
                mol_id=np.arange(b, dtype=np.int32))


def _pad(f: dict, extra: int) -> dict:
    """The same molecules with `extra` more (padded) atom slots."""
    out = dict(f)
    for k in ("z", "pos", "node_mask", "forces"):
        v = f[k]
        out[k] = np.concatenate([v, np.zeros((v.shape[0], extra, *v.shape[2:]), v.dtype)], 1)
    return out


def torch_batch(f: dict) -> MolBatch:
    return MolBatch(**{k: torch.from_numpy(np.array(v)) for k, v in f.items()})


@pytest.fixture(scope="module")
def ref():
    f = energy_batch()
    model = jax_create_model("graphormer3d", deterministic=True, remat=False, **KW)
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), JaxMolBatch(**f)))
    apply = jax.jit(model.apply)
    out = {k: np.asarray(v) for k, v in apply(params, JaxMolBatch(**f)).items()}
    padded = {k: np.asarray(v) for k, v in apply(params, JaxMolBatch(**_pad(f, 3))).items()}
    return dict(fields=f, params=params, out=out, padded=padded)


def _port(ref, **kw):
    model = create_model("graphormer3d", device="cpu", **dict(KW, **kw))
    return load_flax_params(model, ref["params"])


def test_eval_mode_matches_jax(ref):
    model = _port(ref).eval()
    with torch.no_grad():
        out = model(torch_batch(ref["fields"]))
    np.testing.assert_allclose(out["energy"].numpy(), ref["out"]["energy"], **E_TOL)
    np.testing.assert_allclose(out["forces"].numpy(), ref["out"]["forces"], **F_TOL)
    assert np.abs(ref["out"]["forces"]).max() > 1e-3


def test_padding_changes_nothing(ref):
    model = _port(ref).eval()
    with torch.no_grad():
        out = model(torch_batch(ref["fields"]))
        padded = model(torch_batch(_pad(ref["fields"], 3)))
    np.testing.assert_allclose(padded["energy"].numpy(), out["energy"].numpy(), **E_TOL)
    np.testing.assert_allclose(padded["forces"].numpy()[:, :6], out["forces"].numpy(), **F_TOL)
    assert not padded["forces"][:, 6:].any()
    np.testing.assert_allclose(padded["energy"].numpy(), ref["padded"]["energy"], **E_TOL)
    # the padding molecule's energy is 0, not A · energy_mean
    assert float(out["energy"][2]) == 0.0


def _count_draws(monkeypatch) -> list:
    """The generators of the `torch.rand` calls made from now on: one per
    keep mask drawn."""
    draws, rand = [], torch.rand

    def counting(*args, generator=None, **kwargs):
        draws.append(generator)
        return rand(*args, generator=generator, **kwargs)

    monkeypatch.setattr(torch, "rand", counting)
    return draws


def _train_forward(model, batch, seed):
    model.train()
    model.dropout_generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        return model(batch)


def test_train_mode_draws_dropout_from_the_generator(ref, monkeypatch):
    model = _port(ref)
    batch = torch_batch(ref["fields"])
    draws = _count_draws(monkeypatch)
    with torch.no_grad():
        evaluated = model.eval()(batch)
    assert draws == []
    a = _train_forward(model, batch, 1)
    # input, 3 per layer call (attention dropout 0 draws nothing), energy, force head
    assert len(draws) == 1 + 3 * KW["blocks"] * 2 + 2
    assert all(g is model.dropout_generator for g in draws)
    b = _train_forward(model, batch, 1)
    c = _train_forward(model, batch, 2)
    for k in ("energy", "forces"):
        assert torch.equal(a[k], b[k]), k
        assert not torch.equal(a[k], c[k]), k
        assert not torch.equal(a[k], evaluated[k]), k


def test_dropout_rates_of_zero_equal_eval(ref, monkeypatch):
    """With every configured rate at 0 the encoder runs as in eval mode; only
    the heads' fixed 0.1 sites (the JAX module's constants) still draw."""
    model = _port(ref, **NO_DROPOUT)
    batch = torch_batch(ref["fields"])
    trunk = []
    # the encoder's normalised output, as the force head receives it
    model.force_head.register_forward_pre_hook(lambda mod, args: trunk.append(args[0]))
    draws = _count_draws(monkeypatch)
    _train_forward(model, batch, 1)
    assert len(draws) == 2
    with torch.no_grad():
        model.eval()(batch)
    assert torch.equal(trunk[0], trunk[1])


def test_unported_compute_dtype_raises():
    with pytest.raises(NotImplementedError, match="bfloat16"):
        create_model("graphormer3d", device="cpu", compute_dtype="bfloat16")
