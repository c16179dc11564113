"""The port's eSCN in bf16 (kernels M and N in their mxu_bf16 mode) against
the JAX package's, on the CPU.

* Plain M and N with ``mxu_bf16=True`` (every product that the TPU kernels
  pass through `_mdot` rounds both operands to bf16 and sums in float32)
  against `jax.vmap` of the per-receiver `_message_pipeline` and of the
  hand-written `_pipeline_bwd` with ``mxu_bf16=True`` (one `exact_jit`), at l_max
  3 / m_max 1 (the kernels' build, l_max 6, is held to these plain versions
  on the card) and tests/test_torch_escn_layer.py's widths (C 8, H 16, EC 8;
  B 2, A 6, about a third of the pairs masked): the forward and every
  cotangent (gx, gxe, each weight gradient) within PIPE_REL x its largest
  magnitude. The two differ by float32 sums in another order, which may
  flip a value's bf16 rounding. The float32 versions on the same inputs
  break the tolerance for every output (the port's float32 plain versions,
  which tests/test_torch_escn_layer.py holds to JAX's float32 pipeline
  within 1e-5: the bf16-vs-float32 gap is JAX's own to that margin).
* Once at l_max 2 / m_max 1, `escn_message` with mxu_bf16 (the Pallas kernels
  in interpret mode) against `ESCNMessageFn`, forward and VJP.
* The model (tests/models/test_bf16_zoo.py's SMALL["escn"]: 2 layers, l_max
  2, m_max 1, 8 channels) with compute_dtype bf16, `use_pallas` "off" and
  "fused", against the JAX model's Pallas path (interpret mode, jitted with
  `exact_jit`) on the same flax tree, two molecules and a padding one: E
  within E_REL, F within F_REL x max; one train step's parameter gradients
  each within relative Frobenius error GRAD_REL (XLA sums the embedding's
  bf16 cotangent rows in bf16, torch in float32). The float32 model breaks
  each tolerance (the port's float32 model, held to JAX's by
  tests/test_torch_escn.py and tests/test_torch_eqv2.py within 2e-4 in E
  and 2e-3 in F and the gradients, far inside the gaps), and the port's
  whole gradient lies nearer JAX's bf16 gradient than the float32 one
  does. The step's loss (at random weights its targets dominate it, so the
  dtypes barely move it) agrees within LOSS_REL.
* One flax tree drives both dtypes (flax keeps float32 parameters under a
  bf16 `dtype`; so does the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxMolBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.ops.pallas import escn_layer as JK
from nabladft_tpu.train.losses import multitask_loss as jax_multitask_loss
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models.convert import load_flax_params
from nabladft_tpu_torch.ops import escn_layer as el
from nabladft_tpu_torch.train import seeded_generator
from nabladft_tpu_torch.train.losses import multitask_loss
from tests.models.test_bf16_zoo import SMALL
from tests.test_torch_escn import _fields, _flax_tree, _torch_batch
from tests.test_torch_escn_layer import _inputs, _mlists, _t
from tests.test_torch_painn_bf16 import exact_jit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


L, M, C, H, EC, B, A = 3, 1, 8, 16, 8, 2, 6
NG = 2 * (L + 1) ** 2
# x each output's max: float32 sums in another order may flip a value's bf16
# rounding, which moves an output by up to ~2^-8 of one product term (seen:
# 3.8e-4 at l_max 2; JAX's bf16-vs-float32 gap 2.9e-3 to 1e-2)
PIPE_REL = 1e-3
E_REL, F_REL = 1e-4, 5e-4  # x max |E|, max |F| of the float32 model
# one train step's gradients: relative Frobenius error per parameter (eSCN's
# worst, the embedding's, 1.3e-3; the float32 gradients' largest gap 6.6e-3)
LOSS_REL, GRAD_REL = 1e-5, 3e-3
SPEC, COEF = {"energy": "l1", "forces": "l2norm"}, {"energy": 1.0, "forces": 100.0}
NAMES = ["x", "xe", "wg", "bg", "w1_0", "w2_0"] + [
    f"{w}_m{m}" for m in range(1, M + 1) for w in ("fc1", "w2r", "w2i")]


def rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def rel_fro(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# kernels M and N: the plain bf16 versions against the JAX pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipeline():
    """JAX's per-receiver pipeline and hand-written backward with mxu_bf16,
    vmapped over (b, i): (inputs, out, [gx, gxe, *gws] in the port's
    layout)."""
    inp = _inputs(np.random.default_rng(0), L, M, C, H, EC, B, A)
    kw = dict(l_max=L, m_max=M, c=C, h=H, n_grid=NG, mxu_bf16=True)
    ws, d = inp["ws"], jnp.asarray(inp["d"])

    def fwd(x, xe, dd):
        return jax.vmap(lambda xi, d1, xe1: JK._message_pipeline(
            jnp.swapaxes(x, 0, 1), xi, d1, xe1, *ws[:4], *_mlists(ws, M), **kw))(x, dd, xe)

    def bwd(x, xe, dd, g):
        return jax.vmap(lambda xi, d1, xe1, g1: JK._pipeline_bwd(
            jnp.swapaxes(x, 0, 1), xi, d1, xe1, *ws[:4], *_mlists(ws, M), g1, **kw))(
                x, dd, xe, g)

    out, man = exact_jit(lambda x, xe, g: (jax.vmap(fwd)(x, xe, d), jax.vmap(bwd)(x, xe, d, g)),
                         inp["x"], inp["xe"], inp["g"])
    out = np.asarray(out)
    # gx: each receiver's sender cotangents [S, A, C] summed, plus gxi
    gx = np.asarray(man[0]).sum(axis=1).transpose(0, 2, 1, 3) + np.asarray(man[1])
    gws = [np.asarray(w).sum(axis=(0, 1)) for w in man[3:7]]
    for m in range(M):
        gws += [np.asarray(man[j][m]).sum(axis=(0, 1)) for j in (7, 8, 9)]
    return inp, out, [gx, np.asarray(man[2])] + gws


def _args(inp):
    return [_t(inp["x"]), _t(inp["d"]), _t(inp["xe"]), *map(_t, inp["ws"])]


def test_plain_m_bf16_matches_message_pipeline(pipeline):
    inp, want, _ = pipeline
    kw = dict(l_max=L, m_max=M, n_grid=NG)
    got = el.escn_fwd(*_args(inp), **kw, mxu_bf16=True)
    assert got.dtype == torch.float32
    assert rel_max(got.numpy(), want) <= PIPE_REL
    assert rel_max(el.escn_fwd(*_args(inp), **kw).numpy(), want) > PIPE_REL


def test_plain_n_bf16_matches_pipeline_bwd(pipeline):
    inp, _, want = pipeline
    kw = dict(g=_t(inp["g"]), l_max=L, m_max=M, n_grid=NG)
    got = el.escn_bwd(*_args(inp), **kw, mxu_bf16=True)
    got32 = el.escn_bwd(*_args(inp), **kw)
    assert len(got) == len(NAMES) == len(want)
    for name, g_, g32, w in zip(NAMES, got, got32, want):
        w = w.reshape(g_.shape)
        assert rel_max(g_.numpy(), w) <= PIPE_REL, name
        assert rel_max(g32.numpy(), w) > PIPE_REL, name


def test_message_fn_bf16_matches_escn_message_in_interpret_mode():
    l_max, m_max, c, h, ec, b, a = 2, 1, 8, 16, 8, 2, 8
    n_grid = 2 * (l_max + 1) ** 2
    inp = _inputs(np.random.default_rng(1), l_max, m_max, c, h, ec, b, a)
    d_pad = np.pad(inp["d"], [(0, 0)] * 3 + [(0, 128 - inp["d"].shape[-1])])  # K to the lanes

    def f(x, xe, *ws):
        return JK.escn_message(l_max, m_max, n_grid, True, True, jnp.swapaxes(x, 1, 2), x,
                               jnp.asarray(d_pad), xe, *ws[:4], *_mlists(ws, m_max))

    out, vjp = jax.vjp(f, inp["x"], inp["xe"], *inp["ws"])
    want = [np.asarray(t) for t in vjp(jnp.asarray(inp["g"]))]
    args = [t.requires_grad_(i != 1) for i, t in enumerate(_args(inp))]
    got = el.escn_message(*args, l_max=l_max, m_max=m_max, n_grid=n_grid, mxu_bf16=True)
    assert rel_max(got.detach().numpy(), np.asarray(out)) <= PIPE_REL
    got.backward(_t(inp["g"]))
    for t, w in zip([args[0], *args[2:]], want):
        assert rel_max(t.grad.numpy(), w) <= PIPE_REL


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def port_kw(name: str) -> dict:
    return {k: v for k, v in SMALL[name].items() if k != "remat"}


def jax_reference(name: str) -> dict:
    """At SMALL[name] on one flax tree (the port's seeded weights): JAX's
    Pallas path (interpret mode) in bf16, its loss, E, F and gradients (as
    the port's parameters' shapes); and the port's float32 model's, the
    reference for the bf16-vs-float32 gaps."""
    kw = port_kw(name)
    fields = _fields(np.random.default_rng(0))
    jb = JaxMolBatch(**fields)
    params = _flax_tree(create_model(name, device="cpu", generator=seeded_generator(0), **kw))
    model = jax_create_model(name, use_pallas=True, remat=False, compute_dtype="bfloat16", **kw)

    def loss(p, b):
        o = model.apply(p, b)
        return jax_multitask_loss(o, b, SPEC, COEF)["total"], o

    (lval, o), grads = exact_jit(jax.value_and_grad(loss, has_aux=True), params, jb)
    twin = load_flax_params(create_model(name, device="cpu", **kw), jax.device_get(grads))
    out = {"bfloat16": dict(loss=float(lval), energy=np.asarray(o["energy"]),
                            forces=np.asarray(o["forces"]),
                            grads={n: p.detach().numpy().copy()
                                   for n, p in twin.named_parameters()})}
    out["float32"] = port_step(name, dict(fields=fields, params=params), "off", "float32")
    return dict(fields=fields, params=params, jax=out)


def port_step(name: str, ref: dict, mode: str, dtype: str = "bfloat16") -> dict:
    """The port's model on the same tree (eval mode): loss, E, F, grads."""
    model = load_flax_params(create_model(name, device="cpu", compute_dtype=dtype,
                                          use_pallas=mode, **port_kw(name)), ref["params"]).eval()
    batch = _torch_batch(ref["fields"])
    out = model(batch)
    lval = multitask_loss(out, batch, SPEC, COEF)["total"]
    lval.backward()
    return dict(loss=lval.item(), energy=out["energy"].detach().numpy(),
                forces=out["forces"].detach().numpy(),
                grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()})


def assert_model_matches(port: dict, jax_out: dict, grad_rel: float) -> None:
    """E, F, the loss and the gradients of the port's bf16 model against
    JAX's bf16 model, each tolerance but the loss's broken by the float32
    model."""
    j16, j32 = jax_out["bfloat16"], jax_out["float32"]
    for key, rel in (("energy", E_REL), ("forces", F_REL)):
        scale = np.abs(j32[key]).max()
        assert port[key].dtype == np.float32 and np.isfinite(port[key]).all(), key
        assert np.abs(port[key] - j16[key]).max() <= rel * scale, (
            key, np.abs(port[key] - j16[key]).max() / scale)
        assert np.abs(j32[key] - j16[key]).max() > rel * scale, key
    assert port["loss"] == pytest.approx(j16["loss"], rel=LOSS_REL)
    g16, g32, gp = j16["grads"], j32["grads"], port["grads"]
    assert gp.keys() == g16.keys()
    for n in g16:
        assert gp[n].dtype == np.float32 and np.isfinite(gp[n]).all(), n
        assert rel_fro(gp[n], g16[n]) <= grad_rel, (n, rel_fro(gp[n], g16[n]))
    assert max(rel_fro(g32[n], g16[n]) for n in g16) > grad_rel
    flat = lambda g: np.concatenate([g[n].ravel() for n in sorted(g)])  # noqa: E731
    assert rel_fro(flat(gp), flat(g16)) < rel_fro(flat(g32), flat(g16))


@pytest.fixture(scope="module")
def escn_ref():
    return jax_reference("escn")


@pytest.mark.parametrize("mode", ["off", "fused"])
def test_bf16_model_matches_jax(escn_ref, mode):
    assert_model_matches(port_step("escn", escn_ref, mode), escn_ref["jax"], GRAD_REL)


def assert_both_dtypes_load(name: str, params: dict) -> None:
    m32 = load_flax_params(create_model(name, device="cpu", **port_kw(name)), params)
    m16 = load_flax_params(create_model(name, device="cpu", compute_dtype="bfloat16",
                                        **port_kw(name)), params)
    assert m16.cdt == torch.bfloat16 and m32.cdt == torch.float32
    s32, s16 = m32.state_dict(), m16.state_dict()
    assert s32.keys() == s16.keys()
    assert all(s16[k].dtype == torch.float32 and torch.equal(s32[k], s16[k]) for k in s32)


def test_converted_weights_drive_both_dtypes(escn_ref):
    assert_both_dtypes_load("escn", escn_ref["params"])
