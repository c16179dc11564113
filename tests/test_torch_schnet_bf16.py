"""The port's bf16 SchNet against the JAX package's, on the CPU.

* Kernels E-H in bf16: the plain versions (float32 arithmetic on the bf16
  pair and node inputs, float32 filter weights, rounded where the TPU
  kernels round) against JAX's Pallas kernels in interpret mode on the same
  inputs, the forward and every cotangent. The bf16 outputs (msg, msgd,
  gxin, gxind) within one bf16 ulp per element plus 2e-5 x max; the float32
  ones (g_dist, the weight gradients) within 2e-5 x max, float32 sums taken
  in another order. JAX's float32 kernels on the unrounded inputs fail the
  check, so it tells bf16 from float32.
* The model, compute_dtype="bfloat16", on the same converted weights:
  use_pallas "off" and "fused" (JAX's kernels in interpret mode) E and F.
* One surrogate train step (force_grads="pallas", kernels G and H): the
  losses and every parameter gradient against the JAX engine's.
* The same converted weights drive both dtypes.

Each model tolerance is stated beside its test, which also asserts that
JAX's own bf16-vs-float32 difference on the same inputs breaks it. JAX runs
jitted with XLA's excess precision off (tests/test_torch_painn_bf16.py
`exact_jit`), the op-by-op rounding of the JAX program, which the port
follows (`models/base.py` `shifted_softplus`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models.base import forward as jax_forward
from nabladft_tpu.ops.pallas.schnet_fused import schnet_dual as jax_schnet_dual
from nabladft_tpu.ops.pallas.schnet_fused import schnet_message as jax_schnet_message
from nabladft_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from nabladft_tpu_torch.models import create_model, forward
from nabladft_tpu_torch.models.convert import load_flax_params
from nabladft_tpu_torch.ops import schnet_fused as ts
from tests.test_torch_painn_bf16 import _ulp, exact_jit
from tests.test_torch_schnet import _arrays, _tb
from tests.test_torch_schnet_dual import _chain
from tests.test_torch_train import LOSSES

DTYPES = ("float32", "bfloat16")
BF = torch.bfloat16
KW = dict(hidden=16, n_interactions=2, n_rbf=8, max_neighbors=7)
B, A, R, F = 3, 8, 12, 16
KERNEL_MAX_REL = 2e-5  # (+ one bf16 ulp per element for the bf16 outputs)
E_REL = 1e-4           # of max |E|: JAX's bf16 roundings followed, float32 rounding left
# of max |F|: the fused backward is the kernels' float32 arithmetic (~2e-7
# seen); the plain one sums its broadcasts' cotangents in bf16 in XLA, in
# float32 in torch (~4e-4 seen)
F_REL = {"fused": 1e-4, "off": 2e-3}
LOSS_REL = 1e-4
GRAD_REL = 2e-2        # relative Frobenius error of each parameter's gradient
E_IN = ("dist", "rbf", "rbfp", "envf", "envp", "xin", "w1", "b1", "w2", "b2")
G_IN = ("rbf", "rbfd", "envf", "envfd", "xin", "xind", "w1", "b1", "w2", "b2")
WEIGHTS = ("w1", "b1", "w2", "b2")
NAMES = {"E": ["msg"], "F": ["g_dist", "gxin", "gw1", "gb1", "gw2", "gb2"],
         "G": ["msg", "msgd"], "H": ["gxin", "gxind", "gw1", "gb1", "gw2", "gb2"]}
BF16_OUT = {"msg", "msgd", "gxin", "gxind"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# kernels E-H
# ---------------------------------------------------------------------------


def _kernel_inputs(seed=3):
    """Float32 inputs: an unmasked Gaussian basis and a masked cosine cutoff
    of random distances with their derivatives, tangent lanes rbfd = rbfp ṫ
    and envfd = envp ṫ, node rows and weights; the tests round the pair and
    node tensors to bf16."""
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return (rng.normal(size=shape) * 0.3).astype(np.float32)

    dist = (np.abs(mk(B, A, A)) * 8 + 0.5).astype(np.float32)
    mask = (rng.random((B, A, A)) > 0.3).astype(np.float32)
    rbf, rbfp, envf, envp = _chain(dist, mask)
    dt = mk(B, A, A) * mask
    return dict(dist=dist, rbf=rbf, rbfp=rbfp, envf=envf, envp=envp,
                rbfd=rbfp * dt[..., None], envfd=envp * dt, xin=mk(B, A, F), xind=mk(B, A, F),
                w1=mk(R, F), b1=mk(1, F), w2=mk(F, F), b2=mk(1, F), gmsg=mk(B, A, F),
                gmsgd=mk(B, A, F))


def _jax_kernels(x):
    """JAX's E/F (schnet_message and its VJP) and G/H (schnet_dual and its
    VJP), interpret mode, the pair and node tensors in their dtype."""
    msg, vjp = jax.vjp(lambda *a: jax_schnet_message(*a, True), *(x[k] for k in E_IN))
    f_out = vjp(x["gmsg"])
    g_out, vjp_d = jax.vjp(lambda *a: jax_schnet_dual(*a, True), *(x[k] for k in G_IN))
    h_out = vjp_d((x["gmsg"], x["gmsgd"]))
    return {"E": (msg,), "F": tuple(f_out[i] for i in (0, 5, 6, 7, 8, 9)), "G": g_out,
            "H": tuple(h_out[i] for i in (4, 5, 6, 7, 8, 9))}


def _round(x, keep=("dist",) + WEIGHTS):
    """The pair and node tensors (and cotangents) rounded to bf16."""
    return {k: v if k in keep else jnp.asarray(v, jnp.bfloat16) for k, v in x.items()}


@pytest.fixture(scope="module")
def kernels():
    """(port's plain versions in bf16, JAX bf16, JAX float32 on the
    unrounded inputs) for E-H."""
    x32 = _kernel_inputs()
    jax16 = jax.device_get(exact_jit(_jax_kernels, _round(x32)))
    jax32 = jax.device_get(exact_jit(_jax_kernels, {k: jnp.asarray(v) for k, v in x32.items()}))
    t = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in x32.items()}
    t = {k: v if k in WEIGHTS else v.to(BF) for k, v in t.items()}
    port = {
        "E": (ts.schnet_message_reference(*(t[k] for k in E_IN[1:] if k not in ("rbfp", "envp"))),),
        "F": ts.schnet_message_bwd_reference(*(t[k] for k in E_IN[1:]), t["gmsg"]),
        "G": ts.schnet_dual_fwd_reference(*(t[k] for k in G_IN)),
        "H": ts.schnet_dual_bwd_reference(*(t[k] for k in G_IN), t["gmsg"], t["gmsgd"]),
    }
    return port, jax16, jax32


def _within(got, ref, bf16: bool):
    """Every element within 2e-5 x max |ref|, plus one bf16 ulp of ref for
    a bf16 output."""
    ref = np.asarray(ref, np.float32)
    slack = KERNEL_MAX_REL * np.abs(ref).max() + (_ulp(ref) if bf16 else 0.0)
    return bool((np.abs(np.asarray(got, np.float32) - ref) <= slack).all())


@pytest.mark.parametrize("kernel", ["E", "F", "G", "H"])
def test_bf16_plain_versions_match_jax_kernels(kernels, kernel):
    port, jax16, jax32 = kernels
    names = NAMES[kernel]
    assert len(port[kernel]) == len(names) == len(jax16[kernel])
    for name, got, want, want32 in zip(names, port[kernel], jax16[kernel], jax32[kernel]):
        # the dtypes JAX's wrappers give (g_dist and the weights' float32)
        bf16 = name in BF16_OUT
        assert got.dtype == (BF if bf16 else torch.float32), name
        assert np.dtype(want.dtype) == np.dtype(jnp.bfloat16 if bf16 else jnp.float32), name
        assert _within(got.float().numpy(), want, bf16), name
        assert not _within(want32, want, bf16), name  # the check tells bf16 from float32


def test_bf16_live_pairs_match_float32():
    """Rounding the envelopes to bf16 keeps every live pair live (bf16 keeps
    float32's exponent range): the live lists of E-H match float32's."""
    x = {k: torch.from_numpy(v) for k, v in _kernel_inputs().items()}
    x["envf"][0, 1, 2], x["envp"][0, 1, 2] = 1e-30, 0.0  # a pair live by a tiny envelope
    for env2 in ("envp", "envfd"):
        e32, e16 = (x["envf"], x[env2]), (x["envf"].to(BF), x[env2].to(BF))
        assert torch.equal(ts.schnet_live_rows(*e16)[0], ts.schnet_live_rows(*e32)[0])
        assert all(torch.equal(p, q) for p, q in zip(ts.schnet_live_pairs(*e16),
                                                     ts.schnet_live_pairs(*e32)))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flax_params():
    model = jax_create_model("schnet", **KW)
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), JaxBatch(**_arrays())))


@pytest.fixture(scope="module", params=["off", "fused"])
def outputs(request, flax_params):
    """(mode, {dtype: JAX (E, F)}, the port's bf16 (E, F)) for one message
    mode."""
    mode, arrays = request.param, _arrays()
    jax_out = {}
    for dt in DTYPES:
        jm = jax_create_model("schnet", **KW, use_pallas=mode, remat=False, compute_dtype=dt)
        out = exact_jit(lambda p, b: jax_forward(jm, p, b), flax_params, JaxBatch(**arrays))
        jax_out[dt] = (np.asarray(out["energy"]), np.asarray(out["forces"]))
    tm = load_flax_params(create_model("schnet", device="cpu", **KW, use_pallas=mode,
                                       compute_dtype="bfloat16"), flax_params)
    out = forward(tm, _tb(arrays))
    return mode, jax_out, (out["energy"].numpy(), out["forces"].numpy())


def test_bf16_energy_and_forces_match_jax(outputs):
    mode, jax_out, port = outputs
    for i, (what, rel) in enumerate((("E", E_REL), ("F", F_REL[mode]))):
        scale = np.abs(jax_out["float32"][i]).max()
        tol = rel * scale
        gap = np.abs(jax_out["bfloat16"][i] - jax_out["float32"][i]).max()
        assert port[i].dtype == np.float32 and np.isfinite(port[i]).all(), what
        assert np.abs(port[i] - jax_out["bfloat16"][i]).max() <= tol, (
            what, np.abs(port[i] - jax_out["bfloat16"][i]).max() / scale, gap / scale)
        assert tol < gap, (what, tol, gap)


@pytest.fixture(scope="module")
def surrogate(flax_params):
    """The JAX engine's pallas-route losses and gradients in both dtypes on
    one batch, from the same initial params, and the port's bf16 ones."""
    arrays, out = _arrays(), {}
    for dt in DTYPES:
        model = jax_create_model("schnet", **KW, remat=False, compute_dtype=dt)
        trainer = JaxTrainer(model, JaxConfig(schedule="constant", n_dp=1, force_grads="pallas",
                                              **LOSSES))
        grads, losses, _ = exact_jit(lambda p, b: trainer._surrogate_grads(p, b, None),
                                     flax_params, JaxBatch(**arrays))
        twin = load_flax_params(create_model("schnet", device="cpu", **KW), jax.device_get(grads))
        out[dt] = ({n: p.detach().numpy().copy() for n, p in twin.named_parameters()},
                   {k: float(v) for k, v in losses.items()})
    from nabladft_tpu_torch.train import Trainer, TrainerConfig
    model = load_flax_params(create_model("schnet", device="cpu", **KW, use_pallas="fused",
                                          compute_dtype="bfloat16"), flax_params)
    trainer = Trainer(model, "cpu", TrainerConfig(schedule="constant", force_grads="pallas",
                                                  **LOSSES))
    losses = trainer._compute_grads(_tb(arrays))
    port = ({n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            {k: float(v) for k, v in losses.items()})
    return out, port


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_bf16_surrogate_step_matches_jax_engine(surrogate):
    """Losses within rel 1e-4, every parameter gradient within relative
    Frobenius error 2e-2 of the JAX engine's bf16 step (kernels G and H in
    interpret mode there, their plain versions here). JAX's float32 step
    breaks both; and the port's whole gradient lies nearer JAX's bf16
    gradient than JAX's float32 one does."""
    out, (g_port, l_port) = surrogate
    (g16, l16), (g32, l32) = out["bfloat16"], out["float32"]
    for k in ("energy", "forces", "total"):
        assert l_port[k] == pytest.approx(l16[k], rel=LOSS_REL), k
    assert max(abs(l32[k] - l16[k]) / abs(l16[k]) for k in l16) > LOSS_REL
    for name, g in g_port.items():
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
        assert _rel(g, g16[name]) <= GRAD_REL, (name, _rel(g, g16[name]))
    assert max(_rel(g32[n], g16[n]) for n in g16) > GRAD_REL
    flat = lambda g: np.concatenate([g[n].ravel() for n in sorted(g)])  # noqa: E731
    assert _rel(flat(g_port), flat(g16)) < _rel(flat(g32), flat(g16))


def test_converted_weights_drive_both_dtypes(flax_params):
    """Parameters stay float32 in both packages (the filter arrays too): one
    conversion of the flax tree loads into the float32 and the bf16 model
    alike."""
    m32 = load_flax_params(create_model("schnet", device="cpu", **KW), flax_params)
    m16 = load_flax_params(create_model("schnet", device="cpu", **KW,
                                        compute_dtype="bfloat16"), flax_params)
    s32, s16 = m32.state_dict(), m16.state_dict()
    assert s32.keys() == s16.keys()
    assert all(s16[k].dtype == torch.float32 and torch.equal(s32[k], s16[k]) for k in s32)
