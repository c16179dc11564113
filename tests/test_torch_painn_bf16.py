"""The port's bf16 PaiNN against the JAX package's, on the CPU.

* Kernels A-D in bf16: the plain versions (float32 arithmetic on the bf16
  inputs, rounded where the TPU kernels round) against JAX's Pallas kernels
  in interpret mode on the same bf16 inputs, the forward and every
  cotangent: within one bf16 ulp per element plus 2e-5 x max. JAX's float32
  kernel on the unrounded inputs fails that check, so it tells bf16 from
  float32.
* The model, compute_dtype="bfloat16", on the same converted weights:
  use_pallas "off" and "fused" (JAX's kernels in interpret mode) E and F.
* One surrogate train step (force_grads="pallas"): the losses and every
  parameter gradient against the JAX engine's.
* The same converted weights drive both dtypes.

Each tolerance is stated beside its test, which also asserts that JAX's own
bf16-vs-float32 difference on the same inputs breaks it. JAX runs jitted
with XLA's excess precision off (`exact_jit`): every op rounds its bf16
result, the semantics of the JAX program that the port follows (jitted with
it on, XLA keeps some products and sums in float32 on the CPU). E agrees to
float32 rounding; F and the gradients go through backward passes whose bf16
sums the two frameworks accumulate differently (XLA's bf16 reductions
accumulate in bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models.base import forward as jax_forward
from nabladft_tpu.ops.pallas.painn_fused import painn_dual as jax_painn_dual
from nabladft_tpu.ops.pallas.painn_fused import painn_message as jax_painn_message
from nabladft_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from nabladft_tpu_torch.models import create_model, forward
from nabladft_tpu_torch.models.convert import load_flax_params
from nabladft_tpu_torch.ops import painn_fused as tp
from nabladft_tpu_torch.train import Trainer, TrainerConfig
from tests.test_torch_painn import KW, _arrays, _torch_batch
from tests.test_torch_train import LOSSES, _arrays as _train_arrays, _tb


def exact_jit(fn, *args):
    """fn(*args) jitted with XLA's excess precision off: each op rounds its
    bf16 result, as the JAX program is written (and as it runs op by op)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


DTYPES = ("float32", "bfloat16")
BF = torch.bfloat16
B, A, R, F = 3, 8, 12, 16
F3 = 3 * F
KERNEL_MAX_REL = 2e-5  # + one bf16 ulp per element (float32 sums in another order)
E_REL = 1e-4           # of max |E|: JAX's bf16 roundings followed, float32 rounding left
# of max |F|: the fused backward is the kernels' float32 arithmetic; the plain
# one sums its broadcasts' cotangents in bf16 in XLA, in float32 in torch
F_REL = {"fused": 2e-3, "off": 1.6e-2}
LOSS_REL = 1e-4
GRAD_REL = 2e-2        # relative Frobenius error of each parameter's gradient


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# kernels A-D
# ---------------------------------------------------------------------------


def _kernel_inputs(seed=0):
    """Float32 inputs (the radial chain a Gaussian basis of masked random
    distances); the tests round them to bf16."""
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return (rng.normal(size=shape) * 0.3).astype(np.float32)

    dist = np.abs(mk(B, A, A)) + 0.5
    mask = (rng.random((B, A, A)) > 0.3).astype(np.float32)
    mu = np.linspace(0.5, 3.0, R).astype(np.float32)
    g = np.exp(-((dist[..., None] - mu) ** 2)) * mask[..., None]
    x = dict(dist=dist, rbf=g.astype(np.float32),
             rbfp=(-2.0 * (dist[..., None] - mu) * g).astype(np.float32),
             phi=mk(B, A, F3), v=mk(B, A, F3), unit_t=mk(B, A, 3, A), w=mk(R, F3),
             gds=mk(B, A, F), gdv=mk(B, A, F3), phid=mk(B, A, F3), vd=mk(B, A, F3),
             unitd_t=mk(B, A, 3, A), gdsd=mk(B, A, F), gdvd=mk(B, A, F3))
    x["rbfd"] = (x["rbfp"] * mk(B, A, A)[..., None]).astype(np.float32)
    return x


def _jax_kernels(x):
    """JAX's A/B (painn_message and its VJP) and C/D (painn_dual and its
    VJP), interpret mode, in the inputs' dtype."""
    (ds, dv), vjp = jax.vjp(lambda *a: jax_painn_message(*a, True), x["dist"], x["rbf"],
                            x["rbfp"], x["phi"], x["v"], x["unit_t"], x["w"])
    g_dist, _, _, gphi, gv, g_ut, gw = vjp((x["gds"], x["gdv"]))
    c_in = [x[k] for k in ("rbf", "rbfd", "phi", "phid", "v", "vd", "unit_t", "unitd_t", "w")]
    c_out, vjp_d = jax.vjp(lambda *a: jax_painn_dual(*a, True), *c_in)
    d_out = vjp_d(tuple(x[k] for k in ("gds", "gdv", "gdsd", "gdvd")))
    return {"A": (ds, dv), "B": (g_dist, g_ut, gphi, gv, gw), "C": c_out,
            "D": tuple(d_out[i] for i in (2, 3, 4, 5, 8))}


@pytest.fixture(scope="module")
def kernels():
    """(port's plain versions in bf16, JAX bf16, JAX float32 on the
    unrounded inputs) for A-D."""
    x32 = _kernel_inputs()
    x16 = {k: v if k == "dist" else jnp.asarray(v, jnp.bfloat16) for k, v in x32.items()}
    jax16 = jax.device_get(exact_jit(_jax_kernels, x16))
    jax32 = jax.device_get(exact_jit(_jax_kernels, {k: jnp.asarray(v) for k, v in x32.items()}))
    t = {k: torch.from_numpy(np.asarray(v, np.float32)).to(BF) for k, v in x32.items()}
    port = {
        "A": tp.painn_message_reference(*(t[k] for k in ("rbf", "phi", "v", "unit_t", "w"))),
        "B": tp.painn_message_bwd_reference(*(t[k] for k in (
            "rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv"))),
        "C": tp.painn_dual_fwd_reference(*(t[k] for k in (
            "rbf", "rbfd", "phi", "phid", "v", "vd", "unit_t", "unitd_t", "w"))),
        "D": tp.painn_dual_bwd_reference(*(t[k] for k in (
            "rbf", "rbfd", "phi", "phid", "v", "vd", "unit_t", "unitd_t", "w",
            "gds", "gdv", "gdsd", "gdvd"))),
    }
    return port, jax16, jax32


def _ulp(y):
    """One bf16 ulp of each value (2^-7 of its leading power of two)."""
    a = np.maximum(np.abs(y), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _within(got, ref):
    """Every element within one bf16 ulp of ref plus 2e-5 x max |ref|."""
    ref = np.asarray(ref, np.float32)
    return bool((np.abs(np.asarray(got, np.float32) - ref)
                 <= _ulp(ref) + KERNEL_MAX_REL * np.abs(ref).max()).all())


@pytest.mark.parametrize("kernel", ["A", "B", "C", "D"])
def test_bf16_plain_versions_match_jax_kernels(kernels, kernel):
    port, jax16, jax32 = kernels
    names = {"A": ["ds", "dv"], "B": ["g_dist", "g_unit_t", "gphi", "gv", "gw"],
             "C": ["ds", "dv", "dsd", "dvd"], "D": ["gphi", "gphid", "gv", "gvd", "gw"]}[kernel]
    assert len(port[kernel]) == len(names)
    for name, got, want, want32 in zip(names, port[kernel], jax16[kernel], jax32[kernel]):
        # the dtypes JAX's wrappers give (B's g_dist float32, the rest bf16)
        assert got.dtype == (torch.float32 if name == "g_dist" else BF), name
        assert np.dtype(want.dtype) == np.dtype(jnp.float32 if name == "g_dist" else jnp.bfloat16)
        assert _within(got.float().numpy(), want), name
        if name != "g_dist":  # the check tells bf16 from float32
            assert not _within(want32, want), name


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flax_params():
    model = jax_create_model("painn", **KW)
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), JaxBatch(**_arrays())))


@pytest.fixture(scope="module", params=["off", "fused"])
def outputs(request, flax_params):
    """(mode, {dtype: JAX (E, F)}, the port's bf16 (E, F)) for one message
    mode."""
    mode, arrays = request.param, _arrays()
    jax_out = {}
    for dt in DTYPES:
        jm = jax_create_model("painn", **KW, use_pallas=mode, remat=False, compute_dtype=dt)
        out = exact_jit(lambda p, b: jax_forward(jm, p, b), flax_params, JaxBatch(**arrays))
        jax_out[dt] = (np.asarray(out["energy"]), np.asarray(out["forces"]))
    tm = load_flax_params(create_model("painn", device="cpu", **KW, use_pallas=mode,
                                       compute_dtype="bfloat16"), flax_params)
    out = forward(tm, _torch_batch(arrays))
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
    arrays, out, params = _train_arrays(), {}, flax_params
    for dt in DTYPES:
        model = jax_create_model("painn", **KW, remat=False, compute_dtype=dt)
        trainer = JaxTrainer(model, JaxConfig(schedule="constant", n_dp=1, force_grads="pallas",
                                              **LOSSES))
        grads, losses, _ = exact_jit(lambda p, b: trainer._surrogate_grads(p, b, None),
                                     params, JaxBatch(**arrays))
        twin = load_flax_params(create_model("painn", device="cpu", **KW), jax.device_get(grads))
        out[dt] = ({n: p.detach().numpy().copy() for n, p in twin.named_parameters()},
                   {k: float(v) for k, v in losses.items()})
    model = load_flax_params(create_model("painn", device="cpu", **KW, use_pallas="fused",
                                          compute_dtype="bfloat16"), params)
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
    Frobenius error 2e-2 of the JAX engine's bf16 step. JAX's float32 step
    breaks both; and the port's whole gradient lies nearer JAX's bf16
    gradient than JAX's float32 one does (the bias gradients, which XLA sums
    with bf16 accumulation, take most of the 2e-2)."""
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
    """Parameters stay float32 in both packages: one conversion of the flax
    tree loads into the float32 and the bf16 model alike."""
    m32 = load_flax_params(create_model("painn", device="cpu", **KW), flax_params)
    m16 = load_flax_params(create_model("painn", device="cpu", **KW,
                                        compute_dtype="bfloat16"), flax_params)
    s32, s16 = m32.state_dict(), m16.state_dict()
    assert s32.keys() == s16.keys()
    assert all(s16[k].dtype == torch.float32 and torch.equal(s32[k], s16[k]) for k in s32)
