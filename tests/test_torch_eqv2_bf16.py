"""The port's EquiformerV2 in bf16 (kernels O and P in their mxu_bf16 mode)
against the JAX package's, on the CPU.

* Plain O and P with ``mxu_bf16=True`` against the JAX `_attn_pipeline` and
  the hand-written `_attn_pipeline_bwd` with ``mxu_bf16=True`` (one
  molecule's receivers at a time, its masked one-hot gather; `exact_jit`),
  at l_max 3 / m_max 1 and tests/test_torch_eqv2_attn.py's widths (C 8, 2
  heads of 4 value and 8 alpha channels, 8 edge channels, K = 5 slots with
  ~30 % dead, one receiver with no live edge, a seeded keep mask): the
  forward and every cotangent (gx, gxi, gxe, each weight gradient) within
  PIPE_REL x its largest magnitude, which the float32 versions break for
  every output (the port's, held to JAX's float32 pipeline within 1e-4 by
  tests/test_torch_eqv2_attn.py). The rounding points this holds: the gathered sender
  rows and the radial and SO(2) products' operands rounded, the receiver's
  rows not; in the backward the sender rows' cotangents rounded before the
  sum over edges, gxi not; the per-head expanders, b_rad and the LayerNorm
  and alpha vectors float32.
* Once at l_max 2 / m_max 1, `eqv2_attention_vjp` with mxu_bf16 (the Pallas
  kernels in interpret mode) against `EqV2AttentionFn`, forward and VJP.
* The model (tests/models/test_bf16_zoo.py's SMALL["equiformer_v2"]: 1
  block, l_max 2, m_max 1, 8 channels) with compute_dtype bf16, `use_pallas`
  "off" and "fused", eval mode, against the JAX model's Pallas path
  (interpret mode, `exact_jit`) on the same flax tree: E and F within
  test_torch_escn_bf16's tolerances, one train step's parameter gradients
  within GRAD_REL (the edge-degree projection's bias gradient, a bf16
  Dense's bias summed over all edges, takes most of it, 1.7e-2: XLA sums it
  in bf16, torch in float32; the float32 gradients' largest gap 6.8e-2),
  each broken by the float32 model.
* One flax tree drives both dtypes.
* The product engine's plain versions in its two bf16 modes ("rbf16": both
  float32 operands rounded; "bf16": A's bf16 values, B rounded, the mode
  kernels O and P run their products in on the card), `so2_products_reference`
  and `so2_wgrads_reference`, against JAX's `_mdot(a, b, True)`: a plain
  product, a transposed and signed one over gathered rows, a weight gradient,
  within float32 summation order (MDOT_REL x max); `rows_bf16`'s plain
  version (xe's live rows as the bf16 mode's radial-product operand)
  against JAX's astype(bfloat16) at ties.
* The reference-compatible variant (m_share_rad=False, the published
  checkpoints') in bf16 against JAX's XLA path in bf16 at SMALL's widths:
  E and F within REF_E_REL / REF_F_REL, which the float32 model breaks; its
  fused path refused in bf16 as in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nabladft_tpu.ops.pallas.eqv2_attn as ak
from nabladft_tpu.ops.pallas.escn_layer import _mdot
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.ops import eqv2_attn as ea
from tests.test_torch_eqv2_attn import _inputs, _jax_mol, _jax_weights, _static, _torch
from tests.test_torch_painn_bf16 import exact_jit
from tests.test_torch_escn_bf16 import (
    PIPE_REL, assert_both_dtypes_load, assert_model_matches, jax_reference, port_kw,
    port_step, rel_max,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# kernels O and P: the plain bf16 versions against the JAX pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipeline():
    """`_attn_pipeline` and `_attn_pipeline_bwd` with mxu_bf16 per molecule:
    (inputs, out, [gx, gxi, gxe, *gws] in the port's order, weight gradients
    summed over the molecules)."""
    inp = _inputs(11, l_max=3, m_max=1, drop=True)
    st = dict(_static(inp), mxu_bf16=True)
    ws = (*_jax_weights(inp), *ak._expanders(st["nh"], st["va"], st["co"]))

    def both(mol, g):
        return (ak._attn_pipeline(*mol, *ws, **st), ak._attn_pipeline_bwd(*mol, *ws, g, **st))

    mols = [_jax_mol(inp, b) for b in range(inp["x"].shape[0])]
    stacked = tuple(jnp.stack(parts) for parts in zip(*mols))  # one compile for the molecules
    out, bwd = exact_jit(jax.vmap(both), stacked, jnp.asarray(inp["g"]))
    grads = [np.asarray(v) for v in jax.tree_util.tree_leaves(list(bwd))]
    gx = grads[0].transpose(0, 2, 1, 3)
    gws = [g.sum(axis=0) for g in grads[3:]]  # the weight gradients summed over the molecules
    return inp, np.asarray(out), [gx, grads[1], grads[2], *gws]


def _plain(inp, fn, **kw):
    t = _torch(inp)
    return fn(t["x"], t["xi"], t["idx"], t["d"], t["xe"], t["maskf"], t["dropk"], *t["ws"],
              **inp["dims"], **kw)


def test_plain_o_bf16_matches_attn_pipeline(pipeline):
    inp, want, _ = pipeline
    got = _plain(inp, ea.eqv2_fwd, mxu_bf16=True)
    assert got.dtype == torch.float32
    assert float(got[0, 2].abs().max()) == 0.0  # the receiver with no live edge
    assert rel_max(got.numpy(), want) <= PIPE_REL
    assert rel_max(_plain(inp, ea.eqv2_fwd).numpy(), want) > PIPE_REL


def test_plain_p_bf16_matches_attn_pipeline_bwd(pipeline):
    inp, _, want = pipeline
    g = torch.from_numpy(inp["g"])
    got = _plain(inp, ea.eqv2_bwd, g=g, mxu_bf16=True)
    got32 = _plain(inp, ea.eqv2_bwd, g=g)
    names = ["gx", "gxi", "gxe"] + ea.weight_names(inp["dims"]["m_max"])
    assert len(got) == len(names) == len(want)
    for n, g_, g32, w in zip(names, got, got32, want):
        w = w.reshape(g_.shape)
        assert rel_max(g_.numpy(), w) <= PIPE_REL, n
        assert rel_max(g32.numpy(), w) > PIPE_REL, n


def test_attention_fn_bf16_matches_pallas_kernels_in_interpret_mode():
    inp = _inputs(3, l_max=2, m_max=1, b=2, a=8, k=8, drop=True)
    st = _static(inp)
    t = _torch(inp)
    w_rad, b_rad, w1, fc1m, w2, fc2m, ln_s, ln_b, adot = _jax_weights(inp)
    a = inp["x"].shape[1]
    oh = jnp.asarray(np.eye(a, dtype=np.float32)[inp["idx"]] * inp["maskf"][..., None])

    def f(x_sm, x_asc, xe, w_rad, b_rad, w1, fc1m, w2, fc2m, ln_s, ln_b, adot):
        return ak.eqv2_attention_vjp(
            st["l_max"], st["m_max"], st["n_grid"], True, True, st["nh"], st["va"], x_sm, oh,
            x_asc, jnp.asarray(inp["d"]), xe, jnp.asarray(inp["maskf"][..., None]),
            jnp.asarray(inp["dropk"]), w_rad, b_rad, w1, fc1m, w2, fc2m, ln_s, ln_b, adot)

    x_sm = jnp.asarray(inp["x"].transpose(0, 2, 1, 3))
    out, fn = jax.vjp(f, x_sm, jnp.asarray(inp["xi"]), jnp.asarray(inp["xe"]), w_rad, b_rad, w1,
                      fc1m, w2, fc2m, ln_s, ln_b, adot)
    want = [np.asarray(v) for v in jax.tree_util.tree_leaves(list(fn(jnp.asarray(inp["g"]))))]
    want[0] = want[0].transpose(0, 2, 1, 3)

    leaves = [t["x"], t["xi"], t["xe"], *t["ws"]]
    leaves = [v.clone().requires_grad_(True) for v in leaves]
    got = ea.eqv2_attention(leaves[0], leaves[1], t["idx"], t["d"], leaves[2], t["maskf"],
                            t["dropk"], *leaves[3:], **inp["dims"], mxu_bf16=True)
    assert rel_max(got.detach().numpy(), np.asarray(out)) <= PIPE_REL
    got.backward(t["g"])
    for n, p, w in zip(["x", "xi", "xe"] + ea.weight_names(1), leaves, want):
        assert rel_max(p.grad.numpy(), w) <= PIPE_REL, n


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


GRAD_REL = 2e-2  # relative Frobenius error per parameter


@pytest.fixture(scope="module")
def eqv2_ref():
    return jax_reference("equiformer_v2")


@pytest.mark.parametrize("mode", ["off", "fused"])
def test_bf16_model_matches_jax(eqv2_ref, mode):
    assert_model_matches(port_step("equiformer_v2", eqv2_ref, mode), eqv2_ref["jax"], GRAD_REL)


def test_converted_weights_drive_both_dtypes(eqv2_ref):
    assert_both_dtypes_load("equiformer_v2", eqv2_ref["params"])


def test_reference_variant_refuses_bf16():
    """The reference variant runs bf16 on its plain path only: asking for
    the fused path in bf16 raises, as in float32 (no kernel of the JAX
    package serves it)."""
    with pytest.raises(ValueError, match="m_share_rad=False"):
        create_model("equiformer_v2", device="cpu", compute_dtype="bfloat16", m_share_rad=False,
                     use_pallas="fused", **port_kw("equiformer_v2"))


# the reference-compatible variant at SMALL's widths
REF_KW = dict(port_kw("equiformer_v2"), m_share_rad=False, attn_hidden_channels=8)
REF_E_REL, REF_F_REL = 1e-4, 1e-4  # x max |E|, max |F| of the float32 model (direct F)


@pytest.fixture(scope="module")
def ref_variant():
    """JAX's XLA path of the reference variant in both dtypes (`exact_jit`)
    and the port's bf16 model on the same flax tree (eval mode): E and F."""
    from nabladft_tpu.data.batch import MolBatch as JaxMolBatch
    from nabladft_tpu.models import create_model as jax_create_model
    from nabladft_tpu.models.base import forward as jax_forward
    from nabladft_tpu_torch.models import forward
    from nabladft_tpu_torch.models.convert import flax_params_of, load_flax_params
    from tests.test_torch_escn import _fields, _torch_batch

    fields = _fields(np.random.default_rng(0))
    jb = JaxMolBatch(**fields)
    # the port's seeded weights as the flax tree (the XLA layout's names)
    params = flax_params_of(create_model("equiformer_v2", device="cpu",
                                         generator=torch.Generator().manual_seed(0), **REF_KW))
    out = {}
    for dt in ("float32", "bfloat16"):
        jm = jax_create_model("equiformer_v2", use_pallas=False, remat=False, compute_dtype=dt,
                              **REF_KW)
        o = exact_jit(lambda p, b: jax_forward(jm, p, b), params, jb)
        out[dt] = {k: np.asarray(o[k]) for k in ("energy", "forces")}
    port = load_flax_params(create_model("equiformer_v2", device="cpu", compute_dtype="bfloat16",
                                         **REF_KW), params).eval()
    assert port.use_pallas == "off" and port.cdt == torch.bfloat16
    o = forward(port, _torch_batch(fields))
    return out, {k: o[k].numpy() for k in ("energy", "forces")}


def test_reference_variant_bf16_matches_jax(ref_variant):
    """The reference variant in bf16 against JAX's XLA path in bf16: E and F
    within 1e-4 of the float32 model's largest magnitude (the port rounds
    where the JAX program rounds; float32 sums in another order are left),
    which the float32 model breaks."""
    jax_out, port = ref_variant
    for key, rel in (("energy", REF_E_REL), ("forces", REF_F_REL)):
        scale = np.abs(jax_out["float32"][key]).max()
        assert port[key].dtype == np.float32 and np.isfinite(port[key]).all(), key
        err = np.abs(port[key] - jax_out["bfloat16"][key]).max()
        gap = np.abs(jax_out["float32"][key] - jax_out["bfloat16"][key]).max()
        assert err <= rel * scale < gap, (key, err / scale, gap / scale)


MDOT_REL = 1e-6


def _mdot_np(a, b) -> np.ndarray:
    return np.asarray(_mdot(jnp.asarray(a), jnp.asarray(b), True))


@pytest.mark.parametrize("mode", ["rbf16", "bf16"])
def test_engine_references_match_jax_mdot(mode):
    rng = np.random.default_rng(11)
    rows, slots, k, n = 37, 50, 24, 16
    a, b = rng.standard_normal((slots, k), np.float32), rng.standard_normal((k, n), np.float32)
    bt = rng.standard_normal((n, k), np.float32)
    eidx = np.sort(rng.choice(slots, rows, replace=False)).astype(np.int32)
    at = torch.from_numpy(a).bfloat16() if mode == "bf16" else torch.from_numpy(a)
    seg = {mode: True}
    c, c2 = torch.zeros(rows, n), torch.zeros(rows, n)
    ea.so2_products([dict(segs=[dict(a=at, b=torch.from_numpy(b), k=k, **seg)], n=n, c=c),
                     dict(segs=[dict(a=at, b=torch.from_numpy(b), k=k, **seg),
                                dict(a=at, b=torch.from_numpy(bt), k=k, btrans=True, sign=-1,
                                     **seg)], n=n, c=c2, gather=True)],
                    rows, torch.from_numpy(eidx))
    want = _mdot_np(a[:rows], b)
    want2 = _mdot_np(a[eidx], b) - _mdot_np(a[eidx], bt.T)
    assert rel_max(c.numpy(), want) <= MDOT_REL
    assert rel_max(c2.numpy(), want2) <= MDOT_REL
    assert rel_max(c.numpy(), a[:rows] @ b) > 1e2 * MDOT_REL  # the rounding shows

    m, g = 12, rng.standard_normal((slots, n), np.float32)
    gt = torch.from_numpy(g).bfloat16() if mode == "bf16" else torch.from_numpy(g)
    out = torch.zeros(m, n)
    ea.so2_wgrads([dict(segs=[dict(a=at[:, :m], b=gt, **seg)], m=m, n=n, out=out)], rows)
    assert rel_max(out.numpy(), _mdot_np(a[:rows, :m].T, g[:rows])) <= MDOT_REL


def test_rows_bf16_rounds_as_jax_at_ties():
    base = np.array([1.0, 1.5, -1.25, 3.0, 6.5e-3, -2.0e4], np.float32).view(np.int32)
    ties = np.concatenate([(base + off).view(np.float32)
                           for off in (0x8000, 0x18000, 0x7FFF, 0x8001, -0x8000)])
    xe = np.tile(ties, 8)[:240].reshape(30, 8)
    eidx = np.random.default_rng(5).permutation(30)[:21].astype(np.int32)
    got = ea.rows_bf16(torch.from_numpy(xe), torch.from_numpy(eidx))
    want = np.asarray(jnp.asarray(xe[eidx]).astype(jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
