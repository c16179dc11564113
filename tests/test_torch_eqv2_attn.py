"""Kernels O and P's plain versions against the JAX package's EqV2 attention.

The same seeded numpy inputs go through the port's `ops.eqv2_attn` (index
gathers over [B, A, K]) and the JAX `ops.pallas.eqv2_attn` (its masked
one-hot gather, one molecule's receivers at a time), at l_max 6 / m_max 2
(the kernels' build) with narrow channels (C 8, 2 heads of 4 value and 8
alpha channels, 8 edge channels), K = 5 slots with ~30 % dead, one receiver
whose edges are all dead, and the keep mask dropk as ones and as a seeded
dropout mask:

* plain O against `_attn_pipeline` (vmapped over the molecules, compiled
  once for both keep masks), within 2e-5 x max |agg|;
* plain P, and `EqV2AttentionFn`'s backward (the plain versions on the CPU),
  against the hand-written `_attn_pipeline_bwd` and against `jax.vjp` of
  `_attn_pipeline`, every cotangent within 1e-4 x its largest magnitude
  (fp32 sums over 49 rows and the softmax in another order);
* once at l_max 2 / m_max 1 against `eqv2_attention_vjp` itself (the Pallas
  kernels in interpret mode), forward and VJP;
* the FLOP model per edge equals JAX's `attn_fwd_flops` without its
  one-hot gather term; `gather_nodes` and `edge_rotation_vectors` equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nabladft_tpu.ops.pallas.eqv2_attn as ak
from nabladft_tpu.ops import graph as jax_graph
from nabladft_tpu_torch.ops import eqv2_attn as ea
from nabladft_tpu_torch.ops import graph, so3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FWD_REL, BWD_REL = 2e-5, 1e-4


def _inputs(seed, l_max=6, m_max=2, b=2, a=6, k=5, c=8, nh=2, va=8, vc=4, ec=8, drop=True):
    """Seeded numpy inputs of one attention call in the port's layout."""
    rng = np.random.default_rng(seed)
    co, n0, s = nh * vc, l_max + 1, (l_max + 1) ** 2
    kw = so3.trunc_compact_layout(l_max, m_max)[1]
    f32 = lambda *sh: (rng.normal(size=sh) * 0.3).astype(np.float32)  # noqa: E731
    mask = rng.random((b, a, k)) > 0.3
    mask[0, 2] = False  # a receiver with no live edge
    nls = [l_max + 1 - m for m in range(1, m_max + 1)]
    ws = ([f32(ec, n0 * 2 * c), f32(1, n0 * 2 * c), f32(n0 * 2 * c, n0 * co + nh * va + co)]
          + [f32(n * 2 * c, 2 * n * co) for n in nls] + [f32(n0 * co, n0 * co)]
          + [f32(n * co, 2 * n * co) for n in nls]
          + [1.0 + f32(1, nh * va), f32(1, nh * va), f32(1, nh * va) * 3])
    keep = rng.random((b, a, k, nh)) > 0.1
    return dict(
        x=f32(b, a, s, c), xi=f32(b, a, s, c), idx=rng.integers(0, a, (b, a, k)),
        d=f32(b, a, k, kw) * mask[..., None], xe=f32(b, a, k, ec), maskf=mask.astype(np.float32),
        dropk=(keep / 0.9 if drop else np.ones_like(keep)).astype(np.float32), ws=ws,
        g=f32(b, a, s, co), dims=dict(l_max=l_max, m_max=m_max, n_grid=4 * s, nh=nh), va=va,
        co=co)


def _torch(inp):
    t = {k: torch.from_numpy(np.asarray(inp[k])) for k in ("x", "xi", "idx", "d", "xe", "maskf",
                                                           "dropk", "g")}
    t["ws"] = [torch.from_numpy(w) for w in inp["ws"]]
    return t


def _jax_mol(inp, b):
    """Molecule b in the JAX op's per-molecule layout: (x [S,A,C], oh
    [A,K,A] masked one-hot, xi [A,S,C], d, xe, maskf [A,K,1], dropk)."""
    a = inp["x"].shape[1]
    oh = np.eye(a, dtype=np.float32)[inp["idx"][b]] * inp["maskf"][b][..., None]
    return (jnp.asarray(inp["x"][b].transpose(1, 0, 2)), jnp.asarray(oh),
            jnp.asarray(inp["xi"][b]), jnp.asarray(inp["d"][b]), jnp.asarray(inp["xe"][b]),
            jnp.asarray(inp["maskf"][b][..., None]), jnp.asarray(inp["dropk"][b]))


def _jax_weights(inp):
    m = inp["dims"]["m_max"]
    w = [jnp.asarray(v) for v in inp["ws"]]
    return w[0], w[1], w[2], w[3:3 + m], w[3 + m], w[4 + m:4 + 2 * m], w[-3], w[-2], w[-1]


def _static(inp):
    d = inp["dims"]
    return dict(l_max=d["l_max"], m_max=d["m_max"], c=inp["x"].shape[-1], co=inp["co"],
                nh=d["nh"], va=inp["va"], n_grid=d["n_grid"], mxu_bf16=False)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + 1e-30, (what, err, np.abs(want).max())


# XLA CPU compile options of the JAX reference, compiled once as one program
# (faster here than running the pipelines op by op)
XLA_FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
_COMPILED = {}


def _jax_refs(inp):
    """`_attn_pipeline`, `_attn_pipeline_bwd` and jax.vjp of the pipeline,
    vmapped over the molecules (each molecule's receivers on their own, as
    the JAX op runs them): cotangents in the port's order (x, xi, xe, *ws),
    weight gradients summed over the molecules. One compiled program serves
    both keep masks."""
    st = _static(inp)
    m_avg, m_exp, m_expv = ak._expanders(st["nh"], st["va"], st["co"])

    def both(mol, g, ws):
        x, oh, xi, d, xe, maskf, dropk = mol

        def f(x, xi, xe, *ws):
            return ak._attn_pipeline(x, oh, xi, d, xe, maskf, dropk, *ws, m_avg, m_exp, m_expv,
                                     **st)

        out, fn = jax.vjp(f, x, xi, xe, *ws)
        bwd = ak._attn_pipeline_bwd(x, oh, xi, d, xe, maskf, dropk, *ws, m_avg, m_exp, m_expv, g,
                                    **st)
        return out, fn(g), bwd

    mols = [_jax_mol(inp, b) for b in range(inp["x"].shape[0])]
    args = (tuple(jnp.stack(parts) for parts in zip(*mols)), jnp.asarray(inp["g"]),
            _jax_weights(inp))
    key = tuple(sorted(st.items())) + (inp["x"].shape,)
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(jax.vmap(both, in_axes=(0, 0, None))).lower(*args).compile(
            compiler_options=XLA_FAST)
    out, vjp, bwd = _COMPILED[key](*args)

    def port_order(cots):
        """(gx [B,A,S,C], gxi, gxe, *gws) from the molecules' cotangents in
        the order (x, xi, xe, *weights), the fc lists flattened in place."""
        leaves = [np.asarray(v) for v in jax.tree_util.tree_leaves(list(cots))]
        return ([leaves[0].transpose(0, 2, 1, 3), leaves[1], leaves[2]]
                + [v.sum(axis=0) for v in leaves[3:]])

    return dict(out=np.asarray(out), vjp=port_order(vjp), bwd=port_order(bwd))


@pytest.fixture(scope="module", params=["ones", "dropout"])
def case(request):
    inp = _inputs(11, drop=request.param == "dropout")
    return inp, _jax_refs(inp)


def test_plain_o_matches_attn_pipeline(case):
    inp, ref = case
    t = _torch(inp)
    out = ea.eqv2_fwd(t["x"], t["xi"], t["idx"], t["d"], t["xe"], t["maskf"], t["dropk"],
                      *t["ws"], **inp["dims"])
    _close(out.numpy(), ref["out"], FWD_REL, "agg")
    # the receiver with no live edge gets exact zeros
    assert float(out[0, 2].abs().max()) == 0.0


@pytest.mark.parametrize("jax_ref", ["bwd", "vjp"])
def test_plain_p_matches_jax(case, jax_ref):
    inp, ref = case
    t = _torch(inp)
    got = ea.eqv2_bwd(t["x"], t["xi"], t["idx"], t["d"], t["xe"], t["maskf"], t["dropk"],
                      *t["ws"], g=t["g"], **inp["dims"])
    assert len(got) == len(ref[jax_ref])
    names = ["gx", "gxi", "gxe"] + ea.weight_names(inp["dims"]["m_max"])
    for n, g_, w_ in zip(names, got, ref[jax_ref]):
        _close(g_.numpy(), w_, BWD_REL, n)
    # dead edges get no xe cotangent
    dead = t["maskf"] == 0
    assert float(got[2][dead].abs().max()) == 0.0


def test_autograd_function_backward_matches_jax(case):
    inp, ref = case
    t = _torch(inp)
    x = t["x"].clone().requires_grad_(True)
    xi = t["xi"].clone().requires_grad_(True)
    xe = t["xe"].clone().requires_grad_(True)
    ws = [w.clone().requires_grad_(True) for w in t["ws"]]
    out = ea.eqv2_attention(x, xi, t["idx"], t["d"], xe, t["maskf"], t["dropk"], *ws,
                            **inp["dims"])
    _close(out.detach().numpy(), ref["out"], FWD_REL, "agg")
    out.backward(t["g"])
    for n, p, w_ in zip(["x", "xi", "xe"] + ea.weight_names(inp["dims"]["m_max"]),
                        [x, xi, xe, *ws], ref["vjp"]):
        _close(p.grad.numpy(), w_, BWD_REL, n)


def test_matches_pallas_kernels_in_interpret_mode():
    """l_max 2 / m_max 1, K 8: `eqv2_attention_vjp` with interpret=True (the
    Pallas kernels O and P themselves) against the autograd Function."""
    inp = _inputs(3, l_max=2, m_max=1, b=2, a=8, k=8, drop=True)
    st = _static(inp)
    t = _torch(inp)
    w_rad, b_rad, w1, fc1m, w2, fc2m, ln_s, ln_b, adot = _jax_weights(inp)
    a = inp["x"].shape[1]
    oh = jnp.asarray(np.eye(a, dtype=np.float32)[inp["idx"]] * inp["maskf"][..., None])

    def f(x_sm, x_asc, xe, w_rad, b_rad, w1, fc1m, w2, fc2m, ln_s, ln_b, adot):
        return ak.eqv2_attention_vjp(
            st["l_max"], st["m_max"], st["n_grid"], True, False, st["nh"], st["va"], x_sm, oh,
            x_asc, jnp.asarray(inp["d"]), xe, jnp.asarray(inp["maskf"][..., None]),
            jnp.asarray(inp["dropk"]), w_rad, b_rad, w1, fc1m, w2, fc2m, ln_s, ln_b, adot)

    x_sm = jnp.asarray(inp["x"].transpose(0, 2, 1, 3))
    out, fn = jax.vjp(f, x_sm, jnp.asarray(inp["xi"]), jnp.asarray(inp["xe"]), w_rad, b_rad, w1,
                      fc1m, w2, fc2m, ln_s, ln_b, adot)
    grads = [np.asarray(v) for v in jax.tree_util.tree_leaves(list(fn(jnp.asarray(inp["g"]))))]
    grads[0] = grads[0].transpose(0, 2, 1, 3)

    x = t["x"].clone().requires_grad_(True)
    xi = t["xi"].clone().requires_grad_(True)
    xe = t["xe"].clone().requires_grad_(True)
    ws = [w.clone().requires_grad_(True) for w in t["ws"]]
    got = ea.eqv2_attention(x, xi, t["idx"], t["d"], xe, t["maskf"], t["dropk"], *ws,
                            **inp["dims"])
    _close(got.detach().numpy(), np.asarray(out), FWD_REL, "agg")
    got.backward(t["g"])
    for n, p, w_ in zip(["x", "xi", "xe"] + ea.weight_names(1), [x, xi, xe, *ws], grads):
        _close(p.grad.numpy(), w_, BWD_REL, n)


def test_flop_model_and_shapes():
    b, a, k = 64, 48, 30
    per = ea.edge_fwd_flops(256, 128, 384, 6, 2, 196, 8, 64)
    gather = b * a * 2 * 49 * k * a * 128
    assert b * a * k * per == ak.attn_fwd_flops(b, a, k, 256, 128, 384, 6, 2, 196, 8, 64) - gather
    assert 35.0e6 < per < 36.0e6  # ~35.6 MFLOP a live edge at EquiformerV2's widths
    shapes = ea.weight_shapes(6, 2, 128, 128, 384, 8, 64)
    assert shapes[:3] == [(384, 1792), (1, 1792), (1792, 1536)]
    assert len(shapes) == len(ea.weight_names(2)) == 11


def test_bad_inputs_raise():
    inp = _inputs(5)
    t = _torch(inp)
    args = (t["x"], t["xi"], t["idx"], t["d"], t["xe"], t["maskf"], t["dropk"])
    with pytest.raises(ValueError, match="weight arrays"):
        ea.eqv2_fwd(*args, *t["ws"][:-1], **inp["dims"])
    with pytest.raises(ValueError, match="shape"):
        ea.eqv2_fwd(t["x"], t["xi"], t["idx"], t["d"][..., :-1], *args[4:], *t["ws"],
                    **inp["dims"])
    with pytest.raises(ValueError, match="integer"):
        ea.eqv2_fwd(t["x"], t["xi"], t["idx"].float(), *args[3:], *t["ws"], **inp["dims"])


def test_graph_helpers_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 4, 3)).astype(np.float32)
    idx = rng.integers(0, 7, (2, 7, 5))
    got = graph.gather_nodes(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_graph.gather_nodes(jnp.asarray(x),
                                                                         jnp.asarray(idx))))
    unit = rng.normal(size=(2, 7, 5, 3)).astype(np.float32)
    mask = rng.random((2, 7, 5)) > 0.4
    got = graph.edge_rotation_vectors(torch.from_numpy(unit), torch.from_numpy(mask)).numpy()
    want = jax_graph.edge_rotation_vectors(jnp.asarray(unit), jnp.asarray(mask))
    np.testing.assert_array_equal(got, np.asarray(want))
