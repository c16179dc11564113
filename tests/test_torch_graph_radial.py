"""The port's graph and radial ops against the JAX package's.

Values of dense_graph / dense_topk_mask (with an exact-tie geometry), the
radial bases and envelopes, the detached rbfp = ∂(basis·env)/∂dist, and
gradients wrt positions through dist and unit. Tolerance rtol 1e-5,
atol 1e-6 (float32, same formulas).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.ops import graph as jgraph
from nabladft_tpu.ops import radial as jradial
from nabladft_tpu_torch.ops import graph as tgraph
from nabladft_tpu_torch.ops import radial as tradial


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
CUTOFF = 5.0


def _batch(seed=0, b=3, a=12):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3.0, 3.0, size=(b, a, 3)).astype(np.float32)
    node_mask = np.ones((b, a), bool)
    node_mask[1, 9:] = False
    node_mask[2, 5:] = False
    return pos, node_mask


def _close(got: torch.Tensor, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=kw.get("rtol", RTOL), atol=kw.get("atol", ATOL))


def test_dense_graph_matches():
    pos, mask = _batch()
    j = jgraph.dense_graph(jnp.asarray(pos), jnp.asarray(mask), CUTOFF)
    t = tgraph.dense_graph(torch.from_numpy(pos), torch.from_numpy(mask), CUTOFF)
    _close(t.diff, j.diff)
    _close(t.dist, j.dist)
    np.testing.assert_array_equal(t.adj.numpy(), np.asarray(j.adj))


@pytest.mark.parametrize("k", [3, 6, 11, 40])
def test_dense_topk_mask_matches(k):
    pos, mask = _batch(seed=1)
    j = jgraph.dense_graph(jnp.asarray(pos), jnp.asarray(mask), CUTOFF)
    t = tgraph.dense_graph(torch.from_numpy(pos), torch.from_numpy(mask), CUTOFF)
    want = np.asarray(jgraph.dense_topk_mask(j.dist, j.adj, k))
    got = tgraph.dense_topk_mask(t.dist, t.adj, k).numpy()
    np.testing.assert_array_equal(got, want)


def test_dense_topk_mask_keeps_exact_ties():
    """An octahedron around a centre: six neighbours at exactly 1.5 Å. With
    k=4 both packages keep all six (the 1e-7 tie rule), not four."""
    oct_ = np.array([[1.5, 0, 0], [-1.5, 0, 0], [0, 1.5, 0], [0, -1.5, 0],
                     [0, 0, 1.5], [0, 0, -1.5]], np.float32)
    pos = np.concatenate([np.zeros((1, 3), np.float32), oct_])[None]
    pos = np.concatenate([pos, np.zeros((1, 1, 3), np.float32)], axis=1)  # one padding atom
    mask = np.array([[True] * 7 + [False]])
    j = jgraph.dense_graph(jnp.asarray(pos), jnp.asarray(mask), CUTOFF)
    t = tgraph.dense_graph(torch.from_numpy(pos), torch.from_numpy(mask), CUTOFF)
    want = np.asarray(jgraph.dense_topk_mask(j.dist, j.adj, 4))
    got = tgraph.dense_topk_mask(t.dist, t.adj, 4).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0].sum() == 6


D = np.linspace(0.0, 6.0, 97, dtype=np.float32).reshape(97, 1)


@pytest.mark.parametrize("name", ["gaussian", "bessel"])
def test_radial_bases_match(name):
    jf = {"gaussian": jradial.gaussian_rbf, "bessel": jradial.bessel_rbf}[name]
    tf = {"gaussian": tradial.gaussian_rbf, "bessel": tradial.bessel_rbf}[name]
    _close(tf(torch.from_numpy(D), 16, CUTOFF), jf(jnp.asarray(D), 16, CUTOFF))


def test_envelopes_match():
    d = torch.from_numpy(D)
    _close(tradial.polynomial_envelope(d / CUTOFF, 5),
           jradial.polynomial_envelope(jnp.asarray(D) / CUTOFF, 5))
    _close(tradial.cosine_cutoff(d, CUTOFF), jradial.cosine_cutoff(jnp.asarray(D), CUTOFF))


# the cases whose rbfp also agrees with jax.jvp's float32 rounding within
# RTOL / ATOL; in the other, both sit within fp32 rounding of the float64
# derivative but not of each other (3.0e-6 apart; 2.1e-6 and 1.8e-6 from it)
JAX_ROUNDING = {("gaussian", "polynomial"), ("gaussian", "cosine"), ("bessel", "cosine")}


@pytest.mark.parametrize("rbf,envelope", [
    ("gaussian", "polynomial"), ("gaussian", "cosine"), ("bessel", "polynomial"),
    ("bessel", "cosine")])
def test_rbfp_matches_jax_jvp(rbf, envelope):
    """The detached basis derivative the fused kernels take: the port's
    PaiNN.features (closed-form jvps) against jax.jvp of the JAX filter, and
    both against jax.jvp in float64: the port's largest error from it at
    most twice JAX's own, plus 1e-7."""
    from nabladft_tpu_torch.models.painn import PaiNN

    case = (rbf, envelope)
    pos, mask = _batch(seed=2)
    model = PaiNN(hidden=8, n_interactions=1, n_rbf=10, max_neighbors=7, rbf=rbf,
                  envelope=envelope, use_pallas="fused", device="cpu")
    feats = model.features(_torch_batch(pos, mask))

    def filt(d, adj):
        rb = (jradial.gaussian_rbf if rbf == "gaussian" else jradial.bessel_rbf)(d, 10, CUTOFF)
        env = (jradial.polynomial_envelope(d / CUTOFF, 5) if envelope == "polynomial"
               else jradial.cosine_cutoff(d, CUTOFF))
        return jnp.where(adj[..., None], rb * env[..., None], 0.0)

    dg = jgraph.dense_graph(jnp.asarray(pos), jnp.asarray(mask), CUTOFF)
    adj = jgraph.dense_topk_mask(dg.dist, dg.adj, 7)
    dist = jnp.where(adj, dg.dist, 0.0)
    rbf, rbfp = jax.jvp(lambda d: filt(d, adj), (dist,), (jnp.ones_like(dist),))
    with jax.enable_x64(True):
        d64 = jnp.asarray(np.asarray(dist), dtype=jnp.float64)
        _, rbfp64 = jax.jvp(lambda d: filt(d, adj), (d64,), (jnp.ones_like(d64),))
        rbfp64 = np.asarray(rbfp64)
    assert rbfp64.dtype == np.float64
    _close(feats["dist"], dist)
    _close(feats["rbf_env"], rbf)
    err_port = np.abs(feats["rbfp"].detach().numpy().astype(np.float64) - rbfp64).max()
    err_jax = np.abs(np.asarray(rbfp, dtype=np.float64) - rbfp64).max()
    assert err_port <= 2.0 * err_jax + 1e-7, (err_port, err_jax)
    if case in JAX_ROUNDING:
        _close(feats["rbfp"], rbfp)


def _torch_batch(pos, mask):
    from nabladft_tpu_torch.data.batch import MolBatch

    b, a = mask.shape
    return MolBatch(
        z=torch.ones((b, a), dtype=torch.int32), pos=torch.from_numpy(pos),
        node_mask=torch.from_numpy(mask), graph_mask=torch.ones(b, dtype=torch.bool),
        energy=torch.zeros(b), forces=torch.zeros(b, a, 3),
        mol_id=torch.arange(b, dtype=torch.int32),
    )


def test_position_gradients_through_dist_and_unit():
    """d/dpos of Σ s1·dist_masked + Σ s2·unit, as the PaiNN forward builds
    them (dist zeroed and unit = diff/dist off the kept edges)."""
    pos, mask = _batch(seed=3)
    rng = np.random.default_rng(4)
    s1 = rng.normal(size=mask.shape + mask.shape[-1:]).astype(np.float32)
    s2 = rng.normal(size=s1.shape + (3,)).astype(np.float32)

    def jloss(p):
        dg = jgraph.dense_graph(p, jnp.asarray(mask), CUTOFF)
        adj = jgraph.dense_topk_mask(dg.dist, dg.adj, 7)
        dist = jnp.where(adj, dg.dist, 0.0)
        unit = jnp.where(adj[..., None], dg.diff / jnp.maximum(dg.dist, 1e-10)[..., None], 0.0)
        return (s1 * dist).sum() + (s2 * unit).sum()

    want = jax.grad(jloss)(jnp.asarray(pos))

    p = torch.from_numpy(pos).requires_grad_(True)
    dg = tgraph.dense_graph(p, torch.from_numpy(mask), CUTOFF)
    adj = tgraph.dense_topk_mask(dg.dist, dg.adj, 7)
    dist = torch.where(adj, dg.dist, torch.zeros_like(dg.dist))
    unit = dg.diff / torch.clamp(dg.dist, min=1e-10)[..., None]
    unit = torch.where(adj[..., None], unit, torch.zeros_like(unit))
    ((torch.from_numpy(s1) * dist).sum() + (torch.from_numpy(s2) * unit).sum()).backward()
    _close(p.grad, want)
