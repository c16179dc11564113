"""eSCN's host tables and graph / SO(3) helpers against the JAX package's.

At escn-oc's l_max 6, m_max 2 (S_t 29, K 235, the per-edge grid 7 x 5 and
the node grid 7 x 13 from grid_points 98):
* the float64 host tables (Fibonacci points, SH on them, both S2 grids, the
  truncated grid's m-major tables and separable factors) equal JAX's to
  1e-12, and from_grid @ to_grid = I on the full grid;
* layouts (m-major rows / columns, the compact Wigner layout, spans, S_t)
  and the FLOP models are equal;
* rot_to_z, the compact truncated Wigner values (the first 235 of JAX's 256
  lanes), neighbor_list (ties to the lower index, as lax.top_k),
  dense_from_neighbor_list and gaussian_smearing (400 centres on [0, 8] Å)
  in float32 to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.models import escn as JE
from nabladft_tpu.ops import graph as jgraph
from nabladft_tpu.ops import radial as jradial
from nabladft_tpu.ops import so3 as jso3
from nabladft_tpu.ops.pallas import escn_layer as JK
from nabladft_tpu_torch.ops import escn_layer as el
from nabladft_tpu_torch.ops import graph, radial, so3

L, M, NG = 6, 2, 98
TOL = dict(rtol=1e-6, atol=1e-6)
TABLE = dict(rtol=0.0, atol=1e-12)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_host_tables_match_jax():
    np.testing.assert_allclose(el.fibonacci_sphere(128), JE._fibonacci_sphere(128), **TABLE)
    np.testing.assert_allclose(el.sh_on_points(L, 128), JE._sh_on_points(L, 128), **TABLE)
    for m_max, n_pts in ((None, 91), (M, 35)):
        got, want = el.grid_mats(L, NG, m_max), JE._grid_mats(L, NG, m_max)
        assert got[0].dtype == np.float64 and got[0].shape == (n_pts, (L + 1) ** 2)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TABLE)
    to_g, from_g = el.grid_mats(L, NG)
    np.testing.assert_allclose(from_g @ to_g, np.eye((L + 1) ** 2), rtol=0.0, atol=1e-12)
    for g, w in zip(el._grid_tables(L, M, NG), JK._grid_tables(L, M, NG)):
        np.testing.assert_allclose(g, w, **TABLE)


def test_grid_factor_tables_match_jax():
    got, want = el._grid_factor_tables(L, M, NG), JK._grid_factor_tables(L, M, NG)
    assert got[-2:] == want[-2:] == (7, 5)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:5], want[1:5]):
        np.testing.assert_allclose(g, w, **TABLE)


def test_layouts_and_flop_models_match_jax():
    assert so3.mmajor_rows(L, M) == jso3.mmajor_rows(L, M)
    np.testing.assert_array_equal(so3.mmajor_cols(L, M), jso3.mmajor_cols(L, M))
    assert so3.trunc_compact_layout(L, M) == jso3.trunc_compact_layout(L, M)
    assert so3.trunc_compact_layout(L, M)[1] == 235
    assert el.s_trunc(L, M) == JK.s_trunc(L, M) == 29
    assert el._spans(L, M) == JK._spans(L, M)
    args = (8, 48, 128, 256, 128, 5 * 256, L, M, NG)
    assert el.layer_fwd_flops(*args) == JK.layer_fwd_flops(*args)
    assert el.layer_bwd_flops(*args) == JK.layer_bwd_flops(*args)


@pytest.fixture(scope="module")
def units():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(40, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    u[:4] = [[0, 0, 1], [0, 0, -1], [0, 0, 0], [1e-9, 0, 1]]
    return u.astype(np.float32)


def test_rot_to_z_matches_jax(units):
    got = so3.rot_to_z(torch.from_numpy(units))
    np.testing.assert_allclose(_np(got), np.asarray(jso3.rot_to_z(jnp.asarray(units))), **TOL)
    live = np.linalg.norm(units, axis=-1) > 0
    np.testing.assert_allclose(_np(got @ torch.from_numpy(units)[..., None])[live, :, 0],
                               np.tile([0.0, 0.0, 1.0], (int(live.sum()), 1)), atol=1e-6)


def test_compact_wigner_matches_jax(units):
    rot = so3.rot_to_z(torch.from_numpy(units))
    got = so3.wigner_trunc_compact_from_rot(rot, L, M)
    want = np.asarray(jso3.wigner_trunc_compact_from_rot(jnp.asarray(_np(rot)), L, M))
    assert got.shape == (40, 235) and want.shape == (40, 256)
    np.testing.assert_allclose(_np(got), want[:, :235], **TOL)
    assert np.abs(want[:, 235:]).max() == 0.0


def _positions(rng, ties: bool):
    b, a = 2, 14
    if ties:  # a cubic lattice: many exactly equal distances
        grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1).reshape(-1, 3)
        pos = np.stack([grid[rng.permutation(27)[:a]] * 1.5 for _ in range(b)])
    else:
        pos = rng.uniform(-3, 3, (b, a, 3))
    mask = np.ones((b, a), bool)
    mask[1, 10:] = False
    return pos.astype(np.float32) * mask[..., None], mask


@pytest.mark.parametrize("ties", [False, True])
def test_neighbor_list_and_dense_scatter_match_jax(ties):
    pos, mask = _positions(np.random.default_rng(1), ties)
    for cutoff, k in ((4.0, 5), (8.0, 40)):
        got = graph.neighbor_list(torch.from_numpy(pos), torch.from_numpy(mask), cutoff, k)
        want = jgraph.neighbor_list(jnp.asarray(pos), jnp.asarray(mask), cutoff, k)
        np.testing.assert_array_equal(_np(got.mask), np.asarray(want.mask))
        np.testing.assert_array_equal(_np(got.idx)[_np(got.mask)],
                                      np.asarray(want.idx)[np.asarray(want.mask)])
        for f in ("dist", "unit"):
            np.testing.assert_allclose(_np(getattr(got, f)), np.asarray(getattr(want, f)), **TOL)
        dense = graph.dense_from_neighbor_list(got, pos.shape[1])
        for g, w in zip(dense, jgraph.dense_from_neighbor_list(want, pos.shape[1])):
            np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def test_gaussian_smearing_matches_jax():
    d = np.random.default_rng(3).uniform(0, 9, (7, 11)).astype(np.float32)
    got = radial.gaussian_smearing(torch.from_numpy(d), 400, 0.0, 8.0)
    want = np.asarray(jradial.gaussian_smearing(jnp.asarray(d), 400, 0.0, 8.0))
    assert got.shape == (7, 11, 400)
    np.testing.assert_allclose(_np(got), want, **TOL)
