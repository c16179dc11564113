"""The port's bf16 DimeNet++ and Graphormer3D against the JAX package's, on
the CPU, at tests/models/test_bf16_zoo.py's SMALL sizes and batch.

E and F of compute_dtype="bfloat16" on the same converted weights (DimeNet++'s
zero-initialised output projections given weight, so that E and F are not
0), and the same conversion driving both dtypes. Each tolerance is stated
below and the test asserts that JAX's own bf16-vs-float32 difference on the
same inputs breaks it. JAX runs jitted with XLA's excess precision off
(tests/test_torch_painn_bf16.py `exact_jit`: every op rounds its bf16
result). The port rounds where the JAX program does (models/base.py `silu`,
`gelu`; DimeNet++'s Σ_m as a dot; constants rounded to bf16 as JAX rounds
its weakly typed ones), so E and Graphormer3D's direct F agree to float32
rounding; DimeNet++'s F = -dE/dpos goes through a backward whose bf16 sums
the two frameworks accumulate differently.
"""

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models.base import forward as jax_forward
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models import create_model, forward
from nabladft_tpu_torch.models.convert import flax_params_of, load_flax_params
from tests.models.test_bf16_zoo import SMALL, mk_batch
from tests.test_torch_painn_bf16 import exact_jit

DTYPES = ("float32", "bfloat16")
TOL = {  # (E, F) as a share of max |E|, max |F| of the float32 model
    "dimenetpp": (1e-4, 8e-3),     # F through the backward: roundings placed differently
    "graphormer3d": (1e-4, 1e-4),  # direct F: XLA's bf16 evaluation followed
    "gemnet_oc": (1e-4, 1e-4),     # direct F
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_kw(name):
    return {k: v for k, v in SMALL[name].items() if k != "remat"}


def _torch_batch(batch):
    b, a = batch.z.shape
    return MolBatch(z=torch.from_numpy(batch.z), pos=torch.from_numpy(batch.pos),
                    node_mask=torch.from_numpy(batch.node_mask),
                    graph_mask=torch.from_numpy(batch.graph_mask), energy=torch.zeros(b),
                    forces=torch.zeros(b, a, 3), mol_id=torch.from_numpy(batch.mol_id))


@pytest.fixture(scope="module", params=sorted(TOL))
def family(request):
    """(name, flax params, {dtype: JAX (E, F)}, port's bf16 (E, F))."""
    name, batch = request.param, mk_batch(np.random.default_rng(0))
    # the port's seeded weights as the flax tree (no JAX init to compile)
    params = flax_params_of(create_model(name, device="cpu",
                                         generator=torch.Generator().manual_seed(0),
                                         **_port_kw(name)))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: ((rng.normal(size=x.shape) * 0.3).astype(np.float32)
                         if any("lin_out" in str(k) for k in path) else x), params)
    jax_out = {}
    for dt in DTYPES:
        model = jax_create_model(name, compute_dtype=dt, **SMALL[name])
        out = exact_jit(lambda p, b: jax_forward(model, p, b), params, batch)
        jax_out[dt] = (np.asarray(out["energy"]), np.asarray(out["forces"]))
    port = load_flax_params(create_model(name, device="cpu", compute_dtype="bfloat16",
                                         **_port_kw(name)), params).eval()
    out = forward(port, _torch_batch(batch))
    return name, params, jax_out, (out["energy"].numpy(), out["forces"].numpy())


def test_bf16_energy_and_forces_match_jax(family):
    name, _, jax_out, port = family
    for i, what in enumerate(("E", "F")):
        ref, ref32 = jax_out["bfloat16"][i], jax_out["float32"][i]
        tol = TOL[name][i] * np.abs(ref32).max()
        gap = np.abs(ref - ref32).max()
        assert port[i].dtype == np.float32 and np.isfinite(port[i]).all(), what
        assert np.abs(port[i] - ref).max() <= tol, (
            name, what, np.abs(port[i] - ref).max() / np.abs(ref32).max(),
            gap / np.abs(ref32).max())
        assert tol < gap, (name, what, tol, gap)


def test_converted_weights_drive_both_dtypes(family):
    name, params, _, _ = family
    m32 = load_flax_params(create_model(name, device="cpu", **_port_kw(name)), params)
    m16 = load_flax_params(create_model(name, device="cpu", compute_dtype="bfloat16",
                                        **_port_kw(name)), params)
    s32, s16 = m32.state_dict(), m16.state_dict()
    assert s32.keys() == s16.keys()
    assert all(s16[k].dtype == s32[k].dtype and torch.equal(s32[k], s16[k]) for k in s32)
