"""The port's optimize job with a bf16 PaiNN against the JAX package's bf16
relaxation, on the CPU.

configs/painn-oc_optim.yaml with model.kwargs.compute_dtype=bfloat16 at a
small width (hidden 16, 2 interactions, 8 RBF) over the seeded DB of
tests/test_torch_optimize_task.py (12 molecules of 4-20 atoms, one bucket),
with the port's seeded weights carried into both packages as one flax tree.
JAX runs `lbfgs_relax` over its `BatchwiseCalculator` jitted with XLA's
excess precision off (`exact_jit`: each op rounds its bf16 result, as the
program is written), as the port's plain bf16 path rounds.

* The initial E and F of the two calculators: E within E_REL x max |E| and F
  within F_REL["off"] x max |F| (tests/test_torch_painn_bf16.py's
  tolerances for the plain bf16 model; the port lies 2.4e-6 and 5.0e-3 off
  JAX here), and JAX's own bf16-vs-float32 E gap on the same inputs (1.0e-2)
  breaks the E tolerance.
* The job (`pipelines.run`) two L-BFGS iterations in: the written positions
  within POS_ATOL of JAX's, POS_ATOL = F_REL["off"] x max |F| in Å. With
  alpha 1 the first step is F itself (Å per Hartree/Å; maxstep only shrinks
  it), so the F tolerance moves the positions by as much; the second step
  may amplify a gap 3-5x (L-BFGS at painn-oc width), and the F gap seen (5.0e-3)
  leaves that room. Seen: <= 1.35e-3 Å, against JAX's own bf16-vs-float32
  gap of <= 3.3e-3 Å.
* The L-BFGS state stays in the positions' dtype (float32): the restart
  pickle's arrays are float32, as JAX's.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu.data.dataset import BucketedLoader as JaxLoader
from nabladft_tpu.data.dataset import EnergyDataset as JaxDataset
from nabladft_tpu.data.dataset import LoaderConfig as JaxLoaderConfig
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.optimize.calculator import BatchwiseCalculator as JaxCalculator
from nabladft_tpu.optimize.lbfgs import lbfgs_relax as jax_lbfgs_relax
from nabladft_tpu_torch import pipelines
from nabladft_tpu_torch.data.ase_codec import AseDatabase
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models.convert import flax_params_of
from nabladft_tpu_torch.optimize.calculator import BatchwiseCalculator
from nabladft_tpu_torch.optimize.task import build_optimize_model
from tests.test_torch_optimize_task import BUCKET, N_MOLS, SMALL, optim_config, write_optim_db
from tests.test_torch_painn_bf16 import E_REL, F_REL, exact_jit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEPS = 2
F_TOL_REL = F_REL["off"]
POS_REL = F_TOL_REL  # of max |F| (Hartree/Å), in Å: see the module docstring
BF16 = {"compute_dtype": "bfloat16"}


def bf16_config(src, root, out: str) -> dict:
    cfg = optim_config(src, root, out)
    cfg["model"] = dict(cfg["model"], kwargs=dict(cfg["model"]["kwargs"], **BF16))
    cfg["optimize"] = dict(cfg["optimize"], steps=STEPS, trajectory_dir=None)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(root, cfg, flax params, JAX batch, JAX {dtype: (E, F, positions
    after STEPS iterations; float32 unrelaxed)}, the port job's stats)."""
    root = tmp_path_factory.mktemp("torch_optimize_bf16")
    src = write_optim_db(root / "input.db")
    cfg = bf16_config(src, root, "torch")
    port32 = pipelines.build_model(dict(cfg, model=dict(cfg["model"], kwargs=SMALL)),
                                   torch.device("cpu"))
    params = flax_params_of(port32)
    ds = JaxDataset(str(src), bucket_boundaries=(BUCKET,))
    (jb,) = list(JaxLoader(ds, config=JaxLoaderConfig(batch_size=16, shuffle=False)))
    o = cfg["optimize"]
    jax_out = {}
    for dt in ("float32", "bfloat16"):
        model = jax_create_model("painn", compute_dtype=dt, **SMALL)

        def run(p, b, _m=model, _relax=dt == "bfloat16"):
            calc = JaxCalculator(_m, p)
            if not _relax:  # float32: the initial E and F only
                return calc(b), b.pos
            res = jax_lbfgs_relax(calc, b, fmax=o["fmax"], max_steps=STEPS,
                                  memory=o["memory"], maxstep=o["maxstep"])
            return calc(b), res.pos

        (e, f), pos = exact_jit(run, params, jb)
        jax_out[dt] = (np.asarray(e), np.asarray(f), np.asarray(pos))
    stats = pipelines.run(cfg, device="cpu", params=params)
    return root, cfg, params, jb, jax_out, stats


def test_initial_energy_and_forces_match_jax(runs):
    _, cfg, params, jb, jax_out, _ = runs
    calc = BatchwiseCalculator(build_optimize_model(cfg, torch.device("cpu"), params))
    assert calc.model.cdt == torch.bfloat16 and calc.model.use_pallas == "off"
    batch = MolBatch(**{k: torch.from_numpy(np.asarray(getattr(jb, k))) for k in
                        ("z", "pos", "node_mask", "graph_mask", "energy", "forces", "mol_id")})
    e, f = (t.numpy() for t in calc(batch))
    assert e.dtype == f.dtype == np.float32
    (e16, f16, _), (e32, f32, _) = jax_out["bfloat16"], jax_out["float32"]
    for got, want, ref32, rel in ((e, e16, e32, E_REL), (f, f16, f32, F_TOL_REL)):
        tol = rel * np.abs(ref32).max()
        assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)
    assert np.abs(e16 - e32).max() > E_REL * np.abs(e32).max()  # bf16 is not float32 here


def test_positions_after_two_iterations_match_jax(runs):
    root, _, _, jb, jax_out, stats = runs
    assert stats["n_molecules"] == N_MOLS and stats["total_lbfgs_steps"] == STEPS
    want = jax_out["bfloat16"][2]
    atol = POS_REL * np.abs(jax_out["float32"][1]).max()
    rows = list(AseDatabase(root / "torch.db").select_all())
    src = list(AseDatabase(root / "input.db").select_all())
    slot = {int(m): i for i, m in enumerate(np.asarray(jb.mol_id)) if m >= 0}
    moved = 0.0
    for k, (row, s) in enumerate(zip(rows, src)):
        i = slot[k + 1]  # ASE row ids count from 1
        n = row.natoms
        np.testing.assert_allclose(row.positions, want[i, :n], rtol=0, atol=atol)
        moved = max(moved, float(np.abs(row.positions - s.positions).max()))
    assert moved > 10 * atol  # the two iterations moved the atoms past the limit


def test_lbfgs_state_stays_in_the_positions_dtype(runs):
    root, _, _, _, _, _ = runs
    state = pickle.loads((root / "restart_torch.pkl").read_bytes())
    floats = {k: v.dtype for k, v in state.items() if np.issubdtype(v.dtype, np.floating)}
    assert floats and set(floats.values()) == {np.dtype(np.float32)}, floats
