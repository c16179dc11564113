"""The port's optimize job end to end against the JAX package's, on the CPU.

`job_type: optimize` of configs/painn-oc_optim.yaml runs in both packages on
one seeded DB (12 molecules of 4-20 atoms in one bucket, some rows without
energy or forces, every row with key-value metadata) with the same PaiNN
weights: the JAX job's initial weights (`model.init` with key 0 on its probe
batch) carried across with `load_flax_params`. Small widths (2
interactions, hidden 16, 8 RBF), 8 L-BFGS steps, memory 4, trajectories
every 4 steps and a restart file. Positions within 1e-4 Å; `model_energy` and
`model_forces` within the model tolerances of tests/test_torch_pipeline.py.
Then the CLI on the CPU, and the restore of a checkpoint the port wrote and
of a flax TrainState of the JAX package (`ckpt_path`).
"""

import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu import pipelines as jax_pipelines
from nabladft_tpu.data.dataset import BucketedLoader as JaxLoader
from nabladft_tpu.data.dataset import EnergyDataset as JaxDataset
from nabladft_tpu.data.dataset import LoaderConfig as JaxLoaderConfig
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu_torch import pipelines
from nabladft_tpu_torch.config import load_config
from nabladft_tpu_torch.data.ase_codec import AseDatabase, AtomsRecord
from nabladft_tpu_torch.data.synthetic import random_molecule


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parent.parent
SMALL = dict(hidden=16, n_interactions=2, n_rbf=8)
N_MOLS, BUCKET = 12, 24
POS_ATOL = 1e-4  # Å
E_TOL = dict(rtol=2e-4, atol=1e-5)  # tests/test_torch_pipeline.py
F_TOL = dict(rtol=2e-3, atol=2e-4)


def write_optim_db(path: Path, seed: int = 3) -> Path:
    """N_MOLS molecules of 4-20 atoms; every third row carries no energy and
    no forces (as the reference's optimisation fixture stores none)."""
    rng = np.random.default_rng(seed)
    db = AseDatabase(path, create=True)
    try:
        for i in range(N_MOLS):
            n = int(rng.integers(4, 21))
            z, pos = random_molecule(rng, n)
            data = ({} if i % 3 == 0 else
                    {"energy": [float(rng.normal())], "forces": rng.normal(size=(n, 3))})
            db.write(AtomsRecord(z, pos, key_value_pairs={
                "moses_id": 100 + i, "conformation_id": i % 2, "smiles": "C" * (i + 1)},
                data=data))
    finally:
        db.close()
    return path


def optim_config(src: Path, root: Path, out: str) -> dict:
    return load_config(REPO / "configs" / "painn-oc_optim.yaml", overrides={
        "model": {"kwargs": SMALL},
        "datamodule": {"source": str(src), "root": str(root)},
        "optimize": {"batch_size": 16, "steps": 8, "memory": 4, "bucket_boundaries": [BUCKET],
                     "trajectory_dir": str(root / f"traj_{out}"), "trajectory_interval": 4,
                     "restart_path": str(root / f"restart_{out}.pkl")},
        "output_db": str(root / f"{out}.db"),
    })


def jax_initial_params(cfg: dict):
    """The weights JAX's run_optimize_job draws without a checkpoint."""
    o = cfg["optimize"]
    model = jax_create_model(cfg["model"]["name"], **cfg["model"]["kwargs"])
    ds = JaxDataset(cfg["datamodule"]["source"], bucket_boundaries=tuple(o["bucket_boundaries"]))
    probe = next(iter(JaxLoader(ds, config=JaxLoaderConfig(batch_size=2, shuffle=False))))
    return jax.device_get(model.init(jax.random.PRNGKey(0), probe))


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """(root, JAX stats, port stats) of the same optimize job."""
    root = tmp_path_factory.mktemp("torch_optimize")
    src = write_optim_db(root / "input.db")
    jcfg = optim_config(src, root, "jax")
    jstats = jax_pipelines.run(jcfg)
    tstats = pipelines.run(optim_config(src, root, "torch"), device="cpu",
                           params=jax_initial_params(jcfg))
    return root, jstats, tstats


def _rows(path):
    return list(AseDatabase(path).select_all())


def test_stats_match_jax(jobs):
    _, jstats, tstats = jobs
    assert tstats["n_molecules"] == jstats["n_molecules"] == N_MOLS
    for k in ("n_converged", "converged_fraction", "total_lbfgs_steps"):
        assert tstats[k] == jstats[k], k
    assert tstats["batches"] == 1 and tstats["total_lbfgs_steps"] == 8
    assert tstats["seconds"] > 0


def test_rows_and_metadata_match_jax(jobs):
    root, _, _ = jobs
    src, jrows, trows = (_rows(root / f"{n}.db") for n in ("input", "jax", "torch"))
    assert len(trows) == len(jrows) == len(src) == N_MOLS
    for s, j, t in zip(src, jrows, trows):
        np.testing.assert_array_equal(t.numbers, s.numbers)
        assert t.key_value_pairs == j.key_value_pairs == s.key_value_pairs
        assert set(t.data) == set(j.data) == set(s.data) | {"model_energy", "model_forces"}
        for k in s.data:
            np.testing.assert_array_equal(t.data[k], s.data[k])


def test_relaxed_positions_match_jax(jobs):
    root, _, _ = jobs
    moved = 0.0
    for s, j, t in zip(*(_rows(root / f"{n}.db") for n in ("input", "jax", "torch"))):
        np.testing.assert_allclose(t.positions, j.positions, rtol=0, atol=POS_ATOL)
        moved = max(moved, float(np.abs(t.positions - s.positions).max()))
    assert moved > 0.05  # the relaxation moved atoms


def test_model_energy_and_forces_match_jax(jobs):
    root, _, _ = jobs
    for j, t in zip(_rows(root / "jax.db"), _rows(root / "torch.db")):
        np.testing.assert_allclose(t.data["model_energy"], j.data["model_energy"], **E_TOL)
        assert t.data["model_forces"].shape == (t.natoms, 3)
        np.testing.assert_allclose(t.data["model_forces"], j.data["model_forces"], **F_TOL)


def _read_extxyz(path: Path):
    """[(symbols, positions [n,3], comment)] of each frame."""
    lines = path.read_text().splitlines()
    frames, i = [], 0
    while i < len(lines):
        n = int(lines[i])
        body = [ln.split() for ln in lines[i + 2:i + 2 + n]]
        frames.append(([b[0] for b in body], np.array([b[1:4] for b in body], float),
                       lines[i + 1]))
        i += 2 + n
    return frames


def test_trajectories_match_jax(jobs):
    root, _, _ = jobs
    names = sorted(p.name for p in (root / "traj_jax").iterdir())
    assert names == sorted(p.name for p in (root / "traj_torch").iterdir())
    assert len(names) == N_MOLS
    for name in names:
        jf = _read_extxyz(root / "traj_jax" / name)
        tf = _read_extxyz(root / "traj_torch" / name)
        assert len(tf) == len(jf) == 3  # iterations 0, 4 and 8
        for (js, jp, jc), (ts, tp, tc) in zip(jf, tf):
            assert ts == js
            np.testing.assert_allclose(tp, jp, rtol=0, atol=POS_ATOL)
            assert tc.split(" energy=")[0] == jc.split(" energy=")[0]
            np.testing.assert_allclose(float(tc.split("energy=")[1]),
                                       float(jc.split("energy=")[1]), **E_TOL)


def test_restart_files_match_jax(jobs):
    root, _, _ = jobs
    jst = pickle.loads((root / "restart_jax.pkl").read_bytes())
    tst = pickle.loads((root / "restart_torch.pkl").read_bytes())
    assert list(tst) == list(jst)
    for k in jst:
        assert tst[k].dtype == jst[k].dtype and tst[k].shape == jst[k].shape, k
    assert int(tst["iteration"]) == int(jst["iteration"]) == 8
    np.testing.assert_allclose(tst["pos"], jst["pos"], rtol=0, atol=POS_ATOL)
    assert ((root / "restart_torch.meta").read_text()
            == (root / "restart_jax.meta").read_text() == "0")


def test_cli_optimize_on_cpu(tmp_path):
    from nabladft_tpu_torch import cli

    src = write_optim_db(tmp_path / "input.db")
    out = tmp_path / "out.db"
    assert cli.main([
        "--config", str(REPO / "configs" / "painn-oc_optim.yaml"), "--device", "cpu",
        f"datamodule.source={src}", f"datamodule.root={tmp_path}", f"output_db={out}",
        "model.kwargs.hidden=16", "model.kwargs.n_interactions=1", "model.kwargs.n_rbf=8",
        "optimize.steps=3", "optimize.line_search=mt",
    ]) == 0
    rows = _rows(out)
    assert len(rows) == N_MOLS
    assert all(np.isfinite(r.positions).all() and np.isfinite(r.data["model_forces"]).all()
               for r in rows)


def test_optimize_restores_a_port_checkpoint(tmp_path):
    """`ckpt_path` loads the "model" entry of a checkpoint the port's
    trainer wrote: the job then relaxes with those weights."""
    import torch

    src = write_optim_db(tmp_path / "input.db")
    cfg = optim_config(src, tmp_path, "a")
    cfg["optimize"] = dict(cfg["optimize"], steps=2, trajectory_dir=None, restart_path=None)
    model = pipelines.build_model(cfg, torch.device("cpu"))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    torch.save({"step": 0, "model": model.state_dict()}, tmp_path / "model.ckpt")
    pipelines.run(dict(cfg, ckpt_path=str(tmp_path / "model.ckpt")), device="cpu")
    pipelines.run(dict(cfg, output_db=str(tmp_path / "b.db")), device="cpu")
    ea = [r.data["model_energy"][0] for r in _rows(tmp_path / "a.db")]
    eb = [r.data["model_energy"][0] for r in _rows(tmp_path / "b.db")]
    assert not np.allclose(ea, eb)


def test_optimize_restores_a_flax_checkpoint(jobs):
    """`ckpt_path` may be a flax TrainState of the JAX package: it gives up
    its params, as in the JAX job. The JAX job's initial weights in one
    relax as the weights carried across with `params` did."""
    import optax
    from flax import serialization

    from nabladft_tpu.train.state import TrainState

    root, _, _ = jobs
    cfg = optim_config(root / "input.db", root, "flax")
    state = TrainState.create(jax_initial_params(cfg), optax.adam(1e-3), ema=True)
    (root / "jax_state.ckpt").write_bytes(serialization.to_bytes(state))
    cfg["optimize"] = dict(cfg["optimize"], trajectory_dir=None, restart_path=None)
    pipelines.run(dict(cfg, ckpt_path=str(root / "jax_state.ckpt")), device="cpu")
    got, want = _rows(root / "flax.db"), _rows(root / "torch.db")
    assert len(got) == len(want) == N_MOLS
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.positions, b.positions)
        assert a.data["model_energy"] == b.data["model_energy"]


def test_chip_smoke_optimize_config_is_the_composed_yaml():
    import sys

    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    want = load_config(REPO / "configs" / "painn-oc_optim.yaml", overrides={
        "datamodule": {"source": "/db/in.db", "root": "/db"}, "ckpt_path": "/db/best.ckpt",
        "output_db": "/db/out.db",
        "optimize": {"steps": chip_smoke.OPT_STEPS, "line_search": "off"}})
    assert chip_smoke.optimize_config("/db/in.db", "/db", "/db/best.ckpt", "/db/out.db") == want
