"""The port's predict job end to end, and the port's boundaries.

* `job_type: predict` on a seeded DB in both packages with the same weights
  (JAX's seeded init carried across with load_flax_params): the same rows,
  `energy_pred` and `forces_pred` within the PaiNN parity tolerances.
* The CLI runs the same job on the CPU from configs/painn-oc.yaml.
* chip_smoke.py's predict and train configs equal configs/painn-oc.yaml
  with their overrides.
* Neither the port nor chip_smoke.py imports jax, flax, optax or
  nabladft_tpu, and importing the port loads none of them.
* Entry points raise without a card unless the caller names the CPU.
* The optimize job runs on the CPU.
* ``pretrained: PaiNN_train_tiny`` (a seeded schnetpack-named state dict in a
  Lightning .ckpt, found in the cache through a links file of the test's
  own, ``urlopen`` patched to raise) writes the same predict rows as
  `run(cfg, params=...)` with the JAX package's conversion of that state
  dict; an unknown name and an empty flax checkpoint are refused.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nabladft_tpu import pipelines as jax_pipelines
from nabladft_tpu.data.ase_codec import AseDatabase as JaxAseDatabase
from nabladft_tpu_torch import pipelines
from nabladft_tpu_torch.config import load_config
from nabladft_tpu_torch.data.ase_codec import AseDatabase
from nabladft_tpu_torch.data.synthetic import write_random_db


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parent.parent
SMALL = dict(hidden=16, n_interactions=2, n_rbf=8, max_neighbors=7)
E_TOL = dict(rtol=2e-4, atol=1e-5)
F_TOL = dict(rtol=2e-3, atol=2e-4)


def _cfg(db: Path, out: Path, root: Path) -> dict:
    return load_config(
        REPO / "configs" / "painn-oc.yaml",
        overrides={
            "job_type": "predict",
            "model": {"kwargs": SMALL},
            "datamodule": {"source": str(db), "root": str(root), "batch_size": 8,
                           "bucket_boundaries": [32]},
            "output_db": str(out),
            "ckpt_dir": str(root / "ckpt"),
            "output_dir": str(root / "outputs"),
            "log_csv": False,
        },
    )


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipeline")
    return root, write_random_db(root / "input.db", n_mols=20, min_atoms=5, max_atoms=30, seed=1)


def _rows(path):
    return list(AseDatabase(path).select_all())


@pytest.fixture(scope="module")
def predictions(db):
    """(JAX output rows, port output rows) of the same predict job."""
    root, src = db
    jcfg = _cfg(src, root / "jax_out.db", root)
    jax_pipelines.run(jcfg)
    # the weights JAX's run drew: its trainer seed, any probe batch
    dm = jax_pipelines.build_datamodule(jcfg)
    trainer = jax_pipelines.build_trainer(jcfg, dm)
    trainer.init_state(next(iter(dm.predict_dataloader())))
    params = jax.device_get(trainer.state.params)

    tcfg = _cfg(src, root / "torch_out.db", root)
    res = pipelines.run(tcfg, device="cpu", params=params)
    assert res["rows"] == 20
    assert res["batches"] == len(pipelines.build_datamodule(tcfg).predict_dataloader())
    return _rows(root / "jax_out.db"), _rows(root / "torch_out.db")


def test_predict_rows_match_jax(predictions):
    jrows, trows = predictions
    assert len(jrows) == len(trows) == 20
    for j, t in zip(jrows, trows):
        np.testing.assert_array_equal(t.numbers, j.numbers)
        np.testing.assert_array_equal(t.positions, j.positions)
        assert t.data["energy"] == j.data["energy"]


def test_predict_energies_match_jax(predictions):
    jrows, trows = predictions
    np.testing.assert_allclose([t.data["energy_pred"][0] for t in trows],
                               [j.data["energy_pred"][0] for j in jrows], **E_TOL)


def test_predict_forces_match_jax(predictions):
    jrows, trows = predictions
    for j, t in zip(jrows, trows):
        assert t.data["forces_pred"].shape == (t.natoms, 3)
        np.testing.assert_allclose(t.data["forces_pred"], j.data["forces_pred"], **F_TOL)


def test_output_db_reads_back_in_the_jax_codec(db, predictions):
    root, _ = db
    rows = list(JaxAseDatabase(root / "torch_out.db").select_all())
    assert len(rows) == 20 and "forces_pred" in rows[0].data


def test_cli_predict_on_cpu(db, tmp_path):
    from nabladft_tpu_torch import cli

    root, src = db
    out = tmp_path / "cli_out.db"
    assert cli.main([
        "--config", str(REPO / "configs" / "painn-oc.yaml"), "--device", "cpu",
        "job_type=predict", f"datamodule.source={src}", f"datamodule.root={root}",
        f"output_db={out}", "model.kwargs.hidden=16", "model.kwargs.n_interactions=1",
        "model.kwargs.n_rbf=8",
    ]) == 0
    rows = _rows(out)
    assert len(rows) == 20
    assert all(np.isfinite(r.data["forces_pred"]).all() for r in rows)


def test_chip_smoke_config_is_the_composed_yaml():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    want = load_config(
        REPO / "configs" / "painn-oc.yaml",
        overrides={"job_type": "predict",
                   "datamodule": {"source": "/db/in.db", "root": "/db"},
                   "output_db": "/db/out.db"},
    )
    assert chip_smoke.smoke_config("/db/in.db", "/db/out.db", "/db") == want
    want_train = load_config(
        REPO / "configs" / "painn-oc.yaml",
        overrides={"job_type": "train",
                   "datamodule": {"source": "/db/in.db", "root": "/db"},
                   "ckpt_dir": "/db/ckpt", "output_dir": "/db/out",
                   "trainer": {"max_epochs": chip_smoke.TRAIN_EPOCHS, "log_every_n_steps": 1}},
    )
    assert chip_smoke.train_config("/db/in.db", "/db", "/db/ckpt", "/db/out") == want_train


FORBIDDEN = ("jax", "flax", "optax", "msgpack", "nabladft_tpu")


def _port_files():
    return sorted((REPO / "nabladft_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import nabladft_tpu_torch, nabladft_tpu_torch.pipelines, nabladft_tpu_torch.cli\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_run_without_device_raises_when_cuda_is_absent(db, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    root, src = db
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipelines.run(_cfg(src, tmp_path / "out.db", root))
    assert not (tmp_path / "out.db").exists()


def test_optimize_job_runs_on_cpu(db, tmp_path):
    root, src = db
    cfg = dict(_cfg(src, tmp_path / "out.db", root), job_type="optimize",
               optimize={"batch_size": 8, "steps": 3, "bucket_boundaries": [32]})
    stats = pipelines.run(cfg, device="cpu")
    assert stats["n_molecules"] == 20 and stats["batches"] == 3
    assert 0 < stats["total_lbfgs_steps"] <= 3 * stats["batches"]
    assert stats["converged_fraction"] == stats["n_converged"] / 20
    rows = _rows(tmp_path / "out.db")
    assert len(rows) == 20 and all(r.data["model_forces"].shape == (r.natoms, 3) for r in rows)


@pytest.mark.parametrize("what", ["pretrained", "optimize_flax_checkpoint"])
def test_unported_jobs_raise(db, tmp_path, what):
    """What the port refuses at the restore entries, before any output: a
    pretrained name the registry does not hold, and a flax msgpack
    checkpoint (the JAX package's format) with no weights for the model as
    the optimize job's ckpt_path."""
    root, src = db
    cfg = _cfg(src, tmp_path / "out.db", root)
    if what == "pretrained":
        cfg["pretrained"] = "painn-oc"
        match = "unknown checkpoint 'painn-oc'"
    else:
        (tmp_path / "flax.msgpack").write_bytes(b"\x81\xa6params\x80")
        cfg.update(job_type="optimize", ckpt_path=str(tmp_path / "flax.msgpack"))
        match = "no flax leaf"
    with pytest.raises(KeyError, match=match):
        pipelines.run(cfg, device="cpu")
    assert not (tmp_path / "out.db").exists()


def test_pretrained_predict_matches_the_jax_conversion(db, tmp_path, monkeypatch):
    import urllib.request

    from nabladft_tpu.models import create_model as jax_create_model
    from nabladft_tpu.models.pretrained import convert_state_dict as jax_convert
    from tests.models.test_pretrained_converters import mk_batch, painn_state
    from tests.test_torch_pretrained import _cached_checkpoint

    def refuse(*args, **kwargs):
        raise AssertionError("urlopen called")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    root, src = db
    state = painn_state(np.random.default_rng(13))  # hidden 16, 2 layers, 8 RBF: SMALL's
    cache, _ = _cached_checkpoint(tmp_path, "PaiNN_train_tiny", state)
    cfg = dict(_cfg(src, tmp_path / "pretrained.db", root), pretrained="PaiNN_train_tiny",
               pretrained_dir=str(cache), links_path=str(tmp_path / "links.json"))
    assert pipelines.run(cfg, device="cpu")["rows"] == 20

    kw = _cfg(src, tmp_path, root)["model"]["kwargs"]
    params = jax_convert("painn", {k: v.numpy() for k, v in state.items()},
                         jax_create_model("painn", **kw), mk_batch(np.random.default_rng(0)))
    pipelines.run(_cfg(src, tmp_path / "converted.db", root), device="cpu", params=params)
    got, want = _rows(tmp_path / "pretrained.db"), _rows(tmp_path / "converted.db")
    assert [r.data["energy_pred"] for r in got] == [r.data["energy_pred"] for r in want]
    assert all(np.array_equal(a.data["forces_pred"], b.data["forces_pred"])
               for a, b in zip(got, want))
