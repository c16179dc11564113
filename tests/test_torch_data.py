"""The port's data layer against the JAX package's on one seeded database.

The same ASE DB (two byte-identical copies, so each package parses and
caches its own) must give identical batches through
EnergyDataset -> DataModule loaders: bucket shapes, padding, order, mol_id.
"""

import shutil

import numpy as np
import pytest
import torch

from nabladft_tpu.data import ase_codec as jax_codec
from nabladft_tpu.data import dataset as jax_dataset
from nabladft_tpu_torch.data import dataset as torch_dataset
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


FIELDS = ("z", "pos", "node_mask", "graph_mask", "energy", "forces", "mol_id")
BUCKETS = (16, 32, 40)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    a = write_random_db(root / "jax.db", n_mols=40, min_atoms=5, max_atoms=40, seed=0)
    b = root / "torch.db"
    shutil.copy(a, b)
    return root, a, b


@pytest.fixture(scope="module")
def modules(dbs):
    root, a, b = dbs
    jdm = jax_dataset.DataModule(
        jax_dataset.EnergyDataset(str(a), root=root, bucket_boundaries=BUCKETS),
        batch_size=8, val_fraction=0.2, seed=3)
    tdm = torch_dataset.DataModule(
        torch_dataset.EnergyDataset(str(b), root=root, bucket_boundaries=BUCKETS),
        batch_size=8, val_fraction=0.2, seed=3)
    return jdm, tdm


def _assert_same_batches(jax_loader, torch_loader):
    jb, tb = list(jax_loader), list(torch_loader)
    assert len(jb) == len(tb) == len(torch_loader)
    for x, y in zip(jb, tb):
        for f in FIELDS:
            want = np.asarray(getattr(x, f))
            got = getattr(y, f).numpy()
            assert got.shape == want.shape and got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("split", ["predict", "train", "val"])
def test_loaders_yield_identical_batches(modules, split):
    jdm, tdm = modules
    _assert_same_batches(getattr(jdm, f"{split}_dataloader")(),
                         getattr(tdm, f"{split}_dataloader")())


def test_worker_pool_keeps_the_batch_order(dbs, modules):
    root, _, b = dbs
    jdm, _ = modules
    pooled = torch_dataset.DataModule(
        torch_dataset.EnergyDataset(str(b), root=root, bucket_boundaries=BUCKETS),
        batch_size=8, val_fraction=0.2, seed=3, num_workers=3)
    _assert_same_batches(jdm.train_dataloader(), pooled.train_dataloader())


def test_predict_batches_cover_every_row_once(modules):
    _, tdm = modules
    ids = np.concatenate([b.mol_id.numpy()[b.graph_mask.numpy()]
                          for b in tdm.predict_dataloader()])
    assert sorted(ids.tolist()) == list(range(1, 41))
    shapes = {tuple(b.z.shape) for b in tdm.predict_dataloader()}
    assert shapes <= {(8, a) for a in BUCKETS}


def test_writer_round_trips_through_both_readers(dbs):
    _, a, _ = dbs
    ours = list(AseDatabase(a).select_all())
    theirs = list(jax_codec.AseDatabase(a).select_all())
    assert len(ours) == len(theirs) == 40
    for x, y in zip(ours, theirs):
        np.testing.assert_array_equal(x.numbers, y.numbers)
        np.testing.assert_array_equal(x.positions, y.positions)
        np.testing.assert_array_equal(x.data["forces"], y.data["forces"])
        assert x.data["energy"] == y.data["energy"] and x.id == y.id


def test_cache_is_reused(dbs):
    root, _, b = dbs
    first = torch_dataset.parse_energy_db(b)
    again = torch_dataset.parse_energy_db(b)
    assert isinstance(again.z, np.memmap)
    np.testing.assert_array_equal(first.offsets, again.offsets)


def test_oversize_molecules_get_a_bucket(dbs):
    root, _, b = dbs
    ds = torch_dataset.EnergyDataset(str(b), root=root, bucket_boundaries=(16, 32))
    assert ds.bucket_boundaries == (16, 32, 40) and (ds.bucket_of >= 0).all()


def test_missing_source_raises(tmp_path):
    """A source that is neither a file nor a split of the registry (a
    registry split would be fetched: tests/test_torch_registry.py)."""
    with pytest.raises(FileNotFoundError, match="registry"):
        torch_dataset.EnergyDataset("dataset_train_nonexistent", root=tmp_path)
