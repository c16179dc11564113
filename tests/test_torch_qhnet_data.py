"""The port's Hamiltonian data path against the JAX package's.

* The seeded synthetic Hamiltonian DB reads back through the port's own
  reader: rows, basisset table, symmetric matrices of the right size.
* The same DB and seed give identical batches in both packages: joint
  atom x orbital buckets, padding, order and matrices, for the train,
  validation and test loaders over two epochs.
* A molecule above the budget caps is dropped with a warning; a source that
  is not a local file raises.
"""

import logging

import numpy as np
import pytest
import torch

from nabladft_tpu.data.dataset import DataModule as JaxDataModule
from nabladft_tpu.data.dataset import HamiltonianDataset as JaxHamiltonianDataset
from nabladft_tpu_torch.data import DataModule, HamiltonianDataset
from nabladft_tpu_torch.data.hamiltonian_db import HamiltonianDatabase
from nabladft_tpu_torch.data.synthetic import DEF2_SVP_SHELLS, write_random_hamiltonian_db


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOMS, ORBS = (8, 12), (64, 128, 160)
FIELDS = ("z", "pos", "node_mask", "graph_mask", "energy", "forces", "mol_id", "hamiltonian",
          "overlap", "orb_mask")


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ham_data")
    return write_random_hamiltonian_db(root / "ham.db", n_mols=20, min_atoms=3, max_atoms=12,
                                       seed=4)


def test_synthetic_db_reads_back(db):
    h = HamiltonianDatabase(db)
    try:
        assert len(h) == 20
        assert sorted(h.elements()) == sorted(DEF2_SVP_SHELLS)
        counts = h.orbital_counts()
        for rec in h.get_many(range(20)):
            assert rec.pos.shape == (rec.natoms, 3) and rec.natoms >= 3
            assert (rec.z == 1).sum() == rec.natoms // 2
            assert rec.norb == sum(counts[int(z)] for z in rec.z)
            np.testing.assert_array_equal(rec.hamiltonian, rec.hamiltonian.T)
            np.testing.assert_array_equal(rec.overlap, rec.overlap.T)
            assert not rec.core.any()
    finally:
        h.close()


def _modules(db):
    kw = dict(atom_boundaries=ATOMS, orbital_boundaries=ORBS)
    return (DataModule(HamiltonianDataset(str(db), **kw), batch_size=4, val_fraction=0.2, seed=3),
            JaxDataModule(JaxHamiltonianDataset(str(db), **kw), batch_size=4, val_fraction=0.2,
                          seed=3))


@pytest.mark.parametrize("loader", ["train_dataloader", "val_dataloader", "test_dataloader"])
def test_batches_equal_jax(db, loader):
    port, ref = _modules(db)
    assert port.dataset.n_dropped == int((ref.dataset.bucket_of < 0).sum())
    np.testing.assert_array_equal(port.dataset.bucket_of, ref.dataset.bucket_of)
    p_loader, r_loader = getattr(port, loader)(), getattr(ref, loader)()
    n = 0
    for _ in range(2):  # two epochs: the reshuffle follows the same seeds
        for pb, rb in zip(p_loader, r_loader, strict=True):
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(pb, f).numpy(), np.asarray(getattr(rb, f)),
                                              err_msg=f)
            assert pb.core is None and rb.core is None
            n += 1
    assert n == 2 * len(r_loader) > 0


def test_budget_caps_drop_with_a_warning(db, caplog):
    with caplog.at_level(logging.WARNING):
        ds = HamiltonianDataset(str(db), atom_boundaries=(8,), orbital_boundaries=(64,))
    assert ds.n_dropped > 0 and "dropped" in caplog.text
    assert (ds.bucket_of < 0).sum() == ds.n_dropped


def test_non_local_source_raises():
    with pytest.raises(FileNotFoundError, match="ROADMAP"):
        HamiltonianDataset("dataset_train_tiny")
