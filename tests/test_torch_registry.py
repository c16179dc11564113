"""The port's download validation and named registries, offline.

MD5 and S3 multipart etags against hashlib and the JAX package's functions;
`download_file`'s cache hit with ``urllib.request.urlopen`` patched to
raise; a fetched file whose checksum is not the etag raising (urlopen
patched to serve bytes); and named energy and Hamiltonian splits resolving
from the cache of a links file of the test's own, through the datasets and
through `pipelines.run`. The package's links file is the JAX package's.
"""

import hashlib
import io
import json
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from nabladft_tpu.data import download as jax_download
from nabladft_tpu_torch import pipelines
from nabladft_tpu_torch.data import download, registry
from nabladft_tpu_torch.data.dataset import EnergyDataset, HamiltonianDataset
from nabladft_tpu_torch.data.synthetic import write_random_db, write_random_hamiltonian_db


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("urlopen called")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def test_etags_match_hashlib_and_the_jax_package(tmp_path):
    data = np.random.default_rng(0).bytes(3 * (1 << 20) + 12345)
    path = tmp_path / "blob.bin"
    path.write_bytes(data)
    assert download.file_md5(path) == hashlib.md5(data).hexdigest() == jax_download.file_md5(path)
    part = -(-len(data) // 3)
    want = hashlib.md5(b"".join(hashlib.md5(data[i:i + part]).digest()
                                for i in range(0, len(data), part))).hexdigest() + "-3"
    assert download.multipart_etag(path, 3) == want == jax_download.multipart_etag(path, 3)
    assert download.validate_file(path, want) and download.validate_file(path, None)
    assert not download.validate_file(path, "0" * 32)
    assert not download.validate_file(tmp_path / "missing", None)


def test_cache_hit_fetches_nothing(tmp_path, no_network):
    path = tmp_path / "x.db"
    path.write_bytes(b"cached")
    etag = hashlib.md5(b"cached").hexdigest()
    assert download.download_file("https://files.invalid/x.db", path, etag) == path


def test_checksum_mismatch_raises(tmp_path, monkeypatch):
    class Response(io.BytesIO):
        headers = {"Content-Length": "7"}

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.close()

    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout: Response(b"served!"))
    dest = tmp_path / "x.db"
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        download.download_file("https://files.invalid/x.db", dest, "0" * 32)
    ok = hashlib.md5(b"served!").hexdigest()
    assert download.download_file("https://files.invalid/x.db", dest, ok).read_bytes() == b"served!"


def test_package_links_are_the_jax_packages():
    ours = json.loads(registry.LINKS_PATH.read_text())
    theirs = json.loads((REPO / "nabladft_tpu" / "data" / "links.json").read_text())
    assert ours == theirs
    assert len(registry.checkpoint_registry.list_checkpoints()) == 42
    assert len(registry.dataset_registry.list_datasets("energy")) == 16
    assert len(registry.dataset_registry.list_datasets("hamiltonian")) == 12
    with pytest.raises(KeyError, match="unknown energy split"):
        registry.dataset_registry.get_url("energy", "nope")


def _links(tmp_path, kind, name, db):
    links = tmp_path / "links.json"
    links.write_text(json.dumps({kind: {name: {"url": "https://files.invalid/raw.db",
                                               "etag": download.file_md5(db)}}}))
    return links


def test_named_splits_resolve_from_the_cache(tmp_path, no_network):
    root = tmp_path / "datasets"
    (root / "dataset_train_tiny").mkdir(parents=True)
    (root / "dataset_test_conformations_tiny").mkdir()
    energy_db = write_random_db(root / "dataset_train_tiny" / "raw.db", n_mols=6, min_atoms=3,
                                max_atoms=8, seed=0)
    ham_db = write_random_hamiltonian_db(root / "dataset_test_conformations_tiny" / "raw.db",
                                         n_mols=3, min_atoms=2, max_atoms=4, seed=0)
    (tmp_path / "e").mkdir()
    reg_e = registry.DatasetRegistry(_links(tmp_path / "e", "energy", "dataset_train_tiny",
                                            energy_db))
    ds = EnergyDataset("dataset_train_tiny", root=root, bucket_boundaries=(8,), registry=reg_e)
    assert ds.path == energy_db and len(ds) == 6
    (tmp_path / "h").mkdir()
    reg_h = registry.DatasetRegistry(_links(tmp_path / "h", "hamiltonian",
                                            "dataset_test_conformations_tiny", ham_db))
    hs = HamiltonianDataset("dataset_test_conformations_tiny", root=root, registry=reg_h)
    assert hs.path == ham_db and len(hs.records) == 3
    with pytest.raises(FileNotFoundError, match="registry"):
        EnergyDataset("dataset_train_huge", root=root, registry=reg_e)


def test_named_split_through_the_pipeline(tmp_path, no_network):
    from nabladft_tpu_torch.config import load_config

    root = tmp_path / "datasets"
    (root / "dataset_train_tiny").mkdir(parents=True)
    db = write_random_db(root / "dataset_train_tiny" / "raw.db", n_mols=6, min_atoms=3,
                         max_atoms=8, seed=1)
    cfg = load_config(REPO / "configs" / "painn-oc.yaml", overrides={
        "job_type": "predict", "links_path": str(_links(tmp_path, "energy",
                                                       "dataset_train_tiny", db)),
        "model": {"kwargs": dict(hidden=8, n_interactions=1, n_rbf=4, max_neighbors=7)},
        "datamodule": {"source": "dataset_train_tiny", "root": str(root), "batch_size": 4,
                       "bucket_boundaries": [8]},
        "output_db": str(tmp_path / "pred.db"), "log_csv": False})
    assert pipelines.run(cfg, device="cpu")["rows"] == 6
