"""Named registries for dataset splits and pretrained checkpoints.

The port of ``nabladft_tpu/data/registry.py``, with its own copy of
`links.json`: one registry file for what the reference keeps in three
(nablaDFT/links/*.json, served by dataset/registry.py:7-69 and
model_registry.py:16-150): 16 energy splits, 12 Hamiltonian splits and 42
pretrained checkpoints, each with an ETag for download validation. Both
classes take `links_path`, so a caller can name a links file of its own
(offline use: a file already in the cache under its name, whose MD5 is the
etag there, is a cache hit and nothing is fetched).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

from nabladft_tpu_torch.data.download import download_file

LINKS_PATH = Path(__file__).parent / "links.json"


class DatasetRegistry:
    """split name -> (url, etag) for 'energy' and 'hamiltonian' databases."""

    def __init__(self, links_path: Path = LINKS_PATH):
        self._links = json.loads(Path(links_path).read_text())

    def _table(self, kind: str) -> Dict[str, Dict]:
        if kind not in ("energy", "hamiltonian"):
            raise ValueError(f"unknown dataset kind: {kind!r}")
        return self._links.get(kind, {})

    def get_url(self, kind: str, name: str) -> str:
        table = self._table(kind)
        if name not in table:
            raise KeyError(f"unknown {kind} split {name!r}; available: {sorted(table)}")
        return table[name]["url"]

    def get_etag(self, kind: str, name: str) -> Optional[str]:
        return self._table(kind).get(name, {}).get("etag")

    def list_datasets(self, kind: str) -> List[str]:
        return sorted(self._table(kind))

    def download(self, kind: str, name: str, dest: Path) -> Path:
        return download_file(self.get_url(kind, name), Path(dest), self.get_etag(kind, name),
                             desc=f"dataset split {name}")


class CheckpointRegistry:
    """'<Model>_<split>' -> pretrained checkpoint (url, etag)."""

    def __init__(self, links_path: Path = LINKS_PATH):
        self._links = json.loads(Path(links_path).read_text()).get("checkpoints", {})

    def get_url(self, name: str) -> str:
        if name not in self._links:
            raise KeyError(f"unknown checkpoint {name!r}; available: {sorted(self._links)}")
        return self._links[name]["url"]

    def get_etag(self, name: str) -> Optional[str]:
        return self._links.get(name, {}).get("etag")

    def list_checkpoints(self) -> List[str]:
        return sorted(self._links)

    def download(self, name: str, dest: Path) -> Path:
        return download_file(self.get_url(name), Path(dest), self.get_etag(name),
                             desc=f"checkpoint {name}")


dataset_registry = DatasetRegistry()
checkpoint_registry = CheckpointRegistry()
