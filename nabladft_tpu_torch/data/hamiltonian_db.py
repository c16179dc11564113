"""nablaDFT Hamiltonian database access (SQLite), ASE/apsw-free.

The port's copy of ``nabladft_tpu/data/hamiltonian_db.py`` (numpy and
sqlite3 only), with the same schema. It implements the on-disk schema of the reference's `HamiltonianDatabase`
(nablaDFT/dataset/hamiltonian_dataset.py:17-267) so the published
hamiltonian splits can be read directly and databases we write can be read
by the reference tooling:

  tables:
    data(id, Z BLOB int32[N], R BLOB f32[N,3] (Bohr), E FLOAT (Eh),
         F BLOB f32[N,3], H BLOB f32[O,O], S BLOB f32[O,O], C BLOB f32[O,O])
    dataset_ids(id, MOSES_ID, CONFORMER_ID)
    nuclear_charges(id, N, Z BLOB)           -- dataset-level element set
    basisset(Z, orbitals BLOB int32)          -- per-element orbital l-list
    metadata(id, N)                           -- row count at id=0

Blobs are little-endian raw buffers; float64/int64 are narrowed to
float32/int32 on write (reference `_blob`, hamiltonian_dataset.py:188-198).
Norb is recovered as sqrt(len(H)/4) (reference `_unpack_data_tuple`).
"""

from __future__ import annotations

import sqlite3
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


@dataclass
class HamiltonianRecord:
    z: np.ndarray  # [N] int32
    pos: np.ndarray  # [N, 3] float32, Bohr
    energy: float  # Eh
    forces: np.ndarray  # [N, 3] float32
    hamiltonian: np.ndarray  # [O, O] float32
    overlap: np.ndarray  # [O, O] float32
    core: np.ndarray  # [O, O] float32
    moses_id: int = -1
    conformer_id: int = -1

    @property
    def natoms(self) -> int:
        return len(self.z)

    @property
    def norb(self) -> int:
        return self.hamiltonian.shape[0]


def _blob(arr: Optional[np.ndarray]) -> Optional[bytes]:
    if arr is None:
        return None
    arr = np.asarray(arr)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    if arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    return np.ascontiguousarray(arr).tobytes()


def _deblob(buf: Optional[bytes], dtype, shape) -> np.ndarray:
    if buf is None:
        return np.zeros(shape, dtype)
    return np.frombuffer(bytes(buf), dtype=dtype).reshape(shape).copy()


class HamiltonianDatabase:
    """Reader/writer for the nablaDFT Hamiltonian SQLite schema."""

    def __init__(self, path: Union[str, Path], create: bool = False):
        self.path = str(path)
        if not create and not Path(self.path).exists():
            raise FileNotFoundError(self.path)
        self._conns: Dict[int, sqlite3.Connection] = {}
        if create:
            con = self._connection()
            with con:
                con.execute(
                    """CREATE TABLE IF NOT EXISTS dataset_ids
                       (id INTEGER NOT NULL PRIMARY KEY, MOSES_ID INT, CONFORMER_ID INT)"""
                )
                con.execute(
                    """CREATE TABLE IF NOT EXISTS data
                       (id INTEGER NOT NULL PRIMARY KEY,
                        Z BLOB, R BLOB, E FLOAT, F BLOB, H BLOB, S BLOB, C BLOB)"""
                )
                con.execute(
                    """CREATE TABLE IF NOT EXISTS nuclear_charges
                       (id INTEGER NOT NULL PRIMARY KEY, N INTEGER, Z BLOB)"""
                )
                con.execute(
                    """CREATE TABLE IF NOT EXISTS basisset
                       (Z INTEGER NOT NULL PRIMARY KEY, orbitals BLOB)"""
                )
                con.execute(
                    """CREATE TABLE IF NOT EXISTS metadata
                       (id INTEGER PRIMARY KEY, N INTEGER)"""
                )
                con.execute("INSERT OR IGNORE INTO metadata (id, N) VALUES (0, 0)")

    def _connection(self) -> sqlite3.Connection:
        key = threading.get_ident()
        con = self._conns.get(key)
        if con is None:
            con = sqlite3.connect(self.path, timeout=300.0)
            self._conns[key] = con
        return con

    def __len__(self) -> int:
        row = self._connection().execute("SELECT N FROM metadata WHERE id=0").fetchone()
        return int(row[0]) if row else 0

    def _parse(self, row, ids_row) -> HamiltonianRecord:
        _, zb, rb, e, fb, hb, sb, cb = row
        n = len(bytes(zb)) // 4
        norb = int(round((len(bytes(hb)) // 4) ** 0.5)) if hb is not None else 0
        moses_id, conformer_id = (-1, -1)
        if ids_row is not None:
            moses_id, conformer_id = int(ids_row[1]), int(ids_row[2])
        return HamiltonianRecord(
            z=_deblob(zb, np.int32, (n,)),
            pos=_deblob(rb, np.float32, (n, 3)),
            energy=float(e) if e is not None else 0.0,
            forces=_deblob(fb, np.float32, (n, 3)),
            hamiltonian=_deblob(hb, np.float32, (norb, norb)),
            overlap=_deblob(sb, np.float32, (norb, norb)),
            core=_deblob(cb, np.float32, (norb, norb)),
            moses_id=moses_id,
            conformer_id=conformer_id,
        )

    def get(self, idx: int) -> HamiltonianRecord:
        con = self._connection()
        row = con.execute("SELECT * FROM data WHERE id=?", (int(idx),)).fetchone()
        if row is None:
            raise KeyError(idx)
        ids = con.execute("SELECT * FROM dataset_ids WHERE id=?", (int(idx),)).fetchone()
        return self._parse(row, ids)

    def get_many(self, indices: Sequence[int]) -> List[HamiltonianRecord]:
        con = self._connection()
        ids = ",".join(str(int(i)) for i in indices)
        rows = {r[0]: r for r in con.execute(f"SELECT * FROM data WHERE id IN ({ids})")}
        meta = {r[0]: r for r in con.execute(f"SELECT * FROM dataset_ids WHERE id IN ({ids})")}
        return [self._parse(rows[int(i)], meta.get(int(i))) for i in indices]

    def add(self, rec: HamiltonianRecord, idx: Optional[int] = None) -> int:
        if any(
            np.any(np.isnan(a))
            for a in (rec.pos, rec.forces, rec.hamiltonian, rec.overlap, rec.core)
        ) or np.isnan(rec.energy):
            raise ValueError("refusing to add NaN data")
        con = self._connection()
        with con:
            con.execute("BEGIN EXCLUSIVE")
            n = len(self)
            rid = n if idx is None else int(idx)
            con.execute(
                "INSERT OR REPLACE INTO dataset_ids (id, MOSES_ID, CONFORMER_ID) VALUES (?,?,?)",
                (rid, rec.moses_id, rec.conformer_id),
            )
            con.execute(
                "INSERT OR REPLACE INTO data (id, Z, R, E, F, H, S, C) VALUES (?,?,?,?,?,?,?,?)",
                (
                    rid,
                    _blob(rec.z),
                    _blob(rec.pos),
                    float(rec.energy),
                    _blob(rec.forces),
                    _blob(rec.hamiltonian),
                    _blob(rec.overlap),
                    _blob(rec.core),
                ),
            )
            con.execute("INSERT OR REPLACE INTO metadata VALUES (0, ?)", (n + 1,))
        return rid

    # -- basis-set convention ------------------------------------------------

    def add_orbitals(self, z: int, orbitals: np.ndarray) -> None:
        con = self._connection()
        with con:
            con.execute(
                "INSERT OR REPLACE INTO basisset (Z, orbitals) VALUES (?,?)",
                (int(z), _blob(np.asarray(orbitals, np.int32))),
            )

    def get_orbitals(self, z: int) -> np.ndarray:
        """Per-element list of orbital angular momenta l (e.g. [0,0,0,1,1] )."""
        row = self._connection().execute(
            "SELECT orbitals FROM basisset WHERE Z=?", (int(z),)
        ).fetchone()
        if row is None:
            raise KeyError(z)
        buf = bytes(row[0])
        return _deblob(buf, np.int32, (len(buf) // 4,))

    def elements(self) -> List[int]:
        return [int(r[0]) for r in self._connection().execute("SELECT Z FROM basisset")]

    def orbital_counts(self) -> Dict[int, int]:
        """Element -> number of basis functions (sum over shells of 2l+1)."""
        return {
            z: int(np.sum(2 * self.get_orbitals(z) + 1)) for z in self.elements()
        }

    def close(self) -> None:
        for con in self._conns.values():
            con.close()
        self._conns.clear()
