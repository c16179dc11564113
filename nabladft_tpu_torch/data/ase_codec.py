"""Self-contained codec for the ASE SQLite database format.

The port's own copy of ``nabladft_tpu/data/ase_codec.py`` (sqlite, json and
numpy only): the PyTorch package imports nothing from the JAX package.

The nablaDFT energy splits are shipped as ASE databases (reference reads
them with `ase.db.connect`, nablaDFT/dataset/pyg_datasets.py:101-119, and
writes predictions back in the same format, nablaDFT/utils/pipelines.py:87).
This framework does not depend on ASE; instead we implement the two pieces
of the wire format we need, verified against the reference fixture DBs:

1. The `systems` table schema (columns: numbers/positions/cell as raw
   little-endian buffers, `key_value_pairs` as JSON text, `data` as the
   binary object blob, plus scalar metadata columns).
2. The binary object blob: ``int64 offset | array buffers | JSON tail``
   where ndarrays appear in the JSON as
   ``{"__ndarray__": [shape, dtype_name, buffer_offset]}`` and
   `buffer_offset` counts from the start of the blob (header included).

Only little-endian hosts are supported (x86/ARM hosts are LE).
"""

from __future__ import annotations

import json
import sqlite3
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

# ---------------------------------------------------------------------------
# Binary object blob codec
# ---------------------------------------------------------------------------


def encode_object(obj: Any) -> bytes:
    """Serialize a JSON-able object with embedded ndarrays to the blob format."""
    buffers: List[bytes] = []
    offset = [8]  # running offset; blob starts with 8-byte header

    def convert(o: Any) -> Any:
        if isinstance(o, (bool, int, float, str, type(None))):
            return o
        if isinstance(o, dict):
            return {k: convert(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [convert(v) for v in o]
        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            arr = np.ascontiguousarray(o)
            buf = arr.tobytes()
            here = offset[0]
            buffers.append(buf)
            offset[0] += len(buf)
            return {"__ndarray__": [list(arr.shape), arr.dtype.name, here]}
        raise TypeError(f"cannot encode object of type {type(o)!r}")

    tail = convert(obj)
    header = np.int64(offset[0]).tobytes()
    return b"".join([header] + buffers + [json.dumps(tail).encode()])


def decode_object(blob: Optional[bytes]) -> Any:
    """Inverse of :func:`encode_object`; also reads reference-written blobs."""
    if blob is None:
        return {}
    blob = bytes(blob)
    offset = int(np.frombuffer(blob[:8], np.int64)[0])
    tail = json.loads(blob[offset:].decode())

    def restore(o: Any) -> Any:
        if isinstance(o, dict):
            if "__ndarray__" in o:
                shape, dtype, pos = o["__ndarray__"]
                arr = np.frombuffer(
                    blob, dtype=np.dtype(dtype), count=int(np.prod(shape)), offset=pos
                )
                return arr.reshape(shape).copy()
            return {k: restore(v) for k, v in o.items()}
        if isinstance(o, list):
            return [restore(v) for v in o]
        return o

    return restore(tail)


# ---------------------------------------------------------------------------
# Minimal Atoms record
# ---------------------------------------------------------------------------

# IUPAC 2021 standard atomic weights (abridged), index = Z. Z=0 placeholder.
ATOMIC_MASSES = np.array(
    [0.0, 1.008, 4.0026, 7.0, 9.0122, 10.81, 12.011, 14.007, 15.999, 18.998,
     20.180, 22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.95,
     39.098, 40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845, 58.933,
     58.693, 63.546, 65.38, 69.723, 72.630, 74.922, 78.971, 79.904, 83.798,
     85.468, 87.62, 88.906, 91.224, 92.906, 95.95, 97.0, 101.07, 102.91,
     106.42, 107.87, 112.41, 114.82, 118.71, 121.76, 127.60, 126.90, 131.29],
    dtype=np.float64,
)


class AtomsRecord:
    """A molecule row: numbers/positions plus free-form key-values and data."""

    def __init__(
        self,
        numbers: np.ndarray,
        positions: np.ndarray,
        cell: Optional[np.ndarray] = None,
        pbc: int = 0,
        key_value_pairs: Optional[Dict[str, Any]] = None,
        data: Optional[Dict[str, Any]] = None,
        row_id: Optional[int] = None,
    ):
        self.numbers = np.asarray(numbers, np.int32).ravel()
        self.positions = np.asarray(positions, np.float64).reshape(-1, 3)
        self.cell = (
            np.zeros((3, 3)) if cell is None else np.asarray(cell, np.float64).reshape(3, 3)
        )
        self.pbc = int(pbc)
        self.key_value_pairs = dict(key_value_pairs or {})
        self.data = dict(data or {})
        self.id = row_id

    @property
    def natoms(self) -> int:
        return len(self.numbers)

    @property
    def mass(self) -> float:
        z = np.clip(self.numbers, 0, len(ATOMIC_MASSES) - 1)
        return float(ATOMIC_MASSES[z].sum())


# ---------------------------------------------------------------------------
# SQLite reader / writer
# ---------------------------------------------------------------------------

_SYSTEMS_SCHEMA = """CREATE TABLE IF NOT EXISTS systems (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    unique_id TEXT UNIQUE,
    ctime REAL, mtime REAL, username TEXT,
    numbers BLOB, positions BLOB, cell BLOB, pbc INTEGER,
    initial_magmoms BLOB, initial_charges BLOB, masses BLOB, tags BLOB,
    momenta BLOB, constraints TEXT,
    calculator TEXT, calculator_parameters TEXT,
    energy REAL, free_energy REAL, forces BLOB, stress BLOB, dipole BLOB,
    magmoms BLOB, magmom REAL, charges BLOB,
    key_value_pairs TEXT, data BLOB,
    natoms INTEGER, fmax REAL, smax REAL, volume REAL, mass REAL, charge REAL)"""

_AUX_SCHEMA = [
    """CREATE TABLE IF NOT EXISTS species (Z INTEGER, n INTEGER, id INTEGER,
       FOREIGN KEY (id) REFERENCES systems(id))""",
    """CREATE TABLE IF NOT EXISTS keys (key TEXT, id INTEGER,
       FOREIGN KEY (id) REFERENCES systems(id))""",
    """CREATE TABLE IF NOT EXISTS text_key_values (key TEXT, value TEXT,
       id INTEGER, FOREIGN KEY (id) REFERENCES systems(id))""",
    """CREATE TABLE IF NOT EXISTS number_key_values (key TEXT, value REAL,
       id INTEGER, FOREIGN KEY (id) REFERENCES systems(id))""",
    """CREATE TABLE IF NOT EXISTS information (name TEXT, value TEXT)""",
]


def _deblob(buf: Optional[bytes], dtype, shape) -> np.ndarray:
    if buf is None:
        return np.zeros(shape, dtype)
    arr = np.frombuffer(bytes(buf), dtype=dtype)
    return arr.reshape(shape).copy()


class AseDatabase:
    """Read/write access to an ASE-format SQLite database, ASE-free.

    Interoperates with databases written by `ase.db` (the nablaDFT energy
    splits and the reference test fixtures) and writes databases the
    reference tooling can read back.
    """

    VERSION = 9

    def __init__(self, path: Union[str, Path], create: bool = False):
        self.path = str(path)
        if not create and not Path(self.path).exists():
            raise FileNotFoundError(self.path)
        self._conns: Dict[int, sqlite3.Connection] = {}
        if create:
            con = self._connection()
            with con:
                con.execute(_SYSTEMS_SCHEMA)
                for stmt in _AUX_SCHEMA:
                    con.execute(stmt)
                cur = con.execute("SELECT value FROM information WHERE name='version'")
                if cur.fetchone() is None:
                    con.execute(
                        "INSERT INTO information (name, value) VALUES (?, ?)",
                        ("version", str(self.VERSION)),
                    )

    def _connection(self) -> sqlite3.Connection:
        import threading

        key = threading.get_ident()
        con = self._conns.get(key)
        if con is None:
            con = sqlite3.connect(self.path, timeout=300.0)
            self._conns[key] = con
        return con

    def __len__(self) -> int:
        cur = self._connection().execute("SELECT COUNT(*) FROM systems")
        return int(cur.fetchone()[0])

    _ROW_COLS = "id, numbers, positions, cell, pbc, key_value_pairs, data, natoms"

    def _parse(self, row) -> AtomsRecord:
        rid, numbers, positions, cell, pbc, kvp, data, natoms = row
        n = int(natoms) if natoms is not None else len(bytes(numbers)) // 4
        return AtomsRecord(
            numbers=_deblob(numbers, np.int32, (n,)),
            positions=_deblob(positions, np.float64, (n, 3)),
            cell=_deblob(cell, np.float64, (3, 3)),
            pbc=int(pbc or 0),
            key_value_pairs=json.loads(kvp) if kvp else {},
            data=decode_object(data),
            row_id=int(rid),
        )

    def get(self, row_id: int) -> AtomsRecord:
        """Fetch one row by its 1-based SQLite id."""
        cur = self._connection().execute(
            f"SELECT {self._ROW_COLS} FROM systems WHERE id=?", (row_id,)
        )
        row = cur.fetchone()
        if row is None:
            raise KeyError(row_id)
        return self._parse(row)

    def get_many(self, row_ids: Sequence[int]) -> List[AtomsRecord]:
        ids = ",".join(str(int(i)) for i in row_ids)
        cur = self._connection().execute(
            f"SELECT {self._ROW_COLS} FROM systems WHERE id IN ({ids})"
        )
        by_id = {r[0]: r for r in cur.fetchall()}
        return [self._parse(by_id[int(i)]) for i in row_ids]

    def select_all(self) -> Iterator[AtomsRecord]:
        cur = self._connection().execute(f"SELECT {self._ROW_COLS} FROM systems ORDER BY id")
        for row in cur:
            yield self._parse(row)

    def write(self, rec: AtomsRecord) -> int:
        """Append a row; returns the assigned id."""
        con = self._connection()
        now = time.time() / (86400.0 * 365.25)  # ASE stores ctime in years
        with con:
            cur = con.execute(
                """INSERT INTO systems
                   (unique_id, ctime, mtime, username, numbers, positions, cell,
                    pbc, key_value_pairs, data, natoms, mass, charge)
                   VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)""",
                (
                    uuid.uuid4().hex,
                    now,
                    now,
                    "nabladft_tpu",
                    np.ascontiguousarray(rec.numbers, np.int32).tobytes(),
                    np.ascontiguousarray(rec.positions, np.float64).tobytes(),
                    np.ascontiguousarray(rec.cell, np.float64).tobytes(),
                    rec.pbc,
                    json.dumps(rec.key_value_pairs),
                    encode_object(rec.data) if rec.data else None,
                    rec.natoms,
                    rec.mass,
                    0.0,
                ),
            )
            rid = cur.lastrowid
            uniq, counts = np.unique(rec.numbers, return_counts=True)
            con.executemany(
                "INSERT INTO species (Z, n, id) VALUES (?,?,?)",
                [(int(z), int(c), rid) for z, c in zip(uniq, counts)],
            )
            for key, value in rec.key_value_pairs.items():
                if isinstance(value, str):
                    con.execute(
                        "INSERT INTO text_key_values (key, value, id) VALUES (?,?,?)",
                        (key, value, rid),
                    )
                else:
                    con.execute(
                        "INSERT INTO number_key_values (key, value, id) VALUES (?,?,?)",
                        (key, float(value), rid),
                    )
                con.execute("INSERT INTO keys (key, id) VALUES (?,?)", (key, rid))
        return int(rid)

    def close(self) -> None:
        for con in self._conns.values():
            con.close()
        self._conns.clear()
