"""Energy and Hamiltonian datasets + bucketed fixed-shape batching — the
host-side input pipeline.

The port of ``nabladft_tpu/data/dataset.py``, with the same behaviour: the
same DB and seed give the same buckets, padding and batch order as the JAX
package. Batches come out as torch `MolBatch`es on the CPU; the caller
moves them to its device. Hamiltonian splits are bucketed jointly by atom
and orbital count and carry `hamiltonian`, `overlap`, `core` and `orb_mask`.

  * every molecule is assigned to a **bucket** by atom count; bucket sizes
    are static, so a batch is a dense `[B, A_bucket]` array with masks;
  * partial batches pad whole molecules with `graph_mask=False`;
  * loading is double-buffered on a background thread so collation overlaps
    device compute.

Energy splits are cached to per-column .npy files after the first parse of
the ASE database. Sources are local ASE DB paths: the registry's named
splits (download on first use) are not part of the port yet.
"""

from __future__ import annotations

import hashlib
import logging
import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nabladft_tpu_torch.data import fastpack
from nabladft_tpu_torch.data.ase_codec import AseDatabase
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.data.hamiltonian_db import HamiltonianDatabase

logger = logging.getLogger(__name__)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Record containers
# ---------------------------------------------------------------------------


@dataclass
class EnergyRecords:
    """Column store for an energy split (ragged rows via offsets)."""

    z: np.ndarray  # [sum N] int32
    pos: np.ndarray  # [sum N, 3] float32
    energy: np.ndarray  # [M] float32
    forces: np.ndarray  # [sum N, 3] float32
    offsets: np.ndarray  # [M+1] int64
    row_ids: np.ndarray  # [M] int32 (db ids)

    def __len__(self) -> int:
        return len(self.energy)

    @property
    def natoms_all(self) -> np.ndarray:
        return (self.offsets[1:] - self.offsets[:-1]).astype(np.int32)


_CACHE_COLUMNS = ("z", "pos", "energy", "forces", "offsets", "row_ids")


def _open_cache(cache_dir: Path) -> EnergyRecords:
    cols = {c: np.load(cache_dir / f"{c}.npy", mmap_mode="r") for c in _CACHE_COLUMNS}
    return EnergyRecords(**cols)


def parse_energy_db(
    db_path: Path, cache: bool = True, cache_dir: Optional[Path] = None
) -> EnergyRecords:
    """Read an ASE energy database into columnar arrays.

    The SQLite rows are converted once into a `<db>.cache/` directory of
    per-column .npy files (written through memory maps, so host memory
    stays bounded), then every load memory-maps the columns. The cache is
    reused while it is newer than the database.
    """
    db_path = Path(db_path)
    cache_dir = Path(cache_dir) if cache_dir is not None else db_path.with_suffix(".cache")
    if (
        cache
        and cache_dir.is_dir()
        and all((cache_dir / f"{c}.npy").exists() for c in _CACHE_COLUMNS)
        and (cache_dir / "offsets.npy").stat().st_mtime >= db_path.stat().st_mtime
    ):
        return _open_cache(cache_dir)

    db = AseDatabase(db_path)
    try:
        # pass 1 (cheap SQL): row count + per-row atom counts -> exact layouts
        rows = db._connection().execute(
            "SELECT id, natoms, length(numbers) FROM systems ORDER BY id"
        ).fetchall()
        n_rows = len(rows)
        natoms = np.asarray(
            [int(r[1]) if r[1] is not None else int(r[2] or 0) // 4 for r in rows], np.int64
        )
        offsets = np.zeros(n_rows + 1, np.int64)
        np.cumsum(natoms, out=offsets[1:])
        total = int(offsets[-1])

        if cache:
            try:
                cache_dir.mkdir(exist_ok=True)
                probe = cache_dir / ".writable"
                probe.touch()
                probe.unlink()
            except OSError:
                logger.warning("cache dir %s not writable; loading without cache", cache_dir)
                cache = False
        shapes = {
            "z": ((total,), np.int32),
            "pos": ((total, 3), np.float32),
            "forces": ((total, 3), np.float32),
            "energy": ((n_rows,), np.float32),
            "row_ids": ((n_rows,), np.int32),
        }
        if cache:
            out = {
                k: np.lib.format.open_memmap(cache_dir / f"{k}.npy", mode="w+",
                                             dtype=dt, shape=shp)
                for k, (shp, dt) in shapes.items()
            }
        else:
            out = {k: np.zeros(shp, dt) for k, (shp, dt) in shapes.items()}
        # pass 2: stream rows into the columns (bounded memory)
        for i, rec in enumerate(db.select_all()):
            a, b = offsets[i], offsets[i + 1]
            out["z"][a:b] = rec.numbers.astype(np.int32)
            out["pos"][a:b] = rec.positions.astype(np.float32)
            energy = rec.data.get("energy", rec.key_value_pairs.get("energy", 0.0))
            out["energy"][i] = np.asarray(energy, np.float32).reshape(-1)[0]
            forces = rec.data.get("forces")
            if forces is not None:
                out["forces"][a:b] = np.asarray(forces, np.float32)
            out["row_ids"][i] = rec.id
    finally:
        db.close()
    if cache:
        np.save(cache_dir / "offsets.npy", offsets)
        for arr in out.values():
            arr.flush()
        return _open_cache(cache_dir)
    return EnergyRecords(offsets=offsets, **out)


# ---------------------------------------------------------------------------
# Buckets
# ---------------------------------------------------------------------------


def assign_buckets(natoms: np.ndarray, boundaries: Sequence[int]) -> np.ndarray:
    """Index of the smallest boundary >= natoms; -1 above the largest."""
    bounds = np.asarray(sorted(boundaries))
    idx = np.searchsorted(bounds, natoms, side="left")
    return np.where(idx < len(bounds), idx, -1).astype(np.int32)


def collate_energy(
    recs: EnergyRecords, indices: Sequence[int], batch_size: int, max_atoms: int
) -> MolBatch:
    """Pad the given molecules into one CPU MolBatch of [batch_size, max_atoms]."""
    idx = np.asarray(indices, np.int64)
    z, pos, forces, node_mask, graph_mask, energy = fastpack.pack_energy_batch(
        recs.z, recs.pos, recs.forces, recs.energy, recs.offsets, idx,
        batch_size, max_atoms,
    )
    mol_id = np.full((batch_size,), -1, np.int32)
    mol_id[: len(idx)] = recs.row_ids[idx]
    t = torch.from_numpy
    return MolBatch(
        z=t(z), pos=t(pos), node_mask=t(node_mask), graph_mask=t(graph_mask),
        energy=t(energy), forces=t(forces), mol_id=t(mol_id),
    )


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


def _concat_records(parts: List[EnergyRecords]) -> EnergyRecords:
    """Merge several splits into one column store."""
    if len(parts) == 1:
        return parts[0]
    offsets = [parts[0].offsets]
    base = parts[0].offsets[-1]
    for p in parts[1:]:
        offsets.append(p.offsets[1:] + base)
        base += p.offsets[-1]
    return EnergyRecords(
        z=np.concatenate([p.z for p in parts]),
        pos=np.concatenate([p.pos for p in parts]),
        energy=np.concatenate([p.energy for p in parts]),
        forces=np.concatenate([p.forces for p in parts]),
        offsets=np.concatenate(offsets),
        row_ids=np.concatenate([p.row_ids for p in parts]),
    )


class EnergyDataset:
    """An energy split: columnar records + bucket assignment.

    Args:
      source: path to a local ASE db, or a list of paths (multi-file
        datasets concatenate).
      root: the datasets root; caches of DBs outside it and outside the
        working directory go under ``<root>/cache``.
    """

    def __init__(
        self,
        source,
        root: Optional[Path] = None,
        bucket_boundaries: Sequence[int] = (32, 48, 64),
    ):
        sources = [source] if isinstance(source, (str, Path)) else list(source)
        parts = []
        paths = []
        for src in sources:
            path = Path(src)
            if not path.exists():
                raise FileNotFoundError(
                    f"{src!r} is not a local ASE database; named registry splits "
                    "are not supported by the PyTorch port yet (ROADMAP queue 1)"
                )
            # never write the .cache next to a DB outside our own roots
            cache_dir = None
            resolved = path.resolve()
            datasets_root = Path(root or "datasets").resolve()
            if not (resolved.is_relative_to(Path.cwd())
                    or resolved.is_relative_to(datasets_root)):
                key = hashlib.sha256(str(resolved).encode()).hexdigest()[:12]
                cache_dir = Path(root or "datasets") / "cache" / f"{path.stem}-{key}.cache"
                cache_dir.parent.mkdir(parents=True, exist_ok=True)
            paths.append(path)
            parts.append(parse_energy_db(path, cache_dir=cache_dir))
        self.path = paths[0]
        self.paths = paths
        self.records = _concat_records(parts)
        self.bucket_boundaries = tuple(sorted(bucket_boundaries))
        max_atoms = int(self.records.natoms_all.max()) if len(self.records) else 0
        if max_atoms > self.bucket_boundaries[-1]:
            # never drop data silently: grow a final bucket to cover the
            # largest molecule
            extra = round_up(max_atoms, 8)
            logger.warning(
                "molecules up to %d atoms exceed the largest bucket %d; "
                "adding bucket %d", max_atoms, self.bucket_boundaries[-1], extra,
            )
            self.bucket_boundaries = (*self.bucket_boundaries, extra)
        self.bucket_of = assign_buckets(self.records.natoms_all, self.bucket_boundaries)

    def __len__(self) -> int:
        return len(self.records)


class HamiltonianRecords:
    """Lazy view over a Hamiltonian DB: natoms / norb scanned up front, rows
    fetched on demand (the matrices are too large to hold in RAM)."""

    def __init__(self, db: HamiltonianDatabase):
        self.db = db
        rows = db._connection().execute(
            "SELECT id, length(Z), length(H) FROM data ORDER BY id").fetchall()
        self.ids = np.asarray([r[0] for r in rows], np.int64)
        self.natoms_all = np.asarray([r[1] // 4 for r in rows], np.int32)
        self.norb_all = np.asarray(
            [int(round((r[2] // 4) ** 0.5)) if r[2] else 0 for r in rows], np.int32)

    def __len__(self) -> int:
        return len(self.ids)


class HamiltonianDataset:
    """A Hamiltonian split, bucketed jointly by (natoms, norb); molecules
    above either largest boundary are dropped, with a warning."""

    def __init__(
        self,
        source,
        root: Optional[Path] = None,
        atom_boundaries: Sequence[int] = (32, 48, 64),
        orbital_boundaries: Sequence[int] = (256, 384, 512, 640),
        include_overlap: bool = True,
        include_core: bool = False,
    ):
        del root  # named splits (downloaded into root) are not ported
        path = Path(source)
        if not path.exists():
            raise FileNotFoundError(
                f"{source!r} is not a local Hamiltonian database; named registry splits "
                "are not supported by the PyTorch port yet (ROADMAP queue 1)")
        self.path = path
        self.db = HamiltonianDatabase(path)
        self.records = HamiltonianRecords(self.db)
        self.include_overlap = include_overlap
        self.include_core = include_core
        self.atom_boundaries = tuple(sorted(atom_boundaries))
        self.orbital_boundaries = tuple(sorted(orbital_boundaries))
        ab = assign_buckets(self.records.natoms_all, self.atom_boundaries)
        ob = assign_buckets(self.records.norb_all, self.orbital_boundaries)
        # joint bucket id = ab * n_orb_buckets + ob (or -1 = dropped)
        self.bucket_of = np.where(
            (ab >= 0) & (ob >= 0), ab * len(self.orbital_boundaries) + ob, -1
        ).astype(np.int32)
        self.n_dropped = int((self.bucket_of < 0).sum())
        if self.n_dropped:
            logger.warning(
                "%d molecules exceed the atom/orbital budget caps and are dropped "
                "(largest: %d atoms / %d orbitals)", self.n_dropped,
                int(self.records.natoms_all.max()), int(self.records.norb_all.max()))

    def __len__(self) -> int:
        return len(self.records)

    def bucket_shape(self, bucket_id: int) -> Tuple[int, int]:
        ab, ob = divmod(int(bucket_id), len(self.orbital_boundaries))
        return self.atom_boundaries[ab], self.orbital_boundaries[ob]

    def collate(self, indices: Sequence[int], batch_size: int, bucket_id: int) -> MolBatch:
        a, o = self.bucket_shape(bucket_id)
        b = batch_size
        z = np.zeros((b, a), np.int32)
        pos = np.zeros((b, a, 3), np.float32)
        node_mask = np.zeros((b, a), bool)
        graph_mask = np.zeros((b,), bool)
        energy = np.zeros((b,), np.float32)
        forces = np.zeros((b, a, 3), np.float32)
        mol_id = np.full((b,), -1, np.int32)
        ham = np.zeros((b, o, o), np.float32)
        over = np.zeros((b, o, o), np.float32) if self.include_overlap else None
        core = np.zeros((b, o, o), np.float32) if self.include_core else None
        orb_mask = np.zeros((b, o), bool)
        recs = self.db.get_many([int(self.records.ids[i]) for i in indices])
        for slot, rec in enumerate(recs):
            n, no = rec.natoms, rec.norb
            z[slot, :n] = rec.z
            pos[slot, :n] = rec.pos
            node_mask[slot, :n] = True
            graph_mask[slot] = True
            energy[slot] = rec.energy
            forces[slot, :n] = rec.forces
            mol_id[slot] = self.records.ids[indices[slot]]
            ham[slot, :no, :no] = rec.hamiltonian
            if over is not None:
                over[slot, :no, :no] = rec.overlap
            if core is not None:
                core[slot, :no, :no] = rec.core
            orb_mask[slot, :no] = True
        t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
        return MolBatch(
            z=t(z), pos=t(pos), node_mask=t(node_mask), graph_mask=t(graph_mask),
            energy=t(energy), forces=t(forces), mol_id=t(mol_id),
            hamiltonian=t(ham), overlap=t(over), core=t(core), orb_mask=t(orb_mask),
        )


# ---------------------------------------------------------------------------
# Splits
# ---------------------------------------------------------------------------


def seeded_random_split(
    n: int, fractions: Sequence[float], seed: int = 42
) -> List[np.ndarray]:
    """Deterministic index split (the JAX package's exact permutation)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    sizes = [int(round(f * n)) for f in fractions]
    sizes[-1] = n - sum(sizes[:-1])
    out, start = [], 0
    for s in sizes:
        out.append(np.sort(perm[start : start + s]))
        start += s
    return out


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------


@dataclass
class LoaderConfig:
    batch_size: int = 32
    shuffle: bool = True
    seed: int = 0
    drop_last: bool = False
    prefetch: int = 2  # batches queued ahead of the consumer
    # collation worker threads; batch ORDER is identical for any count
    num_workers: int = 1


class BucketedLoader:
    """Iterates fixed-shape MolBatches, grouped by bucket.

    Each epoch: indices are shuffled within their bucket, chunked into
    batches, and the per-bucket batch streams are interleaved in a
    deterministic shuffled order.
    """

    def __init__(
        self,
        dataset: EnergyDataset,
        indices: Optional[np.ndarray] = None,
        config: LoaderConfig = LoaderConfig(),
    ):
        self.dataset = dataset
        self.config = config
        all_idx = np.arange(len(dataset)) if indices is None else np.asarray(indices)
        bucket_of = dataset.bucket_of[all_idx]
        self.by_bucket: Dict[int, np.ndarray] = {}
        for bid in np.unique(bucket_of):
            if bid < 0:
                continue
            self.by_bucket[int(bid)] = all_idx[bucket_of == bid]
        self._epoch = 0

    def __len__(self) -> int:
        bs = self.config.batch_size
        total = 0
        for idx in self.by_bucket.values():
            total += (len(idx) // bs) if self.config.drop_last else -(-len(idx) // bs)
        return total

    def _epoch_plan(self) -> List[Tuple[int, np.ndarray]]:
        rng = np.random.default_rng(self.config.seed + self._epoch)
        bs = self.config.batch_size
        plan: List[Tuple[int, np.ndarray]] = []
        for bid, idx in sorted(self.by_bucket.items()):
            idx = rng.permutation(idx) if self.config.shuffle else idx
            n_full = len(idx) // bs
            for i in range(n_full):
                plan.append((bid, idx[i * bs : (i + 1) * bs]))
            if not self.config.drop_last and len(idx) % bs:
                plan.append((bid, idx[n_full * bs :]))
        if self.config.shuffle:
            order = rng.permutation(len(plan))
            plan = [plan[i] for i in order]
        return plan

    def _collate(self, bid: int, chunk: np.ndarray) -> MolBatch:
        if isinstance(self.dataset, HamiltonianDataset):
            return self.dataset.collate(chunk, self.config.batch_size, bid)
        max_atoms = self.dataset.bucket_boundaries[bid]
        return collate_energy(self.dataset.records, chunk, self.config.batch_size, max_atoms)

    def _iter_pool(self, plan, n_workers: int) -> Iterator[MolBatch]:
        """Ordered multi-worker collation: the pool races ahead by
        prefetch + n_workers batches; results yield in plan order."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        depth = max(1, self.config.prefetch) + n_workers
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            pending: "deque" = deque()
            for item in plan:
                pending.append(ex.submit(self._collate, *item))
                if len(pending) >= depth:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

    def __iter__(self) -> Iterator[MolBatch]:
        plan = self._epoch_plan()
        self._epoch += 1
        if self.config.num_workers > 1:
            yield from self._iter_pool(plan, self.config.num_workers)
            return
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.config.prefetch))
        stop = threading.Event()
        error: List[BaseException] = []

        def worker():
            try:
                for bid, chunk in plan:
                    if stop.is_set():
                        return
                    q.put(self._collate(bid, chunk))
            except Exception as e:  # re-raised on the consumer side
                error.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                yield batch
        finally:
            stop.set()
            # unblock a worker waiting on a full queue, then reap it
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.01)
        if error:
            raise error[0]


class DataModule:
    """train/val/test loaders over one dataset with a seeded split;
    `predict_dataloader` is the test loader, as in the JAX package."""

    def __init__(
        self,
        dataset: EnergyDataset,
        batch_size: int = 32,
        val_fraction: float = 0.1,
        seed: int = 42,
        test_dataset: Optional[EnergyDataset] = None,
        num_workers: int = 1,
    ):
        self.dataset = dataset
        self.test_dataset = test_dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = num_workers
        if val_fraction > 0:
            self.train_idx, self.val_idx = seeded_random_split(
                len(dataset), [1.0 - val_fraction, val_fraction], seed
            )
        else:
            self.train_idx, self.val_idx = np.arange(len(dataset)), np.array([], np.int64)

    def train_dataloader(self) -> BucketedLoader:
        return BucketedLoader(
            self.dataset, self.train_idx,
            LoaderConfig(batch_size=self.batch_size, shuffle=True, seed=self.seed,
                         num_workers=self.num_workers),
        )

    def val_dataloader(self) -> BucketedLoader:
        return BucketedLoader(
            self.dataset, self.val_idx,
            LoaderConfig(batch_size=self.batch_size, shuffle=False,
                         num_workers=self.num_workers),
        )

    def test_dataloader(self) -> BucketedLoader:
        ds = self.test_dataset or self.dataset
        return BucketedLoader(ds, None, LoaderConfig(batch_size=self.batch_size, shuffle=False))

    predict_dataloader = test_dataloader
