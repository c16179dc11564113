"""Seeded synthetic molecules written as an ASE or a Hamiltonian database.

For smoke runs and tests where no nablaDFT split is at hand: drug-like
element mix (H, C, N, O, F, S, Cl), bonded-looking geometries (every atom
1.0-1.6 Å from an earlier one, none closer than 0.95 Å to any), and random
energy / force (and Hamiltonian / overlap) targets. The same seed gives the
same database.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple, Union

import numpy as np

from nabladft_tpu_torch.data.ase_codec import AseDatabase, AtomsRecord
from nabladft_tpu_torch.data.hamiltonian_db import HamiltonianDatabase

ELEMENTS = np.array([1, 6, 7, 8, 9, 16, 17], np.int32)
ELEMENT_WEIGHTS = np.array([0.45, 0.32, 0.08, 0.08, 0.03, 0.02, 0.02])


def random_molecule(rng: np.random.Generator, n_atoms: int) -> Tuple[np.ndarray, np.ndarray]:
    """(numbers [n], positions [n,3] in Å) grown one atom at a time."""
    pos = np.zeros((n_atoms, 3))
    for k in range(1, n_atoms):
        for _ in range(100):
            d = rng.normal(size=3)
            cand = pos[rng.integers(k)] + d / np.linalg.norm(d) * rng.uniform(1.0, 1.6)
            if np.linalg.norm(pos[:k] - cand, axis=1).min() > 0.95:
                break
        pos[k] = cand
    z = rng.choice(ELEMENTS, size=n_atoms, p=ELEMENT_WEIGHTS)
    return z, pos


def write_random_db(path: Union[str, Path], n_mols: int, min_atoms: int, max_atoms: int,
                    seed: int = 0) -> Path:
    """Write `n_mols` molecules of min_atoms..max_atoms atoms to a new ASE DB."""
    path = Path(path)
    rng = np.random.default_rng(seed)
    db = AseDatabase(path, create=True)
    try:
        for _ in range(n_mols):
            n = int(rng.integers(min_atoms, max_atoms + 1))
            z, pos = random_molecule(rng, n)
            db.write(AtomsRecord(
                z, pos,
                data={"energy": [float(rng.normal())], "forces": rng.normal(size=(n, 3))},
            ))
    finally:
        db.close()
    return path


# def2-SVP shells (l of each) of the elements the Hamiltonian writer uses
DEF2_SVP_SHELLS = {1: (0, 0, 1), 6: (0, 0, 0, 1, 1, 2), 7: (0, 0, 0, 1, 1, 2),
                   8: (0, 0, 0, 1, 1, 2), 9: (0, 0, 0, 1, 1, 2), 16: (0, 0, 0, 0, 1, 1, 1, 2),
                   17: (0, 0, 0, 0, 1, 1, 1, 2)}
HEAVY = np.array([6, 7, 8, 9, 16, 17], np.int32)
HEAVY_WEIGHTS = np.array([0.56, 0.16, 0.16, 0.04, 0.04, 0.04])
BOHR_PER_ANGSTROM = 1.8897261246


def write_random_hamiltonian_db(path: Union[str, Path], n_mols: int, min_atoms: int,
                                max_atoms: int, seed: int = 0) -> Path:
    """Write `n_mols` molecules of min_atoms..max_atoms atoms to a new
    Hamiltonian DB (the nablaDFT schema, `data/hamiltonian_db.py`): half of
    each molecule's atoms H, the rest C N O F S Cl (mostly C, so that a
    62-atom molecule stays near 600 def2-SVP orbitals), positions in Bohr,
    the def2-SVP basisset table, and random symmetric H and S of the
    molecule's orbital count (S near the identity); no core matrix."""
    path = Path(path)
    rng = np.random.default_rng(seed)
    db = HamiltonianDatabase(path, create=True)
    norb = {z: sum(2 * l + 1 for l in ls) for z, ls in DEF2_SVP_SHELLS.items()}
    try:
        for z, shells in DEF2_SVP_SHELLS.items():
            db.add_orbitals(z, np.asarray(shells, np.int32))
        rows = []
        for k in range(n_mols):
            n = int(rng.integers(min_atoms, max_atoms + 1))
            _, pos = random_molecule(rng, n)
            z = np.concatenate([np.ones(n // 2, np.int32),
                                rng.choice(HEAVY, size=n - n // 2, p=HEAVY_WEIGHTS)])
            z = rng.permutation(z)
            o = int(sum(norb[int(q)] for q in z))
            h = rng.normal(size=(o, o)) * 0.1
            s = rng.normal(size=(o, o)) * 0.01
            rows.append((k, z, (pos * BOHR_PER_ANGSTROM).astype(np.float32), float(rng.normal()),
                         rng.normal(size=(n, 3)).astype(np.float32), (h + h.T).astype(np.float32),
                         (np.eye(o) + s + s.T).astype(np.float32)))
        con = db._connection()
        with con:  # one transaction
            for k, z, pos, e, f, h, s in rows:
                con.execute("INSERT INTO dataset_ids (id, MOSES_ID, CONFORMER_ID) VALUES (?,?,?)",
                            (k, k, 0))
                con.execute("INSERT INTO data (id, Z, R, E, F, H, S, C) VALUES (?,?,?,?,?,?,?,?)",
                            (k, z.tobytes(), pos.tobytes(), e, f.tobytes(), h.tobytes(),
                             s.tobytes(), None))
            con.execute("INSERT OR REPLACE INTO metadata VALUES (0, ?)", (n_mols,))
    finally:
        db.close()
    return path
