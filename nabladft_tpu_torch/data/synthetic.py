"""Seeded synthetic molecules written as an ASE database.

For smoke runs and tests where no nablaDFT split is at hand: drug-like
element mix (H, C, N, O, F, S, Cl), bonded-looking geometries (every atom
1.0-1.6 Å from an earlier one, none closer than 0.95 Å to any), and random
energy / force targets. The same seed gives the same database.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple, Union

import numpy as np

from nabladft_tpu_torch.data.ase_codec import AseDatabase, AtomsRecord

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
