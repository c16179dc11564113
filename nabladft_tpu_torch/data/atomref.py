"""Per-element atomic reference energies (atomization-energy offsets).

The port's copy of ``nabladft_tpu/data/atomref.py``, with its own copy of
``atomization_energies.npy`` (nablaDFT's per-element offsets, which the
reference's AddOffsets postprocessor adds to the predicted energy). Models
with ``use_atomrefs`` add ``atomrefs_for(num_elements)[z]`` per atom.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_PATH = Path(__file__).parent / "atomization_energies.npy"


def atomization_energies() -> np.ndarray:
    """[54] float64 per-element reference energies in Eh (index = Z)."""
    return np.load(_PATH)


def atomrefs_for(z_max: int = 100) -> np.ndarray:
    """The reference energies zero padded (or cut) to `z_max` elements."""
    base = atomization_energies()
    out = np.zeros(z_max, np.float64)
    n = min(z_max, len(base))
    out[:n] = base[:n]
    return out
