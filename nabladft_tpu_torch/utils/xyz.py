"""Minimal extended-XYZ writer (trajectory export).

The reference dumps per-structure extxyz trajectories during relaxation and
MD (optimization/optimizers.py:269-277, pyg_ase_interface.py extxyz save).
This ASE-free writer produces files ASE and OVITO read back. The port's
own copy of ``nabladft_tpu/utils/xyz.py``: the same arrays give the same
bytes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SYMBOLS = (
    "X H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe "
    "Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn "
    "Sb Te I Xe"
).split()


def symbol(z: int) -> str:
    return _SYMBOLS[z] if 0 <= z < len(_SYMBOLS) else f"Z{z}"


def write_extxyz(
    path,
    z: np.ndarray,
    frames: Sequence[np.ndarray],
    energies: Optional[Sequence[float]] = None,
    forces: Optional[Sequence[np.ndarray]] = None,
    append: bool = False,
) -> None:
    """Write one molecule's trajectory: frames = list of [N,3] positions."""
    z = np.asarray(z).ravel()
    n = len(z)
    mode = "a" if append else "w"
    with open(Path(path), mode) as f:
        for i, pos in enumerate(frames):
            props = "Properties=species:S:1:pos:R:3"
            comment = props
            if forces is not None:
                props += ":forces:R:3"
                comment = props
            if energies is not None:
                comment += f" energy={float(energies[i]):.10f}"
            f.write(f"{n}\n{comment}\n")
            for a in range(n):
                line = f"{symbol(int(z[a])):2s} " + " ".join(
                    f"{c: .8f}" for c in np.asarray(pos)[a]
                )
                if forces is not None:
                    line += " " + " ".join(f"{c: .8f}" for c in np.asarray(forces[i])[a])
                f.write(line + "\n")
