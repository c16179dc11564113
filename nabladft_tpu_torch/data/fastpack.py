"""Host-side packing of ragged molecules into padded batch arrays.

The numpy half of ``nabladft_tpu/data/fastpack.py``: the same
`pack_energy_batch` contract and output. The JAX package also has a C
packer (``csrc/fastpack.c``) that computes the identical arrays off the
interpreter lock; the port does not build it yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pack_energy_batch(
    z_cat: np.ndarray,
    pos_cat: np.ndarray,
    forces_cat: np.ndarray,
    energy_all: np.ndarray,
    offsets: np.ndarray,
    indices: np.ndarray,
    batch_size: int,
    max_atoms: int,
) -> Tuple[np.ndarray, ...]:
    """Returns (z, pos, forces, node_mask, graph_mask, energy) padded arrays."""
    b, a = batch_size, max_atoms
    z = np.zeros((b, a), np.int32)
    pos = np.zeros((b, a, 3), np.float32)
    forces = np.zeros((b, a, 3), np.float32)
    node_mask = np.zeros((b, a), bool)
    graph_mask = np.zeros((b,), bool)
    energy = np.zeros((b,), np.float32)
    for slot, mol in enumerate(np.asarray(indices, np.int64)):
        s, e = offsets[mol], offsets[mol + 1]
        n = min(int(e - s), a)
        z[slot, :n] = z_cat[s : s + n]
        pos[slot, :n] = pos_cat[s : s + n]
        forces[slot, :n] = forces_cat[s : s + n]
        node_mask[slot, :n] = True
        graph_mask[slot] = True
        energy[slot] = energy_all[mol]
    return z, pos, forces, node_mask, graph_mask, energy
