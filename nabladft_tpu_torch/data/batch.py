"""Fixed-shape padded molecular batches, as torch tensors.

The counterpart of ``nabladft_tpu/data/batch.py``: the same fields, the
same padding convention, held as ``torch.Tensor``s so a batch moves to the
card in one ``.to(device)``.

  * molecules are padded to a bucket's ``max_atoms`` (A);
  * a batch holds ``B`` molecules: ``z:[B,A] pos:[B,A,3] node_mask:[B,A]``;
  * graph structure is derived on the device from positions.

Padding convention: ``z == 0`` and ``node_mask == False`` for padding atoms.
Padding molecules (for the last partial batch) have ``graph_mask == False``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class MolBatch:
    """A statically shaped batch of padded molecules.

    Shapes (B = molecules per batch, A = max atoms in bucket):
      z:          [B, A]    int32   atomic numbers, 0 = padding
      pos:        [B, A, 3] float32 Cartesian coordinates (Å)
      node_mask:  [B, A]    bool    True for real atoms
      graph_mask: [B]       bool    True for real molecules
      energy:     [B]       float32 target energy (Eh), 0 where padded
      forces:     [B, A, 3] float32 target forces, 0 where padded
      mol_id:     [B]       int32   row id in the source database, -1 = padding
    The Hamiltonian and periodic fields stay None on the energy path.
    """

    z: torch.Tensor
    pos: torch.Tensor
    node_mask: torch.Tensor
    graph_mask: torch.Tensor
    energy: torch.Tensor
    forces: torch.Tensor
    mol_id: torch.Tensor
    hamiltonian: Optional[torch.Tensor] = None
    overlap: Optional[torch.Tensor] = None
    core: Optional[torch.Tensor] = None
    orb_mask: Optional[torch.Tensor] = None
    cell: Optional[torch.Tensor] = None

    @property
    def n_atoms(self) -> torch.Tensor:
        """[B] number of real atoms per molecule."""
        return self.node_mask.sum(dim=-1).to(torch.int32)

    def replace(self, **changes) -> "MolBatch":
        return dataclasses.replace(self, **changes)

    def to(self, device, non_blocking: bool = False) -> "MolBatch":
        """Every tensor field on `device` (None fields stay None)."""
        moved = {
            f.name: (None if (t := getattr(self, f.name)) is None
                     else t.to(device, non_blocking=non_blocking))
            for f in dataclasses.fields(self)
        }
        return MolBatch(**moved)
