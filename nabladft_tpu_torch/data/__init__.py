"""Data layer: the ASE SQLite codec, the Hamiltonian DB, and bucketed
fixed-shape energy and Hamiltonian batches."""

from nabladft_tpu_torch.data.ase_codec import AseDatabase, AtomsRecord  # noqa: F401
from nabladft_tpu_torch.data.batch import MolBatch  # noqa: F401
from nabladft_tpu_torch.data.dataset import (  # noqa: F401
    BucketedLoader,
    DataModule,
    EnergyDataset,
    HamiltonianDataset,
    LoaderConfig,
    seeded_random_split,
)
