"""The predict engine (training comes in a later step)."""

from nabladft_tpu_torch.train.engine import Trainer, seeded_generator  # noqa: F401
