"""The training engine: trainer, losses, metrics, schedules, checkpoints, loggers."""

from nabladft_tpu_torch.train.engine import (  # noqa: F401
    Trainer,
    TrainerConfig,
    seeded_generator,
)
from nabladft_tpu_torch.train.loggers import (  # noqa: F401
    CSVLogger,
    Logger,
    MultiLogger,
    NullLogger,
    StdoutLogger,
    TensorBoardLogger,
    WandbLogger,
)
