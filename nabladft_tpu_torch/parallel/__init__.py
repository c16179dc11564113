"""Data parallelism over a torch.distributed process group (`dist`)."""

from nabladft_tpu_torch.parallel import dist  # noqa: F401
