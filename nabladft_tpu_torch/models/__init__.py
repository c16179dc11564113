"""Model zoo: NNPs as torch modules (PaiNN so far)."""

from nabladft_tpu_torch.models.base import (  # noqa: F401
    MODEL_REGISTRY,
    create_model,
    forward,
    register_model,
)
from nabladft_tpu_torch.models.painn import PaiNN  # noqa: F401
