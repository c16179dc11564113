"""Model zoo: NNPs as torch modules (PaiNN, SchNet, QHNet, eSCN and EquiformerV2 so far)."""

from nabladft_tpu_torch.models.base import (  # noqa: F401
    MODEL_REGISTRY,
    create_model,
    forward,
    register_model,
)
from nabladft_tpu_torch.models.equiformer_v2 import EquiformerV2  # noqa: F401
from nabladft_tpu_torch.models.escn import ESCN  # noqa: F401
from nabladft_tpu_torch.models.painn import PaiNN  # noqa: F401
from nabladft_tpu_torch.models.qhnet import QHNet  # noqa: F401
from nabladft_tpu_torch.models.schnet import SchNet  # noqa: F401
