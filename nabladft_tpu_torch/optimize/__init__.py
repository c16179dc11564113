"""Geometry optimisation on the device: batched L-BFGS, MD, vibrations."""

from nabladft_tpu_torch.optimize.calculator import BatchwiseCalculator  # noqa: F401
from nabladft_tpu_torch.optimize.lbfgs import LBFGSResult, lbfgs_relax  # noqa: F401
from nabladft_tpu_torch.optimize.md import (  # noqa: F401
    maxwell_boltzmann_velocities,
    normal_modes,
    run_md,
)
from nabladft_tpu_torch.optimize.metrics import optimization_metrics  # noqa: F401
from nabladft_tpu_torch.optimize.task import BatchwiseOptimizeTask, run_optimize_job  # noqa: F401
