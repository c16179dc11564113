"""Profiling, step-time and MFU accounting (``nabladft_tpu/train/profiling.py``).

  * `trace(log_dir)`: a `torch.profiler` trace of the enclosed block (CPU and,
    where there is a card, CUDA activity), written as a Chrome trace
    (`trace.json`) under `log_dir`; it needs no `tensorboard` package. The
    Trainer runs its train loop inside it with TrainerConfig.profile_dir
    (under data parallelism one trace a rank, `trace_rank<r>.json`).
  * `step_flops(fn, *args)`: the FLOPs one call performs (the JAX package
    asks XLA's cost analysis): `torch.utils.flop_counter.FlopCounterMode`
    over the ATen operators it runs, plus the hand-written kernels' own FLOP
    models (`fwd_work`, `bwd_work`, `flops_bytes` of each kernel file) for
    each launch, which the wrappers report (`_kernels.flop_tally`).
  * `measured_peak_flops(device, dtype)`: the dense-matmul rate of the card in
    this process, timed with CUDA events (no table of data-sheet peaks); None
    off the card, where no mfu is logged.
  * `mfu(flops_per_step, step_time, peak_flops, n_devices)`: model FLOPs
    utilisation (the global step's FLOPs over the devices' summed peak).
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Callable, Optional

import torch

from nabladft_tpu_torch.ops import _kernels


def measured_peak_flops(device: torch.device, dtype: torch.dtype = torch.bfloat16,
                        n: int = 8192, iters: int = 8) -> Optional[float]:
    """The dense [n, n] @ [n, n] matmul rate of the card (FLOP/s) in `dtype`,
    under this process's matmul settings (TF32 allowed or not): the ceiling
    MFU is held against. None off the card."""
    if torch.device(device).type != "cuda":
        return None
    x = torch.ones((n, n), dtype=dtype, device=device)
    x @ x  # warm-up: cuBLAS picks its kernel
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        x @ x
    stop.record()
    stop.synchronize()
    return 2.0 * n ** 3 * iters / (start.elapsed_time(stop) / 1e3)


def step_flops(fn: Callable, *args, **kwargs):
    """((FLOPs of one call of fn(*args, **kwargs), the hand-written
    kernels' share of them), its result)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, _kernels.flop_tally() as kernels:
        out = fn(*args, **kwargs)
    return (float(counter.get_total_flops()) + kernels[0], kernels[0]), out


def mfu(flops_per_step: float, step_time_s: float, peak_flops: float,
        n_devices: int = 1) -> Optional[float]:
    """Model FLOPs utilisation: achieved FLOP/s over `peak_flops` per device;
    None without a positive step time and peak."""
    if step_time_s <= 0 or not peak_flops or peak_flops <= 0:
        return None
    return flops_per_step / step_time_s / (peak_flops * n_devices)


@contextlib.contextmanager
def trace(log_dir, name: str = "trace.json"):
    """Profile the enclosed block; its Chrome trace lands in
    `log_dir`/`name` when the block ends (also by an exception)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(log_dir / name))


class StepTimer:
    """Exponential-moving-average step timer with MFU reporting."""

    def __init__(self, decay: float = 0.9, peak_flops: Optional[float] = None):
        self.decay = decay
        self.peak_flops = peak_flops
        self.avg: Optional[float] = None
        self.flops: Optional[float] = None

    def update(self, dt: float) -> float:
        self.avg = dt if self.avg is None else self.decay * self.avg + (1 - self.decay) * dt
        return self.avg

    def metrics(self, batch_size: int, n_devices: int = 1) -> dict:
        out: dict = {}
        if self.avg:
            out["step_time_s"] = self.avg
            out["examples_per_sec"] = batch_size / self.avg
            if self.flops and self.peak_flops:
                u = mfu(self.flops, self.avg, self.peak_flops, n_devices)
                if u is not None:
                    out["mfu"] = u
        return out
