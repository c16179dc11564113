"""Build and load the port's CUDA kernels.

``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, which `ctypes` loads. The build
happens at first use, keyed on a hash of the source and of the headers beside
it (``csrc/*.cuh``), into ``_build/`` beside the package (listed in
``.gitignore``). A failed build raises: there is no
fallback on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    pass


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # a source may include any of them
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(name: str = "painn_fused") -> dict:
    """Compile csrc/<name>.cu unless it is built already. Returns
    {"seconds", "log"} (nvcc's -Xptxas -v output, or "cached"); raises
    KernelBuildError with nvcc's output if the build fails."""
    out = library_path(name)
    if out.exists():
        return {"seconds": 0.0, "log": "cached"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return {"seconds": time.perf_counter() - t0, "log": proc.stdout}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))


def check_inputs(tensors: Dict[str, torch.Tensor], shapes: Dict[str, tuple],
                 dtypes: Tuple[torch.dtype, ...] = (torch.float32,)) -> torch.device:
    """A kernel wrapper's inputs: same device, one dtype of `dtypes` for
    all (a mix is refused), the expected shapes, contiguous on the card.
    Raises ValueError; returns the device."""
    first = next(iter(tensors.values()))
    dev, dtype = first.device, first.dtype
    if dtype not in dtypes:
        raise ValueError(f"the inputs have dtype {dtype}; the kernels take one of {dtypes}")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, the others {dtype}: the kernels "
                             "take one dtype for all inputs")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def raise_on_error(err: int, what: str) -> None:
    """Raise when a kernel entry point returned a cudaError_t other than 0."""
    if err != 0:
        raise RuntimeError(f"{what} failed with cudaError {err}")


# FLOPs of the kernels launched while a tally is open (`flop_tally`): the
# ctypes launches are no ATen operators, so FlopCounterMode does not see them
_TALLY: Optional[List[float]] = None


@contextlib.contextmanager
def flop_tally():
    """Yield a one-item list that sums, while the block runs, the FLOPs each
    kernel launch reports through `count_flops`."""
    global _TALLY
    outer, _TALLY = _TALLY, [0.0]
    try:
        yield _TALLY
    finally:
        _TALLY = outer


def count_flops(work: Callable[[], float]) -> None:
    """At a kernel launch: add work() (the FLOPs its inputs need, the
    kernel file's own model) to the open tally. work runs only inside
    `flop_tally`: counting the live pairs reads the card."""
    if _TALLY is not None:
        _TALLY[0] += float(work())
