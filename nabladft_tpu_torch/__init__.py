"""nablaDFT on PyTorch and CUDA: the port of `nabladft_tpu` to an NVIDIA H100.

A second package beside the JAX one, with the same module layout. It
imports torch, numpy and the standard library, never JAX or the JAX
package. Plain tensor code is PyTorch; every Pallas kernel of the JAX
package becomes a hand-written CUDA kernel for Hopper (``csrc/``), each with
a plain PyTorch version that the CPU runs and the tests hold it against.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from nabladft_tpu_torch.data.batch import MolBatch  # noqa: F401
