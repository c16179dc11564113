"""Data parallelism over a ``torch.distributed`` process group.

The counterpart of ``nabladft_tpu/parallel/mesh.py``'s "dp" axis. JAX jits
one program over a mesh: the batch's molecule axis is split over "dp", the
parameters are replicated, and XLA inserts the sums. Here every rank is a
process of its own (one per card under ``torchrun``; gloo over CPU
processes in the tests), and the sums are written out:

  * every rank builds the same seeded loader, and `shard_batch` gives it its
    rows of each global batch (the counterpart of `batch_sharding` /
    `shard_batch`); a batch that does not divide the world is split
    unevenly, where JAX shrinks its mesh (`Trainer._maybe_shrink_mesh`);
  * `all_reduce_sums` adds detached scalars over the ranks in one
    collective (the losses' sums and counts, the metrics' accumulators);
  * `all_reduce_grads` adds the parameter gradients in one flat buffer per
    dtype;
  * `broadcast_tensors` copies rank 0's weights to every rank;
  * `gather_to_main` brings host objects to rank 0, which writes.

With no initialised group the world has size 1 and every helper is the
identity; the collectives are skipped as well in a group of one.
`init_from_env` starts a group under a launcher (``torchrun`` sets
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
a group the caller started is used as it is.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def init_from_env(device: Optional[torch.device] = None) -> bool:
    """Start the process group a launcher describes (``torchrun`` sets
    ``RANK`` and ``WORLD_SIZE``, even for one process), unless one exists or
    no launcher started this process. The card is made current first
    (``torch.cuda.set_device``): the hand-written kernels launch on the
    current device and stream. nccl on a CUDA device, gloo otherwise.
    Returns whether this call started the group (its caller tears it down
    with `destroy`)."""
    if is_initialized() or "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def destroy(started: bool) -> None:
    """Tear down the group if `init_from_env` started it."""
    if started and is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def check_n_dp(n_dp: Optional[int]) -> int:
    """The data-parallel width: `n_dp` None means the world size (as JAX's
    None means every device); a set `n_dp` must equal it, since the launcher,
    not the config, sets how many processes there are."""
    world = world_size()
    if n_dp is not None and int(n_dp) != world:
        raise ValueError(
            f"TrainerConfig n_dp={n_dp} but the process group has world size {world}: the "
            f"launcher sets the data-parallel width (torchrun --nproc_per_node {n_dp}); set "
            f"n_dp to {world} or leave it None")
    return world


def shard_rows(n: int) -> slice:
    """This rank's rows of a leading axis of `n`: contiguous, the first
    n % world ranks one row more (``numpy.array_split``)."""
    r, (q, extra) = rank(), divmod(n, world_size())
    start = r * q + min(r, extra)
    return slice(start, start + q + (1 if r < extra else 0))


def shard_batch(batch):
    """This rank's molecules of a global MolBatch (every tensor field cut on
    its leading axis); the batch itself in a world of one."""
    if world_size() == 1:
        return batch
    sl = shard_rows(batch.z.shape[0])
    return batch.replace(**{f.name: getattr(batch, f.name)[sl]
                            for f in dataclasses.fields(batch)
                            if getattr(batch, f.name) is not None})


def all_reduce_sums(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sums over the ranks of detached scalars, in one collective (in
    float64, so counts stay exact), each back in its own dtype; the
    tensors themselves, detached, in a world of one."""
    tensors = [t.detach() for t in tensors]
    if world_size() == 1 or not tensors:
        return tensors
    buf = torch.stack([t.reshape(()).to(torch.float64) for t in tensors])
    dist.all_reduce(buf)
    return [v.to(t.dtype) for v, t in zip(buf.unbind(), tensors)]


def any_rank(flag: bool, device: torch.device) -> bool:
    """Whether `flag` holds on any rank (a decision every rank must share,
    such as a wall-clock stop)."""
    if world_size() == 1:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


def _by_dtype(tensors: Sequence[torch.Tensor]):
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def all_reduce_grads(grads: Sequence[torch.Tensor]) -> None:
    """Sum gradients over the ranks in place: one flat buffer per dtype,
    one all-reduce each."""
    if world_size() == 1:
        return
    for group in _by_dtype(grads):
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat)
        for v, g in zip(flat.split([g.numel() for g in group]), group):
            g.copy_(v.view_as(g))


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Copy rank `src`'s tensors into every rank's, in place: one flat
    broadcast per dtype."""
    if world_size() == 1:
        return
    for group in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        for v, t in zip(flat.split([t.numel() for t in group]), group):
            t.copy_(v.view_as(t))


def gather_to_main(obj: Any) -> Optional[List[Any]]:
    """Every rank's `obj` (host data: numpy arrays, numbers) as a list in
    rank order on rank 0, None on the others; [obj] in a world of one.
    Objects travel through the host, which gloo needs for gathers."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size() if is_main() else None
    dist.gather_object(obj, out, dst=0)
    return out
