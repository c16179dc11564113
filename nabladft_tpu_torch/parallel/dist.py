"""Data parallelism over a ``torch.distributed`` process group, and the
dp×mp grid.

The counterpart of ``nabladft_tpu/parallel/mesh.py``. JAX jits one program
over a mesh: the batch's molecule axis is split over "dp", the parameters
are replicated, and XLA inserts the sums. Here every rank is a process of
its own (one per card under ``torchrun``; gloo over CPU processes in the
tests), and the sums are written out:

  * every rank builds the same seeded loader, and `shard_batch` gives it its
    rows of each global batch (the counterpart of `batch_sharding` /
    `shard_batch`); a batch that does not divide the world is split
    unevenly, where JAX shrinks its mesh (`Trainer._maybe_shrink_mesh`);
  * `all_reduce_sums` adds detached scalars over the ranks in one
    collective (the losses' sums and counts, the metrics' accumulators);
  * `all_reduce_grads` adds the parameter gradients in one flat buffer per
    dtype;
  * `broadcast_tensors` copies rank 0's weights to every rank,
    `broadcast_object` a host object;
  * `gather_to_main` brings host objects to rank 0, which writes.

Without a grid every rank is a dp rank. `make_grid(n_dp, n_mp)` lays the
ranks out as JAX's `make_mesh(n_dp, n_mp)` lays out devices (rank r at dp
index r // n_mp, mp index r % n_mp): a `Grid`, which the helpers that cut
take. The "mp" axis is the one JAX reserves for the Hamiltonian models: the
dense [B, O, O] matrices' orbital rows are split over it
(`shard_orbital_rows`), while every mp rank of a dp index holds the same
molecules and runs their forward whole. Every sum over a grid is one
collective over the world (the losses count a molecule sum on mp index 0
alone), so a grid builds no subgroup. `ALONE` is the grid of this process
alone, which reduces over nothing (an unsharded reference inside a group).

With no initialised group the world has size 1 and every helper is the
identity; the collectives are skipped as well in a group of one.
`init_from_env` starts a group under a launcher (``torchrun`` sets
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
a group the caller started is used as it is. The dry run's groups start
with `TIMEOUT`: a collective that waits longer on a rank that never comes
raises (gloo's own default is 30 minutes); a job's group keeps torch's
default.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=60)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def init_from_env(device: Optional[torch.device] = None,
                  timeout: Optional[datetime.timedelta] = None) -> bool:
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
    kw = {} if timeout is None else dict(timeout=timeout)
    dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kw)
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


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in a dp×mp grid over the world (`make_grid`)."""

    n_dp: int
    n_mp: int
    dp_index: int
    mp_index: int

    @property
    def size(self) -> int:
        return self.n_dp * self.n_mp


ALONE = Grid(n_dp=1, n_mp=1, dp_index=0, mp_index=0)  # this process, no collective


def make_grid(n_dp: Optional[int] = None, n_mp: int = 1) -> Grid:
    """The world as an n_dp × n_mp grid (`make_mesh`'s layout); n_dp None
    means world // n_mp."""
    world, n_mp = world_size(), int(n_mp)
    if n_mp < 1 or world % n_mp:
        raise ValueError(f"make_grid: n_mp={n_mp} does not divide the world size {world}")
    n_dp = world // n_mp if n_dp is None else int(n_dp)
    if n_dp * n_mp != world:
        raise ValueError(f"make_grid: n_dp={n_dp} x n_mp={n_mp} is not the world size {world}")
    d, m = divmod(rank(), n_mp)
    return Grid(n_dp=n_dp, n_mp=n_mp, dp_index=d, mp_index=m)


def _split(n: int, i: int, parts: int) -> slice:
    """Part `i` of `parts` of a leading axis of `n`: contiguous, the first
    n % parts one row more (``numpy.array_split``)."""
    q, extra = divmod(n, parts)
    start = i * q + min(i, extra)
    return slice(start, start + q + (1 if i < extra else 0))


def shard_rows(n: int, grid: Optional[Grid] = None) -> slice:
    """This rank's molecules of a leading axis of `n`: its dp index's part
    (``numpy.array_split``)."""
    if grid is None:
        return _split(n, rank(), world_size())
    return _split(n, grid.dp_index, grid.n_dp)


def shard_orbital_rows(o: int, grid: Optional[Grid] = None) -> slice:
    """This rank's rows of an [B, O, O] matrix's `o` orbital rows: its mp
    index's part, split as `shard_rows` splits molecules; all of them
    without a grid."""
    return slice(0, o) if grid is None else _split(o, grid.mp_index, grid.n_mp)


def shard_batch(batch, grid: Optional[Grid] = None):
    """This rank's molecules of a global MolBatch (every tensor field cut on
    its leading axis by its dp index); the batch itself on a dp axis of
    one."""
    if (world_size() if grid is None else grid.n_dp) == 1:
        return batch
    sl = shard_rows(batch.z.shape[0], grid)
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


def all_ranks(flag: torch.Tensor) -> bool:
    """Whether the boolean tensor `flag` holds everywhere on every rank
    (`jnp.all` over a dp-sharded array): one host read, and one collective
    in a world of more than one."""
    local = bool(flag.all())
    if world_size() == 1:
        return local
    # the ranks where it fails, counted
    (fails,) = all_reduce_sums([torch.tensor(0.0 if local else 1.0, device=flag.device)])
    return bool(fails == 0)


def rank_sum(t: torch.Tensor) -> torch.Tensor:
    """A detached scalar summed over the ranks (`jnp.sum` over a dp-sharded
    array), in its own dtype."""
    return all_reduce_sums([t])[0]


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


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank `src`'s host object (a path, numbers) on every rank; `obj` in a
    world of one."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def gather_to_main(obj: Any) -> Optional[List[Any]]:
    """Every rank's `obj` (host data: numpy arrays, numbers) as a list in
    rank order on rank 0, None on the others; [obj] in a world of one.
    Objects travel through the host, which gloo needs for gathers."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size() if is_main() else None
    dist.gather_object(obj, out, dst=0)
    return out
