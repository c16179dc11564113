"""Entry points of the port: a one-card compile check and the multi-card dry
run (the counterpart of the JAX package's ``__graft_entry__.py``).

`entry()` returns PaiNN's forward at painn-oc width and an example batch.

`dryrun_multichip(n)` runs the framework's parallel layouts on n ranks of a
process group that the caller started (or, in a world of one, every phase
unsharded on batches sized for n ranks: the reference a group's run is held
against). Each phase checks what the JAX dry run checks and prints a
``dryrun ...: ok`` line on rank 0:

  1. one data-parallel PaiNN train step through the Trainer;
  2. QHNet's ``rmse_mae`` loss and gradients over a dp×mp grid (n_mp = 2
     when n is even): molecules over dp, the dense Hamiltonian's orbital
     rows over mp; rank 0 holds them against the unsharded loss and
     gradients (1e-4 relative, as JAX);
  3. ``lbfgs_relax`` over the dp group (fmax 0.05, 4 steps, memory 8);
  4. PhiSNet's H, S and core loss and gradients over the same grid;
  5. a data-parallel fit whose checkpoint, restored into a fresh trainer,
     reproduces the validation loss (1e-6 relative).

The mp axis splits the matrices and the loss, not the model's compute: each
mp rank runs its dp shard's forward whole, as the JAX dry run shards only
the matrices. A phase that fails raises, naming itself; under the launcher a
collective that waits on a rank that never comes raises after the group's
timeout (`parallel.dist.TIMEOUT`). Each phase's results name the (B, A) of
every batch its kernels ran on in this process (`shapes`). Two size sets: "tiny", the JAX dry run's own,
and "full", the widths of configs/painn-oc.yaml (phases 1, 5),
configs/painn-oc_optim.yaml (3), configs/qhnet.yaml (2) and
configs/phisnet.yaml (4).

Under a launcher, on one card a rank::

    torchrun --nproc_per_node N -m nabladft_tpu_torch.dryrun [--size tiny] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from nabladft_tpu_torch.data.ase_codec import AseDatabase, AtomsRecord
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.data.dataset import DataModule, EnergyDataset
from nabladft_tpu_torch.data.synthetic import BOHR_PER_ANGSTROM, DEF2_SVP_SHELLS, random_molecule
from nabladft_tpu_torch.models import create_model, forward
from nabladft_tpu_torch.optimize.lbfgs import lbfgs_relax
from nabladft_tpu_torch.parallel import dist
from nabladft_tpu_torch.train import Trainer, TrainerConfig, seeded_generator
from nabladft_tpu_torch.train.losses import multitask_loss
from nabladft_tpu_torch.utils import resolve_device

PAINN_OC = dict(hidden=128, n_interactions=6, n_rbf=100, cutoff=5.0, max_neighbors=63,
                rbf="gaussian", envelope="polynomial", envelope_exponent=5)
# per phase: model widths, molecules per rank (phases 1, 3) or per dp index
# (2, 4) and atoms per molecule; "fit" sizes phase 5's DB and batch per rank
SIZES: Dict[str, Dict[str, Any]] = {
    "tiny": dict(  # __graft_entry__.py's _dryrun_impl
        painn=dict(hidden=32, n_interactions=2, n_rbf=16, max_neighbors=7),
        mols=2, atoms=8, relax_mols=2,
        qhnet=dict(hidden=8, bottle_hidden=4, num_layers=2, rbf_dim=8, start_layer=0,
                   remat=False),
        phisnet=dict(order=2, num_features=4, num_basis_functions=4, num_modules=1, remat=False),
        orbitals={1: (0, 0, 1), 6: (0, 0, 0, 1, 1, 2)}, ham_mols=2, ham_atoms=5,
        fit_painn=dict(hidden=16, n_interactions=2, n_rbf=8, max_neighbors=5),
        fit=dict(mols=12, batch=4, lr=1e-2, losses={"energy": "l1"}),
    ),
    "full": dict(
        painn=PAINN_OC,  # configs/model/painn-oc.yaml
        mols=16, atoms=32,  # 64 molecules on four ranks: the energy datamodule's batch
        relax_mols=8,  # 32 on four ranks: configs/painn-oc_optim.yaml's batch
        qhnet=dict(hidden=128, bottle_hidden=32, num_layers=5, radius_cutoff=12.0,
                   rbf_dim=32),  # configs/model/qhnet.yaml
        phisnet=dict(order=4, num_features=128, num_basis_functions=128, num_modules=5,
                     cutoff=15.0),  # configs/model/phisnet.yaml
        orbitals={z: DEF2_SVP_SHELLS[z] for z in (1, 6, 7, 8)},
        # 8 molecules on two dp indices (the Hamiltonian batch) of up to 32 atoms
        ham_mols=4, ham_atoms=32,
        fit_painn=PAINN_OC,
        fit=dict(mols=12, batch=4, lr=1e-3, losses={"energy": "l1", "forces": "l2norm"}),
    ),
}
STEP = dict(schedule="constant", lr=1e-3, ema_decay=0.99,
            loss_specs={"energy": "l1", "forces": "l2norm"},
            loss_coefs={"energy": 1.0, "forces": 1.0})
RELAX = dict(fmax=0.05, max_steps=4, memory=8)
MATRIX_LOSSES = {"qhnet": ("hamiltonian",), "phisnet": ("hamiltonian", "overlap", "core")}
UNSHARDED_RTOL = 1e-4  # __graft_entry__.py:216
RESTORE_RTOL = 1e-6


def example_arrays(b: int, a: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """numpy fields of `b` random molecules of a/2..a atoms (elements 1-16,
    positions in a cube of 8 Å), with random energy and force targets
    (``__graft_entry__._example_batch``)."""
    rng = np.random.default_rng(seed)
    z = np.zeros((b, a), np.int32)
    pos = np.zeros((b, a, 3), np.float32)
    node_mask = np.zeros((b, a), bool)
    for i in range(b):
        n = int(rng.integers(a // 2, a + 1))
        z[i, :n] = rng.integers(1, 17, n)
        pos[i, :n] = rng.uniform(-4, 4, (n, 3))
        node_mask[i, :n] = True
    return dict(z=z, pos=pos, node_mask=node_mask, graph_mask=np.ones((b,), bool),
                energy=rng.normal(size=(b,)).astype(np.float32),
                forces=(rng.normal(size=(b, a, 3)).astype(np.float32) * node_mask[..., None]),
                mol_id=np.arange(b, dtype=np.int32))


def hamiltonian_arrays(b: int, a: int, orbitals: Dict[int, tuple],
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """numpy fields of `b` molecules of a/2+1..a atoms (half of them or more
    H, the rest the basis's heavier elements; positions in Bohr, atoms at
    least 0.95 Å apart) with symmetric random H, S = H + 1 and core = H / 2
    (the JAX dry run's targets), orbitals padded to a multiple of 16."""
    rng = np.random.default_rng(seed)
    norb = {z: sum(2 * l + 1 for l in ls) for z, ls in orbitals.items()}
    heavy = [z for z in sorted(orbitals) if z != 1]
    mols = []
    for _ in range(b):
        n = int(rng.integers(a // 2 + 1, a + 1))
        zs = np.ones(n, np.int32)
        zs[: max(1, n // 2)] = rng.choice(heavy, size=max(1, n // 2))
        mols.append((zs, random_molecule(rng, n)[1] * BOHR_PER_ANGSTROM))
    o = -(-max(sum(norb[int(q)] for q in zs) for zs, _ in mols) // 16) * 16
    f = dict(z=np.zeros((b, a), np.int32), pos=np.zeros((b, a, 3), np.float32),
             node_mask=np.zeros((b, a), bool), graph_mask=np.ones((b,), bool),
             energy=np.zeros((b,), np.float32), forces=np.zeros((b, a, 3), np.float32),
             mol_id=np.arange(b, dtype=np.int32), hamiltonian=np.zeros((b, o, o), np.float32),
             orb_mask=np.zeros((b, o), bool))
    for i, (zs, pos) in enumerate(mols):
        n, no = len(zs), sum(norb[int(q)] for q in zs)
        f["z"][i, :n], f["pos"][i, :n], f["node_mask"][i, :n] = zs, pos, True
        h = rng.normal(size=(no, no)).astype(np.float32)
        f["hamiltonian"][i, :no, :no] = (h + h.T) / 2
        f["orb_mask"][i, :no] = True
    f["overlap"] = f["hamiltonian"] + np.eye(o, dtype=np.float32)
    f["core"] = f["hamiltonian"] * 0.5
    return f


def to_batch(arrays: Dict[str, np.ndarray], device) -> MolBatch:
    return MolBatch(**{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}).to(device)


def grid_shape(n: int):
    """(n_dp, n_mp) of the JAX dry run's phases 2 and 4: mp 2 when n is even."""
    n_mp = 2 if n % 2 == 0 and n > 1 else 1
    return n // n_mp, n_mp


def launches() -> Dict[str, int]:
    """Every hand-written kernel's launch count so far (its wrapper's)."""
    from nabladft_tpu_torch.ops import eqv2_attn, escn_layer, painn_fused, qhnet_tp, schnet_fused

    return {**painn_fused.LAUNCHES, **schnet_fused.LAUNCHES, **qhnet_tp.LAUNCHES,
            **escn_layer.LAUNCHES, **eqv2_attn.LAUNCHES}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in launches().items()}


def _say(line: str) -> None:
    if dist.is_main():
        print(line, flush=True)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def painn(kw: dict, device, seed: int):
    """PaiNN with seeded weights, its fused kernels on the card (their plain
    versions on CPU tensors), every rank holding rank 0's weights."""
    model = create_model("painn", device=device, generator=seeded_generator(seed),
                         use_pallas="fused", **kw)
    dist.broadcast_tensors(list(model.parameters()))
    return model


def entry(device=None):
    """(fn, (model, batch)): fn(model, batch) -> the energy and forces dict of
    PaiNN at painn-oc width on an example batch of eight molecules."""
    device = resolve_device(device)
    model = create_model("painn", device=device, generator=seeded_generator(0),
                         use_pallas="fused", **PAINN_OC)
    return forward, (model, to_batch(example_arrays(8, 32), device))


def _grads(model) -> list:
    """Each parameter's gradient, a zero one where the loss did not reach it."""
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in model.parameters()]


def _named_grads(model) -> Dict[str, np.ndarray]:
    return {n: p.grad.detach().cpu().numpy().copy() for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# the phases: each returns host data (numbers, numpy arrays)
# ---------------------------------------------------------------------------


def train_step_phase(n: int, size: dict, device, tmp: Path) -> dict:
    """(1) One data-parallel PaiNN train step (every rank a dp rank)."""
    trainer = Trainer(painn(size["painn"], device, 0), device,
                      TrainerConfig(force_grads="pallas", log_every_n_steps=10**9, **STEP))
    batch = to_batch(example_arrays(size["mols"] * n, size["atoms"]), device)
    before = launches()
    local = dist.shard_batch(batch)
    metrics = trainer._train_step(local)
    counts = _since(before)
    loss = float(metrics["train/total"])
    _check(trainer.step == 1 and np.isfinite(loss), f"one finite step: {metrics}")
    _say(f"dryrun dp({n}): ok, loss={loss:.4f}")
    return dict(loss=loss, grad_norm=metrics["grad_norm"], launches=counts,
                shapes=[tuple(local.z.shape)])


def matrix_phase(n: int, size: dict, device, family: str, seed: int) -> dict:
    """(2) QHNet's / (4) PhiSNet's matrix loss and gradients over the dp×mp
    grid (molecules over dp, orbital rows over mp), the gradients summed
    over the grid; rank 0 holds them against the unsharded loss and
    gradients of the global batch."""
    n_dp, n_mp = grid_shape(n)
    grid = dist.make_grid(n_dp, n_mp) if dist.world_size() > 1 else None
    batch = to_batch(hamiltonian_arrays(size["ham_mols"] * n_dp, size["ham_atoms"],
                                        size["orbitals"], seed=0), device)
    extra = dict(use_pallas="fused") if family == "qhnet" else {}
    model = create_model(family, device=device, generator=seeded_generator(seed),
                         orbitals=size["orbitals"], **size[family], **extra)
    dist.broadcast_tensors(list(model.parameters()))
    targets = MATRIX_LOSSES[family]
    specs, coefs = ({t: "rmse_mae" for t in targets}, {t: 1.0 for t in targets})

    def loss_and_grads(b, g):
        model.zero_grad(set_to_none=True)
        loss = multitask_loss(model(b), b, specs, coefs, grid=g)["total"]
        loss.backward()
        return float(loss.detach()), _grads(model)

    before = launches()
    local = dist.shard_batch(batch, grid)
    shapes = [tuple(local.z.shape)]
    loss, grads = loss_and_grads(local, grid)
    dist.all_reduce_grads(grads)
    counts = _since(before)
    named = _named_grads(model)
    gsum = float(sum(np.abs(g).sum() for g in named.values()))
    _check(np.isfinite(loss) and np.isfinite(gsum), f"finite loss {loss} and gradients")
    line = f"loss={loss:.4f}"
    if dist.is_main() and grid is not None:  # the unsharded reference
        ref, _ = loss_and_grads(batch, dist.ALONE)
        shapes.append(tuple(batch.z.shape))
        _check(abs(loss - ref) <= UNSHARDED_RTOL * max(1.0, abs(ref)),
               f"{family} grid loss {loss} against unsharded {ref}")
        for name, p in model.named_parameters():
            g, want = named[name], p.grad.detach().cpu().numpy()
            _check(np.abs(g - want).max() <= UNSHARDED_RTOL * max(np.abs(want).max(), 1e-30),
                   f"{family} grid gradient {name} against unsharded")
        line += f" (unsharded {ref:.4f})"
    name = "dp×mp" if family == "qhnet" else "phisnet dp×mp"
    what = "QHNet " if family == "qhnet" else ""
    _say(f"dryrun {name}({n_dp}×{n_mp}): ok, {what}{line}, |grad|={gsum:.4f}")
    return dict(loss=loss, grads=named, grid=(n_dp, n_mp), launches=counts, shapes=shapes)


def relax_phase(n: int, size: dict, device, tmp: Path) -> dict:
    """(3) `lbfgs_relax` of a dp-sharded batch over the dp group."""
    model = painn(size["painn"], device, 1)

    def energy_forces(b):
        out = forward(model, b)
        return out["energy"], out["forces"]

    b = size["relax_mols"] * n
    batch = to_batch(example_arrays(b, size["atoms"], seed=3), device)
    local = dist.shard_batch(batch)
    before = launches()
    res = lbfgs_relax(energy_forces, local, **RELAX)
    counts = _since(before)
    moved = dist.rank_sum((res.pos - local.pos).abs().amax((1, 2)).gt(0).sum())
    _check(res.energy.shape == local.graph_mask.shape and bool(torch.isfinite(res.energy).all()),
           f"energies {tuple(res.energy.shape)}")
    e0 = float(res.energy[0])
    _say(f"dryrun optimize dp({n}): ok, relaxed {int(moved)}/{b} configs, E[0]={e0:.4f}")
    return dict(rows=dist.shard_rows(b), pos=res.pos.cpu().numpy(),
                energy=res.energy.cpu().numpy(), converged=res.converged.cpu().numpy(),
                nsteps=res.nsteps, launches=counts, shapes=[tuple(local.z.shape)])


def write_fit_db(path: Path, n_mols: int, seed: int = 7) -> Path:
    """Molecules of 4-8 H, C and O atoms whose energies are per-element sums
    plus a little noise, zero forces (the JAX dry run's phase 5 DB)."""
    rng = np.random.default_rng(seed)
    coef = {1: 0.3, 6: -0.5, 8: 0.4}
    db = AseDatabase(path, create=True)
    try:
        for _ in range(n_mols):
            na = int(rng.integers(4, 9))
            zs = rng.choice([1, 1, 1, 6, 8], size=na).astype(np.int32)
            e = float(sum(coef[int(x)] for x in zs)) + float(rng.normal() * 0.01)
            db.write(AtomsRecord(numbers=zs, positions=rng.normal(size=(na, 3)), pbc=0,
                                 data={"energy": [e], "forces": np.zeros((na, 3))}))
    finally:
        db.close()
    return path


def fit_phase(n: int, size: dict, device, tmp: Path) -> dict:
    """(5) A data-parallel fit (8 epochs, rank 0 checkpoints), then its
    last checkpoint restored into a fresh trainer."""
    fit = size["fit"]
    db = tmp / "fit.db"
    if dist.is_main():  # one writer of the DB and of its column cache
        EnergyDataset(write_fit_db(db, fit["mols"] * n), root=tmp, bucket_boundaries=(8,))
    dist.barrier()
    dm = DataModule(EnergyDataset(db, root=tmp, bucket_boundaries=(8,)),
                    batch_size=fit["batch"] * n, val_fraction=0.25, seed=0)
    cfg = TrainerConfig(schedule="constant", lr=fit["lr"], max_epochs=8, force_grads="pallas",
                        loss_specs=fit["losses"], loss_coefs={k: 1.0 for k in fit["losses"]},
                        log_every_n_steps=10**9, ckpt_dir=str(tmp / "ckpt"))
    before = launches()
    t1 = Trainer(painn(size["fit_painn"], device, 0), device, cfg)
    loss0 = t1.validate(dm.val_dataloader())["val/loss"]
    t1.fit(dm)
    loss1 = t1.validate(dm.val_dataloader())["val/loss"]
    _check(loss1 < loss0, f"the fit lowers the validation loss: {loss0} -> {loss1}")
    last = t1.ckpt.last_path()
    _check(last is not None and last.exists(), "the last checkpoint")
    t2 = Trainer(painn(size["fit_painn"], device, 1), device,
                 dataclasses.replace(cfg, ckpt_dir=None))
    t2.load_checkpoint(last)
    loss2 = t2.validate(dm.val_dataloader())["val/loss"]
    # the fit's steps; 11 validations: before, 8 in fit, after, the restored trainer's
    counts = _since(before)
    _check(abs(loss2 - loss1) <= RESTORE_RTOL * max(1.0, abs(loss1)),
           f"the restore reproduces the validation loss: {loss1} vs {loss2}")
    _say(f"dryrun fit dp({n}): ok, val loss {loss0:.4f} -> {loss1:.4f} over 8 epochs; "
         f"restore(step {t1.step}) reproduces ({loss2:.6f})")
    shapes = sorted({tuple(dist.shard_batch(b).z.shape)
                     for loader in (dm.train_dataloader(), dm.val_dataloader()) for b in loader})
    return dict(loss0=loss0, loss1=loss1, loss2=loss2, steps=t1.step,
                val_batches=len(dm.val_dataloader()), launches=counts, shapes=shapes)


PHASES: Dict[str, Callable[..., dict]] = {
    "train_step": train_step_phase,
    "hamiltonian": lambda n, size, device, tmp: matrix_phase(n, size, device, "qhnet", 0),
    "relax": relax_phase,
    "phisnet": lambda n, size, device, tmp: matrix_phase(n, size, device, "phisnet", 2),
    "fit": fit_phase,
}


def dryrun_multichip(n_devices: int, size: str = "full", device=None,
                     workdir: Optional[Path] = None) -> Dict[str, dict]:
    """The five phases on `n_devices` ranks (the group's world) or, in a
    world of one, unsharded on the same global batches; returns each
    phase's host results. `workdir` holds phase 5's DB and checkpoints
    (rank 0's temporary directory, removed after, when None)."""
    world = dist.world_size()
    if world not in (1, n_devices):
        raise ValueError(f"dryrun_multichip({n_devices}) in a process group of {world} ranks: "
                         f"start {n_devices} ranks, or one for the unsharded run")
    device = resolve_device(device)
    sizes = SIZES[size]
    own = workdir is None
    tmp = Path(dist.broadcast_object(tempfile.mkdtemp(prefix="dryrun_") if dist.is_main()
                                     else None) if own else workdir)
    results = {}
    try:
        for name, phase in PHASES.items():
            try:
                results[name] = phase(n_devices, sizes, device, tmp)
            except Exception as e:
                raise RuntimeError(f"dryrun phase {name!r} failed on rank {dist.rank()} of "
                                   f"{world}") from e
        dist.barrier()
    finally:
        if own and dist.is_main():
            shutil.rmtree(tmp, ignore_errors=True)
    _say(f"dryrun_multichip({n_devices}): ok")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", choices=sorted(SIZES), default="full")
    ap.add_argument("--device", default=None, help="cpu: run on the CPU (gloo)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    started = dist.init_from_env(device, timeout=dist.TIMEOUT)
    try:
        fn, (model, batch) = entry(device)
        out = fn(model, batch)
        _say(f"entry ok: { {k: tuple(v.shape) for k, v in out.items()} }")
        dryrun_multichip(dist.world_size(), args.size, device)
    finally:
        dist.destroy(started)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
