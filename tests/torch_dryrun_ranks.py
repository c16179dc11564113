"""The scenarios of tests/test_torch_dryrun.py, run in each rank of a gloo group.

Imports torch, numpy and the port, never JAX: the ranks are started with
the `spawn` method and import this module alone. `rank_main` starts the
group (a `file://` store, so concurrent test workers need no port), runs
every scenario once, pickles its results to `<out>/rank<r>.pkl` and its
printed lines to `<out>/rank<r>.out`. The same scenario functions, called
in a process with no group, give the port's n_dp=1 run. The inputs are made
here from seeds with numpy (`nabladft_tpu_torch.dryrun`'s array makers), so the
test process builds the JAX references on the same numbers.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import traceback
from pathlib import Path

import torch

from nabladft_tpu_torch import dryrun as D
from nabladft_tpu_torch.models import forward
from nabladft_tpu_torch.optimize.lbfgs import lbfgs_relax
from nabladft_tpu_torch.parallel import dist
from nabladft_tpu_torch.train.losses import multitask_loss
from tests import torch_dp_ranks as DP

WORLD = 4
GRID = (2, 2)  # n_dp, n_mp: the JAX dry run's grid on four devices
SIZE = D.SIZES["tiny"]
RELAX_STEPS = 3
LINE_SEARCHES = ("off", "mt")
# "pad": the last rank's share of the relaxation batch is all padding
RELAX_LAYOUTS = ("whole", "pad")


def relax_arrays(layout: str) -> dict:
    """The dry run's phase-3 batch (two molecules a rank); in "pad" its last
    two rows are padding."""
    arrays = D.example_arrays(SIZE["relax_mols"] * WORLD, SIZE["atoms"], seed=3)
    if layout == "pad":
        for k in ("z", "pos", "node_mask", "forces"):
            arrays[k][-2:] = 0
        arrays["graph_mask"][-2:] = False
    return arrays


def _relax(arrays: dict, line_search: str) -> dict:
    """L-BFGS of this rank's share over the ranks, the dry run's relaxation
    model (seed 1)."""
    model = D.painn(SIZE["painn"], "cpu", 1)

    def energy_forces(b):
        out = forward(model, b)
        return out["energy"], out["forces"]

    batch = D.to_batch(arrays, "cpu")
    res = lbfgs_relax(energy_forces, dist.shard_batch(batch), fmax=D.RELAX["fmax"],
                      max_steps=RELAX_STEPS, memory=D.RELAX["memory"], line_search=line_search)
    return dict(rows=dist.shard_rows(len(arrays["mol_id"])), pos=res.pos.numpy(),
                energy=res.energy.numpy(), converged=res.converged.numpy(), nsteps=res.nsteps)


# ---------------------------------------------------------------------------
# scenarios: each returns host data (numpy, numbers, strings)
# ---------------------------------------------------------------------------


def dryrun_scenario(tmp: Path) -> dict:
    """The five phases at the JAX dry run's sizes."""
    work = tmp / "dryrun_work"
    if dist.is_main():
        work.mkdir(exist_ok=True)
    dist.barrier()
    return D.dryrun_multichip(WORLD, "tiny", "cpu", workdir=work)


def relax_scenario(tmp: Path) -> dict:
    """`lbfgs_relax` over every rank, each line search and layout,
    RELAX_STEPS iterations."""
    return {(ls, layout): _relax(relax_arrays(layout), ls)
            for ls in LINE_SEARCHES for layout in RELAX_LAYOUTS}


def grid_scenario(tmp: Path) -> dict:
    """On a 2×2 grid: this rank's place, `multitask_loss` of its share for
    every loss kind (molecule sums from mp index 0, matrix rows split over
    mp) with the gradients with respect to its predictions."""
    grid = dist.make_grid(*GRID) if dist.world_size() > 1 else None
    out = {"place": None if grid is None else (grid.dp_index, grid.mp_index, grid.n_dp,
                                               grid.n_mp)}
    for layout in DP.LOSS_LAYOUTS:
        arrays, preds = DP.loss_arrays(layout)
        sl = dist.shard_rows(len(arrays["mol_id"]), grid)
        batch = dist.shard_batch(DP.tb(arrays), grid)
        out["orbital_rows", layout] = dist.shard_orbital_rows(arrays["orb_mask"].shape[1], grid)
        for case, (specs, coefs, max_errors) in DP.LOSS_CASES.items():
            pred = {k: torch.from_numpy(v[sl].copy()).requires_grad_(True)
                    for k, v in preds.items()}
            losses = multitask_loss(pred, batch, specs, coefs, max_errors=max_errors, grid=grid)
            losses["total"].backward()
            out[layout, case] = dict(
                rows=sl, values={k: float(v.detach()) for k, v in losses.items()},
                grads={k: v.grad.numpy() for k, v in pred.items() if v.grad is not None})
    return out


def refusal_scenario(tmp: Path) -> dict:
    """A grid whose n_mp does not divide the world, and one whose n_dp ×
    n_mp is not the world."""
    out = {}
    for key, kw in (("n_mp", dict(n_mp=3)), ("n_dp", dict(n_dp=3, n_mp=2))):
        try:
            dist.make_grid(**kw)
        except ValueError as e:
            out[key] = str(e)
    return out


SCENARIOS = {"dryrun": dryrun_scenario, "relax": relax_scenario, "grid": grid_scenario,
             "refusals": refusal_scenario}


def rank_main(r: int, world: int, store: str, out_dir: str) -> None:
    """One rank: the gloo group over `store` (with the port's collective
    timeout), every scenario in order (the first failure ends the run: the
    other ranks' collectives then time out), its results pickled to
    `<out_dir>/rank<r>.pkl` and its printed lines in `<out_dir>/rank<r>.out`."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"file://{store}", rank=r,
                                         world_size=world, timeout=dist.TIMEOUT)
    results = {}
    try:
        with open(os.path.join(out_dir, f"rank{r}.out"), "w") as log, \
                contextlib.redirect_stdout(log):
            for name, fn in SCENARIOS.items():
                try:
                    results[name] = fn(Path(out_dir))
                except Exception:  # recorded: each test reads its own scenario
                    results[name] = {"error": traceback.format_exc()}
                    break
    finally:
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
            pickle.dump(results, f)
        torch.distributed.destroy_process_group()
