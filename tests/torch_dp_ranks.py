"""The scenarios of tests/test_torch_dp.py, run in each rank of a gloo group.

Imports torch, numpy and the port, never JAX: the ranks are started with
the `spawn` method and import this module alone. `rank_main` starts the
group (a `file://` store, so concurrent test workers need no port), runs
every scenario once and pickles its results to `<out>/rank<r>.pkl`; the same
scenario functions, called in a process with no group, give the port's
n_dp=1 run. The inputs are made here from seeds with numpy, so the test
process builds the JAX references on the same numbers.
"""

from __future__ import annotations

import datetime
import os
import pickle
import traceback
from pathlib import Path

import numpy as np
import torch

from nabladft_tpu_torch import pipelines
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.parallel import dist
from nabladft_tpu_torch.train import Trainer, TrainerConfig, seeded_generator
from nabladft_tpu_torch.train.losses import multitask_loss

WORLD = 2
PAINN_KW = dict(hidden=16, n_interactions=2, n_rbf=8, max_neighbors=7)
LOSSES = dict(loss_specs={"energy": "l1", "forces": "l2norm"},
              loss_coefs={"energy": 1.0, "forces": 2.0})
# AdamW with weight decay and a global-norm clip that the steps trigger
TRAIN = dict(optimizer="adamw", lr=1e-3, weight_decay=0.01, grad_clip=0.5, schedule="constant",
             log_every_n_steps=1000, **LOSSES)
GEMNET_KW = dict(num_blocks=1, emb_size_atom=16, emb_size_edge=16, emb_size_trip_in=8,
                 emb_size_trip_out=8, emb_size_quad_in=8, emb_size_quad_out=8, emb_size_rbf=8,
                 emb_size_cbf=8, emb_size_sbf=8, num_radial=8, num_spherical=4,
                 num_spherical_quad=3, max_neighbors=7, max_neighbors_qint=4)
# target -> loss kind, coefficients, max-error clamps
LOSS_CASES = {
    "l1_l2norm": ({"energy": "l1", "forces": "l2norm"}, {"energy": 1.0, "forces": 2.0}, None),
    "mse_l1": ({"energy": "mse", "forces": "l1"}, {"energy": 0.5, "forces": 1.0}, None),
    "l1_mse": ({"energy": "l1", "forces": "mse"}, {"energy": 1.0, "forces": 3.0}, None),
    "rmse_mae": ({"hamiltonian": "rmse_mae", "overlap": "rmse_mae"},
                 {"hamiltonian": 1.0, "overlap": 0.5}, None),
    # the energy's MAE is far above its clamp: the gate drops it
    "gate": ({"energy": "l1", "forces": "l2norm", "hamiltonian": "rmse_mae"},
             {"energy": 1.0, "forces": 1.0, "hamiltonian": 1.0},
             {"energy": 1e-3, "forces": 1e3, "hamiltonian": 1e3}),
}
# real molecules per row of a five-row batch: rank 0 takes rows 0-2, rank 1
# rows 3-4 (uneven shards; in "pad_only" rank 1's rows are all padding)
LOSS_LAYOUTS = {"uneven": (6, 4, 2, 5, 0), "pad_only": (6, 4, 5, 0, 0)}


def loss_arrays(layout: str, seed: int = 0):
    """(batch arrays, predictions) of a five-molecule batch of at most six
    atoms, with Hamiltonian and overlap matrices of two orbitals an atom."""
    atoms = LOSS_LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    b, a, o = len(atoms), 6, 12
    node_mask = np.arange(a)[None, :] < np.array(atoms)[:, None]
    orb_mask = np.arange(o)[None, :] < 2 * np.array(atoms)[:, None]
    graph_mask = np.array(atoms) > 0
    pm = orb_mask[:, :, None] & orb_mask[:, None, :]

    def mat():
        return (rng.normal(size=(b, o, o)) * pm).astype(np.float32)

    arrays = dict(
        z=np.where(node_mask, rng.integers(1, 9, (b, a)), 0).astype(np.int32),
        pos=(rng.normal(size=(b, a, 3)) * node_mask[..., None]).astype(np.float32),
        node_mask=node_mask, graph_mask=graph_mask,
        energy=np.where(graph_mask, rng.normal(size=b), 0.0).astype(np.float32),
        forces=(rng.normal(size=(b, a, 3)) * node_mask[..., None]).astype(np.float32),
        mol_id=np.arange(b, dtype=np.int32), hamiltonian=mat(), overlap=mat(),
        orb_mask=orb_mask)
    preds = dict(energy=rng.normal(size=b).astype(np.float32),
                 forces=rng.normal(size=(b, a, 3)).astype(np.float32),
                 hamiltonian=rng.normal(size=(b, o, o)).astype(np.float32),
                 overlap=rng.normal(size=(b, o, o)).astype(np.float32))
    return arrays, preds


def train_batches(seed: int = 0, b: int = 4, a: int = 9):
    """Three global batches of four molecules with unequal atom counts; the
    last holds three molecules and a padding row."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(3):
        n_atoms = rng.integers(3, a + 1, b)
        node_mask = np.arange(a)[None, :] < n_atoms[:, None]
        graph_mask = np.ones(b, bool)
        if k == 2:
            graph_mask[-1] = False
            node_mask[-1] = False
        out.append(dict(
            z=np.where(node_mask, rng.integers(1, 9, (b, a)), 0).astype(np.int32),
            pos=(rng.uniform(-2, 2, (b, a, 3)) * node_mask[..., None]).astype(np.float32),
            node_mask=node_mask, graph_mask=graph_mask,
            energy=np.where(graph_mask, rng.normal(size=b), 0.0).astype(np.float32),
            forces=(rng.normal(size=(b, a, 3)) * node_mask[..., None]).astype(np.float32),
            mol_id=np.arange(b, dtype=np.int32) + b * k))
    return out


def tb(arrays) -> MolBatch:
    return MolBatch(**{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})


def painn(use_pallas: str = "fused"):
    return create_model("painn", device="cpu", use_pallas=use_pallas,
                        generator=seeded_generator(0), **PAINN_KW)


def _numpy(named):
    return {n: t.detach().numpy().copy() for n, t in named}


def pipeline_cfg(tmp: Path, db: Path, job: str, tag: str, **extra) -> dict:
    """A train / test / predict job of the narrow PaiNN over `db` (batch 5,
    so a batch splits 3 / 2), its files under `tmp` named by `tag`."""
    cfg = {
        "name": "painn-dp", "job_type": job, "seed": 42,
        "model": {"name": "painn", "kwargs": dict(PAINN_KW), **LOSSES},
        "trainer": dict(TRAIN, max_epochs=2, log_every_n_steps=1, schedule="plateau"),
        "datamodule": {"kind": "energy", "source": str(db), "batch_size": 5,
                       "val_fraction": 0.25, "bucket_boundaries": [8, 12]},
        "ckpt_dir": str(tmp / f"ckpt_{tag}"), "output_dir": str(tmp / f"out_{tag}"),
        "output_db": str(tmp / f"pred_{tag}.db"),
    }
    cfg.update(extra)
    return cfg


# ---------------------------------------------------------------------------
# scenarios: each returns host data (numpy, numbers, strings)
# ---------------------------------------------------------------------------


def losses_scenario(tmp: Path, db: Path) -> dict:
    """(1) multitask_loss of this rank's share, every case and layout: the
    values and the gradients with respect to the rank's predictions."""
    out = {}
    for layout in LOSS_LAYOUTS:
        arrays, preds = loss_arrays(layout)
        sl = dist.shard_rows(len(arrays["mol_id"]))
        batch = dist.shard_batch(tb(arrays))
        for case, (specs, coefs, max_errors) in LOSS_CASES.items():
            pred = {k: torch.from_numpy(v[sl].copy()).requires_grad_(True)
                    for k, v in preds.items()}
            losses = multitask_loss(pred, batch, specs, coefs, max_errors=max_errors)
            losses["total"].backward()
            out[layout, case] = dict(values={k: float(v.detach()) for k, v in losses.items()},
                                     grads={k: v.grad.numpy() for k, v in pred.items()
                                            if v.grad is not None})
    return out


def train_scenario(tmp: Path, db: Path) -> dict:
    """(2) the first step's gradients, then three train steps of the narrow
    PaiNN through A-D's plain versions (force_grads "pallas"); (3) validate
    and test on the same batches."""
    batches = [tb(b) for b in train_batches()]
    trainer = Trainer(painn(), "cpu", TrainerConfig(n_dp=dist.world_size(), force_grads="pallas",
                                                    **TRAIN))
    trainer._step_grads(dist.shard_batch(batches[0]))
    grads = {n: p.grad.numpy().copy() for n, p in trainer.model.named_parameters()}
    metrics = [{k: float(v) for k, v in trainer._train_step(dist.shard_batch(b)).items()}
               for b in batches]
    return dict(grads=grads, metrics=metrics,
                params=_numpy(trainer.model.named_parameters()),
                val=trainer.validate(batches), test=trainer.test(batches))


def predict_scenario(tmp: Path, db: Path) -> dict:
    """(4) the predict job: rank 0 writes every row."""
    tag = f"rank{dist.rank()}" if dist.world_size() > 1 else "single"
    cfg = pipeline_cfg(tmp, db, "predict", tag)
    res = pipelines.run(cfg, device="cpu")
    return dict(res=res, db=cfg["output_db"], wrote=Path(cfg["output_db"]).exists())


def checkpoint_scenario(tmp: Path, db: Path) -> dict:
    """(5) a train job (two epochs) with each rank's files in its own
    directories, then one more epoch resumed from rank 0's last checkpoint."""
    tag = f"rank{dist.rank()}" if dist.world_size() > 1 else "single"
    cfg = pipeline_cfg(tmp, db, "train", tag)
    res = pipelines.run(cfg, device="cpu")
    first = tmp / ("ckpt_rank0" if dist.world_size() > 1 else "ckpt_single") / "last.ckpt"
    more = dict(cfg["trainer"], max_epochs=1)
    resumed = pipelines.run(pipeline_cfg(tmp, db, "train", f"resume_{tag}", ckpt_path=str(first),
                                         trainer=more), device="cpu")
    files = {d: sorted(str(p.relative_to(tmp)) for p in (tmp / d).rglob("*") if p.is_file())
             for d in (f"ckpt_{tag}", f"out_{tag}", f"ckpt_resume_{tag}")}
    return dict(res=res, resumed=resumed, files=files)


def gemnet_scenario(tmp: Path, db: Path) -> dict:
    """(6) GemNet-OC's scale fit on two whole global batches."""
    model = create_model("gemnet_oc", device="cpu", generator=torch.Generator().manual_seed(0),
                         **GEMNET_KW)
    trainer = Trainer(model, "cpu", TrainerConfig(scale_fit_batches=2, **LOSSES))
    trainer._fit_scales([tb(b) for b in train_batches(seed=1)])
    return {n: float(s.detach()) for n, s in model.scale_factors().items()}


def refusal_scenario(tmp: Path, db: Path) -> dict:
    """(7) n_dp that is not the world size; (8) the optimize job in a world
    of two."""
    out = {}
    try:
        Trainer(painn("off"), "cpu", TrainerConfig(n_dp=3))
    except ValueError as e:
        out["n_dp"] = str(e)
    try:
        pipelines.run({"job_type": "optimize", "datamodule": {"source": str(db)},
                       "model": {"name": "painn", "kwargs": PAINN_KW}}, device="cpu")
    except NotImplementedError as e:
        out["optimize"] = str(e)
    return out


SCENARIOS = {"losses": losses_scenario, "train": train_scenario, "predict": predict_scenario,
             "checkpoints": checkpoint_scenario, "gemnet": gemnet_scenario,
             "refusals": refusal_scenario}


def rank_main(r: int, world: int, store: str, out_dir: str, db: str) -> None:
    """One rank: the gloo group over `store`, every scenario in order (the
    first failure ends the run: the other rank's collectives then time
    out), its results pickled to `<out_dir>/rank<r>.pkl`."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"file://{store}", rank=r,
                                         world_size=world,
                                         timeout=datetime.timedelta(seconds=60))
    results = {}
    try:
        for name, fn in SCENARIOS.items():
            try:
                results[name] = fn(Path(out_dir), Path(db))
            except Exception:  # recorded: each test reads its own scenario
                results[name] = {"error": traceback.format_exc()}
                break
    finally:
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
            pickle.dump(results, f)
        torch.distributed.destroy_process_group()
