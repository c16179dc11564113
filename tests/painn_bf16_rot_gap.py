"""PaiNN in bf16 on trained weights: how far one rotation moves E, in the
JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python -m tests.painn_bf16_rot_gap [--batch 16] [--steps 10] [--mols 8]

Trains configs/painn-oc.yaml's PaiNN (full width: 128 channels, 6
interactions, 100 RBF) in float32 with the port's own trainer on the CPU,
over chip_smoke.py's seeded DB (256 molecules of 8-62 atoms) and its train
recipe (chip_smoke.train_config: AdamW 1e-4, clip 10, the plateau rate),
for --steps steps of --batch molecules (the card's train phase: 2 epochs of
5 steps at batch 64; the CPU keeps the double backward's memory down with a
smaller batch). Its best checkpoint's weights then go, as one flax tree
(`convert.flax_params_of`), into:

* JAX's PaiNN in bf16 jitted as written (each op rounds its bf16 result,
  `exact_jit`), and in float32;
* the port's plain PaiNN in bf16 and in float32.

Over the first --mols molecules of each bucket's first predict batch, each
run's E and F on the batch and on the batch turned by `chip_smoke.rotation()`:
|E(R x) - E(x)| over max |E(x)| and |F(R x) - R F(x)| over max |F(x)|
(chip_smoke.py's `_rel_err`), with each bf16 run's gap against its float32
run and the port's bf16 run's against JAX's. Prints one JSON line. This is
the witness for chip_smoke.py's BF16_TRAINED_ROT_TOL and
BF16_TRAINED_E_VS_F32: if JAX's bf16 PaiNN moves E as far as the port's,
the gap is the bf16 model's. Not a test (not collected).
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import jax
import numpy as np
import torch

from nabladft_tpu.data.batch import MolBatch as JaxMolBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models.base import forward as jax_forward
from nabladft_tpu_torch import pipelines
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.data.synthetic import write_random_db
from nabladft_tpu_torch.models import create_model, forward
from nabladft_tpu_torch.models.convert import flax_params_of, load_flax_params
from nabladft_tpu_torch.train.checkpoints import load_state
from tests.test_torch_painn_bf16 import exact_jit

REPO = Path(__file__).resolve().parent.parent
FIELDS = ("z", "pos", "node_mask", "graph_mask", "energy", "forces", "mol_id")
KEYS = ("energy", "forces")


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def train(cs, tmp: Path, batch: int, steps: int) -> tuple:
    """(config, trained float32 model on the CPU, the best checkpoint's step)."""
    db = write_random_db(tmp / "witness.db", cs.N_MOLS, cs.MIN_ATOMS, cs.MAX_ATOMS, cs.SEED)
    cfg = cs.train_config(str(db), str(tmp), str(tmp / "ckpt"), str(tmp / "outputs"))
    cfg["datamodule"] = dict(cfg["datamodule"], batch_size=batch)
    cfg["trainer"] = dict(cfg["trainer"], max_steps=steps, log_every_n_steps=1)
    pipelines.run(cfg, device="cpu")
    best = json.loads((tmp / "ckpt" / "index.json").read_text())["best"][0]
    model = pipelines.build_model(cfg, torch.device("cpu"))
    model.load_state_dict(load_state(tmp / "ckpt" / best["path"], "cpu")["model"])
    return cfg, model.eval(), int(best["step"])


def first_batches(cfg: dict, mols: int) -> dict:
    """{A: the first --mols molecules of the bucket's first predict batch}."""
    dm = pipelines.build_datamodule(cfg)
    out = {}
    for b in dm.predict_dataloader():
        a = b.z.shape[1]
        if a not in out:
            out[a] = {k: getattr(b, k).numpy()[:mols] for k in FIELDS}
    return dict(sorted(out.items()))


def rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--mols", type=int, default=8)
    args = ap.parse_args()
    cs = _chip_smoke()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg, port32, best_step = train(cs, Path(tmp), args.batch, args.steps)
        batches = first_batches(cfg, args.mols)
    params = flax_params_of(port32)
    kw = cfg["model"]["kwargs"]
    port16 = load_flax_params(create_model("painn", device="cpu",
                                           compute_dtype="bfloat16", **kw),
                              params).eval()
    rot = cs.rotation()
    jax_models = {dt: jax_create_model("painn", compute_dtype=dt, remat=False, **kw)
                  for dt in ("float32", "bfloat16")}
    rows = []
    for a, fields in batches.items():
        turned = dict(fields, pos=(fields["pos"] @ rot.T).astype(np.float32))
        out = {}
        for name, f in (("x", fields), ("rx", turned)):
            jb = JaxMolBatch(**f)
            for dt, jm in jax_models.items():
                o = exact_jit(lambda p, b, _m=jm: jax_forward(_m, p, b), params, jb)
                out[f"jax_{dt}_{name}"] = {k: np.asarray(o[k], np.float32) for k in KEYS}
            tb = MolBatch(**{k: torch.from_numpy(v) for k, v in f.items()})
            for dt, model in (("float32", port32), ("bfloat16", port16)):
                o = forward(model, tb)
                out[f"port_{dt}_{name}"] = {k: o[k].float().numpy() for k in KEYS}
        mask = fields["graph_mask"]
        row = {"atoms": a, "molecules": int(mask.sum())}
        for key, tag in (("energy", "E"), ("forces", "F")):
            def gap(run, ref, turn=False):
                want = out[ref][key] @ rot.T if turn else out[ref][key]
                return rel(out[run][key][mask], want[mask])
            for prog in ("jax", "port"):
                for dt in ("float32", "bfloat16"):
                    row[f"{prog}_{dt}_rotation_{tag}"] = gap(f"{prog}_{dt}_rx", f"{prog}_{dt}_x",
                                                             turn=key == "forces")
                row[f"{prog}_bfloat16_vs_float32_{tag}"] = gap(f"{prog}_bfloat16_x",
                                                               f"{prog}_float32_x")
            row[f"port_vs_jax_bfloat16_{tag}"] = gap("port_bfloat16_x", "jax_bfloat16_x")
        rows.append(row)
    print(json.dumps({"model_kwargs": kw, "train": {"batch": args.batch, "steps": args.steps,
                                                    "best_step": best_step},
                      "relative_to_max_abs": rows, "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
