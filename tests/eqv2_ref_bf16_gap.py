"""EquiformerV2's reference variant: its bf16-vs-float32 gap at the
configured widths, in the JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python -m tests.eqv2_ref_bf16_gap [--layers 4] [--mols 4]

The reference-compatible variant (m_share_rad False, 600 Gaussians: the
published checkpoints') at configs/model/equiformer_v2.yaml's widths, depth
cut to --layers blocks, on the port's seeded weights (one flax tree for both
programs), over the first predict batch of --mols molecules of a seeded
synthetic DB (8 to --max-atoms atoms). E and F (direct) of:

* JAX's XLA path in float32 and in bf16, the bf16 program jitted as written
  (each op rounds its bf16 result, `exact_jit`) and with XLA's excess
  precision allowed (the default jit);
* the port's plain path in float32 and in bf16.

Prints one JSON line: each bf16 run's largest |E| and |F| error against its
own float32 run, over that run's max |E| / max |F| (chip_smoke.py's
`_rel_err`), and the port's bf16 distance from JAX's (`exact_jit`). This is
the witness for chip_smoke.py's EQV2_REF_BF16_E_VS_F32: the port's gap there
is the program's own, JAX's too. Not a test (not collected).
"""

import argparse
import json
import tempfile
import time
from pathlib import Path

import jax
import numpy as np
import torch

from nabladft_tpu.data.batch import MolBatch as JaxMolBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models.base import forward as jax_forward
from nabladft_tpu_torch.data import DataModule, EnergyDataset
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.data.synthetic import write_random_db
from nabladft_tpu_torch.models import create_model, forward
from nabladft_tpu_torch.models.convert import flax_params_of, load_flax_params
from tests.test_torch_painn_bf16 import exact_jit

# configs/model/equiformer_v2.yaml's kwargs and chip_smoke.py's EQV2_REF_KW
WIDTHS = dict(sphere_channels=128, attn_alpha_channels=64, num_heads=8, attn_value_channels=16,
              ffn_hidden_channels=128, l_max=6, m_max=2, cutoff=12.0, max_neighbors=30)
REF_KW = dict(m_share_rad=False, num_distance_basis=600, attn_hidden_channels=64)
FIELDS = ("z", "pos", "node_mask", "graph_mask", "energy", "forces", "mol_id")


def first_batch(root: Path, mols: int, max_atoms: int, seed: int) -> dict:
    db = write_random_db(root / "gap.db", n_mols=mols, min_atoms=8, max_atoms=max_atoms,
                         seed=seed)
    dm = DataModule(EnergyDataset(str(db), bucket_boundaries=(max_atoms,)), batch_size=mols,
                    val_fraction=0.0, seed=seed)
    batch = next(iter(dm.predict_dataloader()))
    return {k: getattr(batch, k).numpy() for k in FIELDS}


def rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--mols", type=int, default=4)
    ap.add_argument("--max-atoms", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    kw = dict(WIDTHS, **REF_KW, num_layers=args.layers)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        fields = first_batch(Path(tmp), args.mols, args.max_atoms, args.seed)
    port32 = create_model("equiformer_v2", device="cpu",
                          generator=torch.Generator().manual_seed(args.seed), **kw).eval()
    params = flax_params_of(port32)
    jb = JaxMolBatch(**fields)
    out = {}
    for dt in ("float32", "bfloat16"):
        jm = jax_create_model("equiformer_v2", use_pallas=False, remat=False, compute_dtype=dt,
                              **kw)
        runs = {"exact": exact_jit(lambda p, b, _m=jm: jax_forward(_m, p, b), params, jb)}
        if dt == "bfloat16":
            runs["default_jit"] = jax.jit(lambda p, b, _m=jm: jax_forward(_m, p, b))(params, jb)
        for name, o in runs.items():
            out[f"jax_{dt}_{name}"] = {k: np.asarray(o[k], np.float32)
                                       for k in ("energy", "forces")}
    batch = MolBatch(**{k: torch.from_numpy(v) for k, v in fields.items()})
    port16 = load_flax_params(create_model("equiformer_v2", device="cpu",
                                           compute_dtype="bfloat16", **kw), params).eval()
    with torch.no_grad():
        for dt, model in (("float32", port32), ("bfloat16", port16)):
            o = forward(model, batch)
            out[f"port_{dt}"] = {k: o[k].float().numpy() for k in ("energy", "forces")}
    mask = fields["graph_mask"]
    gaps = {}
    for run, ref in (("jax_bfloat16_exact", "jax_float32_exact"),
                     ("jax_bfloat16_default_jit", "jax_float32_exact"),
                     ("port_bfloat16", "port_float32"), ("port_bfloat16", "jax_bfloat16_exact"),
                     ("port_float32", "jax_float32_exact")):
        gaps[f"{run}_vs_{ref}"] = {
            "energy": rel(out[run]["energy"][mask], out[ref]["energy"][mask]),
            "forces": rel(out[run]["forces"][mask], out[ref]["forces"][mask])}
    print(json.dumps({"model_kwargs": kw, "molecules": int(mask.sum()),
                      "atoms": [int(n) for n in fields["node_mask"].sum(1)],
                      "relative_to_max_abs": gaps,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
