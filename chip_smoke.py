#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: kernels, predict, train, test.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the repository
checkout; no network and no PyYAML. Phases, each printing one JSON line:

  1. env     — device, torch / CUDA / nvcc versions, the card's name and
               power limit; builds csrc/painn_fused.cu, csrc/schnet_fused.cu,
               csrc/qhnet_tp.cu, csrc/escn_layer.cu and csrc/eqv2_attn.cu (one
               nvcc each, started together) and prints each kernel's registers
               and spills.
  2. kernel_A…kernel_H — PaiNN's A (painn_fwd), B (painn_bwd, with and
               without the weight gradient), C (painn_dual_fwd), D
               (painn_dual_bwd, with the weight gradient) and SchNet's E
               (schnet_fwd), F (schnet_bwd, with and without the weight
               gradient), G (schnet_dual_fwd), H (schnet_dual_bwd, with it) at
               each of the predict and train paths' shapes (B=64, A=32/48/64,
               R=100, F=128, fp32; padded atoms and ~30 % of pairs masked; for
               E-H rbf unmasked and the cosine cutoff zero off the edges, as the
               model builds them), one line per kernel and shape: error
               against the plain PyTorch version, and the kernel's, the plain
               version's and the bound's times (CUDA events, median / min /
               max of 25 runs after warm-up); B and F (each with and without
               gW), D and H, A and C, and E and G, are run twice and must give
               the same bits. A-D run their radial products, E-H their
               filter-MLP products, on the tensor cores over the live pairs:
               their lines carry each launched kernel's device ms
               (`stages_ms`). Every line carries the live pairs and `bound_ms`
               with the products at the 3xTF32 rate beside `bound_fma_ms`, as
               I-P's. kernel_I…kernel_L: QHNet's I (qhnet_conv_fwd),
               J (qhnet_conv_bwd), K (qhnet_pair_fwd), L (qhnet_pair_bwd) at the
               QHNet train path's shapes (B=8, A=32/48/64, C=128, LMAX 4, gate
               hiddens 32/32 for the conv and 8/128 for the pair; a/2..a real
               atoms, cgsh from the 12 Bohr radius graph, maskf the full
               graph), the same lines; each runs twice for the same bits and
               its line carries each launched kernel's device ms (`stages_ms`).
               Their bounds count the live pairs (cgsh row or maskf not zero;
               the lines print the count): `bound_ms` with the gate products at
               the 3xTF32 tensor-core rate (as M-P, `tc_bound`), `bound_fma_ms`
               all at the fp32 FMA rate.
  3. predict — for each family, `pipelines.run` of ``job_type: predict`` on
               configs/painn-oc.yaml, then configs/schnet.yaml, at full width
               and depth (hidden 128, 6 interactions, 100 RBF), batch 64,
               buckets 32/48/64, over one seeded DB of 256 molecules (8-62
               atoms, H C N O F S Cl); checks rows, finiteness, launch counts
               (the forward and backward kernel 6x per batch, the backward's
               weight-gradient stage never), every batch against the CPU
               plain path, rotation invariance / equivariance; molecules/s
               (median / min / max of 7 passes after a warm-up pass); for
               PaiNN the share of live pairs (rbf_env row not zero) of the
               batches by bucket.
     profile — torch.profiler over two predict steps: device time by
               kernel and the device's busy share (printed before predict);
               PaiNN's must show the engine's products and A's and B's
               stages, SchNet's E's and F's.
  4. train   — for each family, `pipelines.run` of ``job_type: train``
               (TRAIN_EPOCHS epochs, force_grads "pallas") on the same DB,
               then ``job_type: test`` from the best checkpoint; checks launch
               counts (the dual kernels 6x per train step; the forward and
               backward kernels 6x per train step, validation batch and test
               batch; the backward's weight-gradient stage never; the other
               family's kernels never), finite losses, gradient norms and
               test metrics, the checkpoint files; the parameter gradients of
               one batch per bucket against the plain module's double
               backward on the card (force_grads "direct"); molecules/s of
               the train steps of the last epoch (median / min / max), seconds
               per epoch, peak device memory; for PaiNN the live-pair share of
               an epoch's train batches by bucket.
     train_profile — torch.profiler over two train steps (printed before
               train); PaiNN's must show A-D's engine products, their
               stages and D's gW on the engine's weight-gradient product;
               SchNet's the same of E-H (H's gW there).
     painn_optimize — after PaiNN's train phase: `pipelines.run` of
               ``job_type: optimize`` on configs/painn-oc_optim.yaml (full
               width, batch 32, fmax 0.05, memory 100, maxstep 0.2, no line
               search, steps capped at OPT_STEPS) from that phase's best
               checkpoint over the DB's first OPT_MOLS molecules; checks the
               rows (input key-value pairs and data kept; finite positions,
               energies and forces) and launches (A and B 6 x the
               evaluations, Σ over batches of iterations + 1; B's gW stage and
               C-P never); per bucket OPT_CHECK_ITERS iterations of the first
               batch fused and plain on the card (after each iteration E and F
               within the model tolerances of the plain module at the fused
               positions; the two runs' positions within OPT_POS_ATOL after
               OPT_POS_ITERS iterations, and their gap after each iteration
               printed) and its first iteration against the CPU plain path
               (positions within OPT_POS_ATOL, E and F as above); one batch
               MT_STEPS steps with the "mt" line search (the reference's c1
               0.23, c2 0.46): every lane finite, A and B once an evaluation;
               molecules/s, batch-iterations/s, the converged share, total
               steps, the mean energy drop and the share of molecules
               lowered, peak memory; torch.profiler over two iterations with
               a full history ring: the device's busy share, the top kernels
               and the two-loop recursion's host ms.
  SchNet's lines carry the prefix ``schnet_`` (schnet_predict, ...).
  5. qhnet_train — `pipelines.run` of ``job_type: train`` on configs/qhnet.yaml
               at full width (hidden 128, bottle 32, 5 layers, 32 RBF, batch 8,
               atom buckets 32/48/64, orbital buckets 256/384/512/640, EMA
               0.99) over a seeded Hamiltonian DB of 96 molecules (8-62 atoms,
               half H, def2-SVP), TRAIN_EPOCHS epochs, then ``job_type: test``
               from the best checkpoint; checks the I-L launch counts (remat:
               I 10, J 5, K 4, L 2 per train step; I 5, K 2 per validation and
               test batch; no A-H), finite losses and metrics, the checkpoint
               files; per atom bucket, the kernel path's parameter gradients and
               H against the plain module on the card and H's covariance under
               a rotation; molecules/s, seconds per epoch, peak device memory.
     qhnet_train_profile — torch.profiler over two train steps; the gate
               products of I-L must show there as the SO(2) engine's kernels
               (so2_mma_kernel two launches per I-L launch, so2_mmw_kernel)
               and the bodies they replaced must not.
  6. kernel_M, kernel_N — eSCN's M (escn_fwd) and N (escn_bwd) at the eSCN
               paths' shapes (B=64, A=32/48/64), configs/escn-oc.yaml widths
               (l_max 6, m_max 2, C 128, H 256, EC 128), on eSCN-built inputs
               (d from the 8 Å / 40-neighbour graph, xe from a seeded
               EdgeBlock), the same lines with the live pairs counted; the
               plain versions run ESCN_PLAIN_MOLS molecules at a time; N twice
               for the same bits.
     escn_predict — `job_type: predict` on configs/escn-oc.yaml at full width
               and depth (8 layers), batch 64, over the seeded DB: M 8 times
               per batch, N never; per bucket the first batch, and the same
               batch rotated, against the plain module on the card, its first
               molecules against the CPU plain path, E and F within
               ESCN_OUT_RTOL x their largest magnitude; E invariant under the
               rotation, F's equivariance error printed; molecules/s.
     escn_profile — torch.profiler over two predict steps.
     escn_train — `job_type: train` (TRAIN_EPOCHS epochs) then `test`: M 8
               per train step, validation and test batch, N 8 per train step;
               finite metrics; per bucket the fused parameter gradients against
               the plain module's on the card, and both against the plain
               module in float64 (printed);
               molecules/s, s/epoch, memory.
     escn_train_profile — torch.profiler over two train steps.
  7. kernel_O, kernel_P — EquiformerV2's O (eqv2_fwd) and P (eqv2_bwd) at the
               EquiformerV2 paths' shapes (B=64, A=32/48/64),
               configs/equiformer_v2.yaml widths (l_max 6, m_max 2, C 128, 8
               heads x 16 value and 64 alpha channels, 3 x 128 edge channels),
               on EquiformerV2-built inputs (idx, d and xe from the 12 Å /
               30-neighbour graph of a seeded one-block model), the same lines
               with the live edges counted; O with dropk ones and a seeded keep
               mask, P every cotangent and twice for the same bits; the plain
               versions run EQV2_PLAIN_MOLS molecules at a time.
     eqv2_predict — `job_type: predict` on configs/equiformer_v2.yaml at full
               width and depth (12 layers), batch 64: O 13 times per batch (12
               blocks and the force block), P never, no dropout drawn; per
               bucket the first batch, and the same batch rotated, against the
               plain module on the card, its first molecule against the CPU
               plain path, E and F within EQV2_OUT_RTOL x their largest
               magnitude; E under the rotation within EQV2_E_ROT x max |E| (the
               model's own grid aliasing), F's equivariance error printed;
               molecules/s (EQV2_PASSES passes).
     eqv2_profile — torch.profiler over two predict steps.
     eqv2_train — `job_type: train` then `test`: O 13 per train step,
               validation and test batch, P 13 per train step, dropout drawn
               13 + 24 times per train step and never in evaluation; finite
               metrics; per bucket, dropout off, the fused parameter gradients
               against the plain module's on the card and both against float64
               (printed); molecules/s, s/epoch, memory.
     eqv2_train_profile — torch.profiler over two train steps.
  8. timing  — seconds of each phase; then one JSON object describing every
               ported kernel (A-P) with its launches on each path.
Then the card's `nvidia-smi` name and power limit, and last the ok line.
Any failed check raises: the script exits nonzero and prints no ok line.
Exits nonzero without a CUDA device.
"""

from __future__ import annotations

import itertools
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
N_MOLS, MIN_ATOMS, MAX_ATOMS = 256, 8, 62
BATCH, BUCKETS = 64, (32, 48, 64)
TRAIN_EPOCHS = 2
# the optimize job (configs/painn-oc_optim.yaml: batch 32, fmax 0.05, memory
# 100, maxstep 0.2) over the seeded DB's first OPT_MOLS molecules, its steps
# capped at OPT_STEPS (results/optimize_benchmark.json's cap); fused against
# plain over OPT_CHECK_ITERS iterations of one batch per bucket; "mt" over
# MT_STEPS steps with the reference's c1 / c2
OPT_MOLS, OPT_STEPS, OPT_CHECK_ITERS, MT_STEPS, MT_C1, MT_C2 = 64, 100, 5, 10, 0.23, 0.46
# Å, the fused and plain runs' positions after OPT_POS_ITERS iterations: the
# runs part as L-BFGS amplifies the forces' rounding (3-5x an iteration at
# painn-oc width; on the H100 at A=32 <= 7.8e-6 Å after 3, 5.3e-5-7.1e-5
# after 5), so the positions
# are held where that growth leaves the limit a wide margin; the kernels
# are held by E and F at the same positions after every iteration
OPT_POS_ATOL, OPT_POS_ITERS = 1e-4, 3
# QHNet (configs/qhnet.yaml): batch 8, atom buckets as above, orbital buckets;
# a seeded Hamiltonian DB of QH_MOLS molecules
QH_BATCH, QH_ORB_BUCKETS, QH_MOLS = 8, (256, 384, 512, 640), 96
QH_C, QH_CONV_H, QH_PAIR_H = 128, (32, 32), (8, 128)
# QHNet kernel path vs the plain module on the card: parameter gradients
# within QH_GRAD_RTOL x max |g| per tensor, H within QH_H_RTOL x max |H|
# (fp32 sums over 65 paths and 5 layers in another order); a rotated batch's
# H against T(R) H T(R)^T within QH_COV_RTOL x max |H|
QH_GRAD_RTOL, QH_H_RTOL, QH_COV_RTOL = 1e-3, 1e-4, 1e-3
# eSCN (configs/escn-oc.yaml) at full width and depth, the datamodule's batch
ESCN_KW = dict(num_layers=8, l_max=6, m_max=2, sphere_channels=128, hidden=256,
               edge_channels=128, cutoff=8.0, max_neighbors=40, num_sphere_samples=128)
# EquiformerV2 (configs/equiformer_v2.yaml) at full width and depth
EQV2_KW = dict(num_layers=12, sphere_channels=128, attn_alpha_channels=64, num_heads=8,
               attn_value_channels=16, ffn_hidden_channels=128, l_max=6, m_max=2, cutoff=12.0,
               max_neighbors=30)
# kernel phase shapes: every (B, A) the predict and train paths give the
# kernels (each batch is padded to B=64 molecules of its bucket's A atoms);
# the kernels line's times are those at A=HEADLINE_A
KB, KR, KF, HEADLINE_A = BATCH, 100, 128, 48
SCHNET_RC = 5.0  # configs/model/schnet.yaml cutoff (Å)
RUNS, WARMUP = 25, 3
PASSES = 7  # timed passes of the predict loop, after one warm-up pass
# Kernel vs plain version, both fp32 on the card with sums in another
# order: max |err| <= KERNEL_RTOL * max |plain| per output.
KERNEL_RTOL = 2e-5
# GPU fused path vs the CPU plain path, and rotated vs unrotated inputs:
# the model-level tolerances of the CPU parity tests.
E_TOL = dict(rtol=2e-4, atol=1e-5)
F_TOL = dict(rtol=2e-3, atol=2e-4)
# kernel path (surrogate through A-D or E-H) vs the plain module's double backward,
# per parameter tensor: max |Δg| <= GRAD_RTOL * max |g_plain| (the CPU
# parity tests' surrogate tolerance, tests/train/test_surrogate_grads.py)
GRAD_RTOL = 5e-3

# Published dense peaks (NVIDIA data sheets, full power limit): fp32 FLOP/s
# outside the tensor cores, memory bytes/s, and TF32 FLOP/s on the tensor
# cores (dense: half the sheets' figures with sparsity).
PEAKS = {
    "H100 PCIe": (51e12, 2.0e12, 378e12),
    "H100 NVL": (60e12, 3.9e12, 417.5e12),
    "H100": (67e12, 3.35e12, 494.5e12),  # SXM5 (e.g. "NVIDIA H100 80GB HBM3")
    "H200": (67e12, 4.8e12, 494.5e12),
}
# the SO(2) product engine of M-P runs 3xTF32: three TF32 products per
# fp32-accurate product
TC_PASSES = 3


def smoke_config(source: str, output_db: str, root: str, config: str = "painn-oc") -> dict:
    """configs/<config>.yaml composed with job_type=predict,
    datamodule.source/root and output_db (the test suite checks this equals
    `load_config` of the file with those overrides; no PyYAML here)."""
    return dict(CONFIGS[config](source, root), job_type="predict", output_db=output_db)


def train_config(source: str, root: str, ckpt_dir: str, output_dir: str,
                 config: str = "painn-oc") -> dict:
    """configs/<config>.yaml composed with job_type=train, datamodule.source/
    root, ckpt_dir, output_dir, trainer.max_epochs=TRAIN_EPOCHS and
    trainer.log_every_n_steps=1 (a CSV row per step; checked against
    `load_config` by the test suite as smoke_config is)."""
    cfg = dict(CONFIGS[config](source, root), job_type="train", ckpt_dir=ckpt_dir,
               output_dir=output_dir)
    cfg["trainer"] = dict(cfg["trainer"], max_epochs=TRAIN_EPOCHS, log_every_n_steps=1)
    return cfg


def optimize_config(source: str, root: str, ckpt_path: str, output_db: str) -> dict:
    """configs/painn-oc_optim.yaml composed with datamodule.source/root,
    ckpt_path, output_db, optimize.steps=OPT_STEPS and
    optimize.line_search=off (checked against `load_config` by the test
    suite)."""
    return {
        "name": "painn-oc-optim", "job_type": "optimize", "seed": 42,
        "datamodule": {"kind": "energy", "source": source, "root": root},
        "optimize": {"batch_size": 32, "fmax": 0.05, "steps": OPT_STEPS, "memory": 100,
                     "maxstep": 0.2, "energy_unit": "Hartree", "position_unit": "Ang",
                     "line_search": "off"},
        "output_db": output_db,
        "model": _painn_oc(source, root)["model"],
        "ckpt_path": ckpt_path,
    }


def _composed(name: str, model: dict, source: str, root: str) -> dict:
    """A top-level config over the default trainer and energy datamodule groups."""
    return {
        "name": name,
        "seed": 42,
        "dataset_name": "dataset_train_tiny",
        "ckpt_dir": f"checkpoints/{name}",
        "output_dir": "outputs",
        "model": model,
        "trainer": {
            "max_epochs": 100, "optimizer": "adamw", "lr": 0.0001, "weight_decay": 0.0,
            "grad_clip": 10.0, "schedule": "plateau", "plateau_factor": 0.8,
            "plateau_patience": 10, "plateau_min_lr": 1e-06, "log_every_n_steps": 50,
            "save_top_k": 3, "monitor": "val/loss", "early_stopping_patience": 50, "seed": 42,
        },
        "datamodule": {"kind": "energy", "source": source, "root": root, "batch_size": BATCH,
                       "val_fraction": 0.1, "bucket_boundaries": list(BUCKETS)},
    }


def _painn_oc(source: str, root: str) -> dict:
    return _composed("painn-oc", {
        "name": "painn",
        "kwargs": {"hidden": 128, "n_interactions": 6, "n_rbf": 100, "cutoff": 5.0,
                   "max_neighbors": 63, "rbf": "gaussian", "envelope": "polynomial",
                   "envelope_exponent": 5},
        "loss_specs": {"energy": "l1", "forces": "l2norm"},
        "loss_coefs": {"energy": 1.0, "forces": 1.0},
    }, source, root)


def _schnet(source: str, root: str) -> dict:
    return _composed("schnet", {
        "name": "schnet",
        "kwargs": {"hidden": 128, "n_interactions": 6, "n_rbf": 100, "cutoff": 5.0,
                   "max_neighbors": 63},
        "loss_specs": {"energy": "mse", "forces": "mse"},
        "loss_coefs": {"energy": 1.0, "forces": 1.0},
    }, source, root)


def _qhnet(source: str, root: str) -> dict:
    """configs/qhnet.yaml: model/qhnet, trainer/default, datamodule/hamiltonian."""
    cfg = _composed("qhnet", {
        "name": "qhnet",
        "kwargs": {"hidden": 128, "bottle_hidden": 32, "num_layers": 5, "radius_cutoff": 12.0,
                   "rbf_dim": 32},
        "loss_specs": {"hamiltonian": "rmse_mae"},
        "loss_coefs": {"hamiltonian": 1.0},
        "trainer_overrides": {"ema_decay": 0.99},
    }, source, root)
    cfg["job_type"] = "train"
    cfg["datamodule"] = {"kind": "hamiltonian", "source": source, "root": root,
                         "batch_size": QH_BATCH, "val_fraction": 0.05,
                         "atom_boundaries": list(BUCKETS),
                         "orbital_boundaries": list(QH_ORB_BUCKETS)}
    return cfg


def _escn_oc(source: str, root: str) -> dict:
    """configs/escn-oc.yaml: model/escn-oc, trainer/default, datamodule/energy."""
    return _composed("escn-oc", {
        "name": "escn", "kwargs": dict(ESCN_KW),
        "loss_specs": {"energy": "l1", "forces": "l2norm"},
        "loss_coefs": {"energy": 1.0, "forces": 100.0},
    }, source, root)


def _eqv2(source: str, root: str) -> dict:
    """configs/equiformer_v2.yaml: model/equiformer_v2, trainer/default, datamodule/energy."""
    return _composed("equiformer_v2", {
        "name": "equiformer_v2", "kwargs": dict(EQV2_KW),
        "loss_specs": {"energy": "l1", "forces": "l2norm"},
        "loss_coefs": {"energy": 1.0, "forces": 100.0},
    }, source, root)


CONFIGS = {"painn-oc": _painn_oc, "schnet": _schnet, "qhnet": _qhnet, "escn-oc": _escn_oc,
           "equiformer_v2": _eqv2}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> dict:
    """{kernel: {"registers": n, "static_smem_bytes": n, "spill": "..."}} from
    nvcc -Xptxas -v output (a template kernel's name carries its integer and
    bool arguments, as name<7,0> or name<true>; dynamic shared memory is the
    launch's)."""
    out, name = {}, None
    for line in log.splitlines():
        # <file>_cu_<hash><len><name>, then I L{i,b}<n> E ... E for template arguments
        m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?_kernel)((?:IL[ib]\d+E(?:L[ib]\d+E)*E)?)", line)
        if m and ("entry function" in line or "properties for" in line):
            name = m.group(1)
            if m.group(2):
                args = re.findall(r"L([ib])(\d+)E", m.group(2))
                name += "<" + ",".join(("false", "true")[int(v)] if k == "b" else v
                                       for k, v in args) + ">"
            out.setdefault(name, {})
        elif name and "spill stores" in line:
            out[name]["spill"] = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", line):
                out[name]["static_smem_bytes"] = int(m.group(1))
    return out


def peaks(name: str, tensor_cores: bool = False):
    """(fp32 FLOP/s, bytes/s) of the card, and its TF32 FLOP/s with
    `tensor_cores`."""
    for key, val in PEAKS.items():
        if key in name:
            return val if tensor_cores else val[:2]
    raise RuntimeError(f"no published fp32 / memory peak recorded for {name!r}")


def time_ms(fn) -> dict:
    """CUDA-event times of `fn` (ms): median, min, max over RUNS after WARMUP."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(RUNS)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    t = sorted(s.elapsed_time(e) for s, e in ev)
    return {"median": t[RUNS // 2], "min": t[0], "max": t[-1]}


def compare(got, ref) -> dict:
    """Max abs error and error relative to the output's largest magnitude."""
    errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    scale = [float(r.abs().max()) for r in ref]
    return {"max_abs_err": max(errs), "max_rel_err": max(e / max(s, 1e-30)
                                                         for e, s in zip(errs, scale)),
            "per_output_abs_err": errs, "per_output_max_abs": scale}


def _max_abs(t) -> float:
    return float(t.abs().max())


def _grad_errs(model, ref) -> dict:
    """{tensor: max |g - g_ref| / max |g_ref|} over the parameter tensors."""
    return {n: _max_abs(p.grad.double() - q.grad.double()) / max(_max_abs(q.grad), 1e-30)
            for (n, p), (_, q) in zip(model.named_parameters(), ref.named_parameters())}


def kernel_inputs(dev, a: int):
    """Seeded inputs at one of the predict path's kernel shapes (B=KB, A=a);
    the radial chain is a Gaussian basis of random distances, ~30% of pairs
    masked to zero."""
    g = torch.Generator().manual_seed(SEED + a)

    def mk(*shape):
        return torch.randn(*shape, generator=g) * 0.3

    dist = mk(KB, a, a).abs() * 5 + 0.8
    mask = (torch.rand(KB, a, a, generator=g) > 0.3).float()
    mu = torch.linspace(0.0, 5.0, KR)
    rbf = torch.exp(-((dist[..., None] - mu) ** 2) / 0.05) * mask[..., None]
    rbfp = (-2.0 / 0.05) * (dist[..., None] - mu) * rbf
    cpu = dict(rbf=rbf, rbfp=rbfp, phi=mk(KB, a, 3 * KF), v=mk(KB, a, 3 * KF),
               unit_t=mk(KB, a, 3, a), w=mk(KR, 3 * KF), gds=mk(KB, a, KF),
               gdv=mk(KB, a, 3 * KF))
    # the tangent lanes of the dual kernels: rbfd = rbfp * (a distance
    # tangent), as the model builds it
    cpu.update(rbfd=rbfp * mk(KB, a, a)[..., None], phid=mk(KB, a, 3 * KF),
               vd=mk(KB, a, 3 * KF), unitd_t=mk(KB, a, 3, a), gdsd=mk(KB, a, KF),
               gdvd=mk(KB, a, 3 * KF))
    return {k: t.to(dev).contiguous() for k, t in cpu.items()}


C_ARGS = ("rbf", "rbfd", "phi", "phid", "v", "vd", "unit_t", "unitd_t", "w")
D_ARGS = C_ARGS + ("gds", "gdv", "gdsd", "gdvd")


def bound(flops: int, nbytes: int, peak_flops: float, peak_bw: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _kernel_row(shape, err, t_k, t_p, flops, nbytes, peak_flops, peak_bw, **extra) -> dict:
    """One kernel line: errors, kernel / plain / bound times (medians), the
    work counted and the bound's share of the kernel's time."""
    b_ms, b_by = bound(flops, nbytes, peak_flops, peak_bw)
    return dict(shape=shape, **err, ms=t_k["median"], plain_ms=t_p["median"], bound_ms=b_ms,
                bound_by=b_by, flops=flops, bytes=nbytes, roofline_share=b_ms / t_k["median"],
                **extra)


def tc_bound(work: dict, peak_flops: float, peak_bw: float, peak_tf32: float):
    """The least time of an SO(2) kernel's work (M-P) with its products on the
    tensor cores at the fp32-accurate 3xTF32 rate and the rest at the fp32
    rate, or its bytes at the memory rate: (ms, "operations" or "bytes")."""
    t_ops = (work["flops_live_products"] / (peak_tf32 / TC_PASSES)
             + work["flops_live_other"] / peak_flops) * 1e3
    t_bytes = work["bytes"] / peak_bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _so2_row(shape, err, t_k, t_p, work, card: str, **extra) -> dict:
    """An I-P kernel line: `bound_ms` the tensor-core bound (the least time
    for the same fp32-accurate work), `bound_fma_ms` the fp32 FMA one (the
    bound of A-H), each with its share of the kernel's time."""
    peak_flops, peak_bw, peak_tf32 = peaks(card, tensor_cores=True)
    row = _kernel_row(shape, err, t_k, t_p, work["flops_live"], work["bytes"], peak_flops,
                      peak_bw, **extra)
    b_tc, by_tc = tc_bound(work, peak_flops, peak_bw, peak_tf32)
    row.update(bound_fma_ms=row["bound_ms"], bound_fma_by=row["bound_by"],
               roofline_share_fma=row["roofline_share"], bound_ms=b_tc, bound_by=by_tc,
               roofline_share=b_tc / t_k["median"], flops_products=work["flops_live_products"],
               flops_other=work["flops_live_other"])
    return row


def _same_bits(fn, args, got, what: str) -> None:
    again = fn(*args)
    check(all((p is None and q is None) or torch.equal(p, q) for p, q in zip(got, again)),
          f"{what} gives the same bits on a rerun")


def kernel_bucket(pf, dev, a: int, card: str):
    """Kernels A-D at (KB, a, KR, KF) against their plain versions: errors
    (checked), and kernel / plain / bound times. B is checked and timed both
    with the weight gradient and without it, as the predict path runs it.
    A-D run their radial products on the tensor cores over the live pairs:
    each runs twice for the same bits (B with and without gW) and their
    lines carry each launched kernel's device ms (`stages_ms`). Every line
    carries the live pairs and `bound_ms` with the radial products at the
    3xTF32 rate beside `bound_fma_ms` (`_so2_row`)."""
    x = kernel_inputs(dev, a)
    a_args = [x[k] for k in ("rbf", "phi", "v", "unit_t", "w")]
    b_args = [x[k] for k in ("rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv")]
    shape = [KB, a, KR, KF]

    got = pf.painn_fwd(*a_args)
    err = compare(got, pf.painn_message_reference(*a_args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel A error at {shape}: {err}")
    _same_bits(pf.painn_fwd, a_args, got, f"kernel A at {shape}")
    del got
    stages = stage_times(pf.painn_fwd, a_args)
    t_k = time_ms(lambda: pf.painn_fwd(*a_args))
    t_p = time_ms(lambda: pf.painn_message_reference(*a_args))
    work = pf.fwd_work("A", x["rbf"], x["rbf"], KF)
    row_a = _so2_row(shape, err, t_k, t_p, work, card, live_pairs=work["live_pairs"],
                     pairs=work["pairs"], bit_identical_rerun=True, stages_ms=stages)
    emit("kernel_A", **row_a, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p)

    got = pf.painn_bwd(*b_args)
    err = compare(got, pf.painn_message_bwd_reference(*b_args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel B error at {shape}: {err}")
    _same_bits(pf.painn_bwd, b_args, got, f"kernel B at {shape}")
    got_ng = pf.painn_bwd(*b_args, need_gw=False)
    check(got_ng[4] is None and all(torch.equal(p, q) for p, q in zip(got_ng[:4], got[:4])),
          "kernel B without gW gives the same node and pair cotangents")
    _same_bits(lambda *t: pf.painn_bwd(*t, need_gw=False), b_args, got_ng,
               f"kernel B without gW at {shape}")
    err_ng = compare(got_ng[:4], pf.painn_message_bwd_reference(*b_args, need_gw=False)[:4])
    check(err_ng["max_rel_err"] <= KERNEL_RTOL, f"kernel B (no gW) error at {shape}: {err_ng}")
    del got, got_ng
    stages = stage_times(pf.painn_bwd, b_args)
    stages_ng = stage_times(lambda *t: pf.painn_bwd(*t, need_gw=False), b_args)
    work = pf.bwd_work("B", x["rbf"], x["rbfp"], KF)
    work_ng = pf.bwd_work("B", x["rbf"], x["rbfp"], KF, need_gw=False)
    t_k = time_ms(lambda: pf.painn_bwd(*b_args))
    t_p = time_ms(lambda: pf.painn_message_bwd_reference(*b_args))
    t_k_ng = time_ms(lambda: pf.painn_bwd(*b_args, need_gw=False))
    t_p_ng = time_ms(lambda: pf.painn_message_bwd_reference(*b_args, need_gw=False))
    row_ng = _so2_row(shape, err_ng, t_k_ng, t_p_ng, work_ng, card)
    row_b = _so2_row(shape, err, t_k, t_p, work, card, live_pairs=work["live_pairs"],
                     pairs=work["pairs"], bit_identical_rerun=True, stages_ms=stages,
                     max_abs_err_without_gw=err_ng["max_abs_err"],
                     ms_without_gw=t_k_ng["median"], plain_ms_without_gw=t_p_ng["median"],
                     bound_ms_without_gw=row_ng["bound_ms"],
                     bound_by_without_gw=row_ng["bound_by"],
                     bound_fma_ms_without_gw=row_ng["bound_fma_ms"],
                     flops_without_gw=work_ng["flops_live"],
                     roofline_share_without_gw=row_ng["roofline_share"],
                     stages_ms_without_gw=stages_ng)
    emit("kernel_B", **row_b, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p,
         kernel_times_without_gw=t_k_ng, plain_times_without_gw=t_p_ng)

    c_args = [x[k] for k in C_ARGS]
    got = pf.painn_dual_fwd(*c_args)
    err = compare(got, pf.painn_dual_fwd_reference(*c_args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel C error at {shape}: {err}")
    _same_bits(pf.painn_dual_fwd, c_args, got, f"kernel C at {shape}")
    del got
    stages = stage_times(pf.painn_dual_fwd, c_args)
    t_k = time_ms(lambda: pf.painn_dual_fwd(*c_args))
    t_p = time_ms(lambda: pf.painn_dual_fwd_reference(*c_args))
    work = pf.fwd_work("C", x["rbf"], x["rbfd"], KF)
    row_c = _so2_row(shape, err, t_k, t_p, work, card, live_pairs=work["live_pairs"],
                     pairs=work["pairs"], bit_identical_rerun=True, stages_ms=stages)
    emit("kernel_C", **row_c, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p)

    d_args = [x[k] for k in D_ARGS]
    got = pf.painn_dual_bwd(*d_args)
    err = compare(got, pf.painn_dual_bwd_reference(*d_args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel D error at {shape}: {err}")
    _same_bits(pf.painn_dual_bwd, d_args, got, f"kernel D at {shape}")
    del got
    stages = stage_times(pf.painn_dual_bwd, d_args)
    work = pf.bwd_work("D", x["rbf"], x["rbfd"], KF)
    t_k = time_ms(lambda: pf.painn_dual_bwd(*d_args))
    t_p = time_ms(lambda: pf.painn_dual_bwd_reference(*d_args))
    row_d = _so2_row(shape, err, t_k, t_p, work, card, live_pairs=work["live_pairs"],
                     pairs=work["pairs"], bit_identical_rerun=True, stages_ms=stages)
    emit("kernel_D", **row_d, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p)
    return {"A": row_a, "B": row_b, "C": row_c, "D": row_d}


KERNELS = {  # key: (name, JAX kernel body line in nabladft_tpu/ops/pallas/painn_fused.py)
    "A": ("painn_fwd (A)", 114), "B": ("painn_bwd (B)", 177),
    "C": ("painn_dual_fwd (C)", 286), "D": ("painn_dual_bwd (D)", 372),
}


def kernel_phases(dev, card: str, ptxas: dict) -> dict:
    """Kernels A-D at every bucket shape of the predict and train paths. The
    kernels line's numbers are those at A=HEADLINE_A, except max_abs_err,
    the largest over all buckets; `per_bucket` holds each bucket's. Every
    row carries the source's registers and spills (ptxas)."""
    from nabladft_tpu_torch.ops import painn_fused as pf

    per = {k: [] for k in KERNELS}
    for a in BUCKETS:
        for k, row in kernel_bucket(pf, dev, a, card).items():
            per[k].append(row)
        torch.cuda.empty_cache()
    rows = headline_rows(per, KERNELS, "painn_fused", ("B",))
    for k in "ABCD":
        rows[k]["ptxas"] = ptxas.get("painn_fused", {})
    return rows


def headline_rows(per: dict, kernels: dict, source: str, with_gw_split: tuple) -> dict:
    """The kernels line's row of each kernel: numbers at A=HEADLINE_A, except
    max_abs_err, the largest over all buckets; `per_bucket` holds each
    bucket's. `with_gw_split` kernels also carry their without-gW times."""
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "flops", "bytes", "roofline_share")
    tc = ("bound_fma_ms", "bound_fma_by", "roofline_share_fma", "flops_products", "flops_other")
    keep_gw = ("ms_without_gw", "plain_ms_without_gw", "bound_ms_without_gw",
               "roofline_share_without_gw")
    rows = {}
    for k, (name, line) in kernels.items():
        head = next(r for r in per[k] if r["shape"][1] == HEADLINE_A)
        extra = (keep_gw if k in with_gw_split else ()) + (tc if "bound_fma_ms" in head else ())
        extra += ("bound_fma_ms_without_gw",) if "bound_fma_ms_without_gw" in head else ()
        extra += ("live_pairs", "pairs") if "live_pairs" in head else ()
        rows[k] = dict(
            name=name, route="cuda", source=f"nabladft_tpu_torch/csrc/{source}.cu",
            replaces=f"nabladft_tpu/ops/pallas/{source}.py:{line}",
            max_abs_err=max(r["max_abs_err"] for r in per[k]), library_ms=None,
            timed_shape=head["shape"],
            **{f: head[f] for f in keep + extra},
            per_bucket=[{f: r[f] for f in ("shape", "max_abs_err", "max_rel_err") + keep + extra}
                        for r in per[k]],
        )
    return rows


SCHNET_KERNELS = {  # key: (name, JAX kernel body line in nabladft_tpu/ops/pallas/schnet_fused.py)
    "E": ("schnet_fwd (E)", 76), "F": ("schnet_bwd (F)", 89),
    "G": ("schnet_dual_fwd (G)", 127), "H": ("schnet_dual_bwd (H)", 154),
}
E_ARGS = ("rbf", "envf", "xin", "w1", "b1", "w2", "b2")
F_ARGS = ("rbf", "rbfp", "envf", "envp", "xin", "w1", "b1", "w2", "b2", "gmsg")
G_ARGS = ("rbf", "rbfd", "envf", "envfd", "xin", "xind", "w1", "b1", "w2", "b2")
H_ARGS = G_ARGS + ("gmsg", "gmsgd")


def schnet_kernel_inputs(dev, a: int):
    """Seeded inputs of kernels E-H at one of SchNet's kernel shapes (B=KB,
    A=a), built as the model builds them: each molecule has a/2..a real atoms
    (the rest padding), pairs are live within the 5 Å cutoff minus ~30 %
    more masked; rbf is a Gaussian basis NOT masked, envf / envp the cosine
    cutoff and its derivative, zero off the live pairs; the tangent lanes
    rbfd = rbfp ⊙ ṫ and envfd = envp ⊙ ṫ."""
    from nabladft_tpu_torch.ops import radial

    g = torch.Generator().manual_seed(SEED + 1000 + a)

    def mk(*shape):
        return torch.randn(*shape, generator=g) * 0.3

    n_atoms = torch.randint(a // 2, a + 1, (KB,), generator=g)
    real = torch.arange(a)[None] < n_atoms[:, None]
    dist = mk(KB, a, a).abs() * 8 + 0.8
    live = ((torch.rand(KB, a, a, generator=g) > 0.3) & real[:, :, None] & real[:, None, :]
            & ~torch.eye(a, dtype=torch.bool) & (dist < SCHNET_RC))
    ones, zero = torch.ones_like(dist), torch.zeros_like(dist)
    rbfp = radial.gaussian_rbf_jvp(dist, ones, KR, SCHNET_RC)
    envp = torch.where(live, radial.cosine_cutoff_jvp(dist, ones, SCHNET_RC), zero)
    dt = mk(KB, a, a) * live
    cpu = dict(rbf=radial.gaussian_rbf(dist, KR, SCHNET_RC), rbfp=rbfp,
               envf=torch.where(live, radial.cosine_cutoff(dist, SCHNET_RC), zero), envp=envp,
               rbfd=rbfp * dt[..., None], envfd=envp * dt, xin=mk(KB, a, KF), xind=mk(KB, a, KF),
               w1=torch.randn(KR, KF, generator=g) / KR ** 0.5, b1=mk(1, KF),
               w2=torch.randn(KF, KF, generator=g) / KF ** 0.5, b2=mk(1, KF),
               gmsg=mk(KB, a, KF), gmsgd=mk(KB, a, KF))
    return {k: t.to(dev).contiguous() for k, t in cpu.items()}


def schnet_kernel_bucket(sf, dev, a: int, card: str):
    """Kernels E-H at (KB, a, KR, KF) against their plain versions: errors
    (checked), and kernel / plain / bound times. F is checked and timed with
    the weight gradient and without it (as the predict and force paths run
    it); H with it (as training runs it). E-H run their filter-MLP products
    on the tensor cores over the live pairs: each runs twice for the same
    bits (F with and without gW) and their lines carry each launched
    kernel's device ms (`stages_ms`). Every line carries the live pairs and
    `bound_ms` with the filter-MLP products at the 3xTF32 rate beside
    `bound_fma_ms` (`_so2_row`)."""
    x = schnet_kernel_inputs(dev, a)
    shape = [KB, a, KR, KF]
    rows = {}

    def emit_row(key, row, t_k, t_p, **more):
        row["dynamic_smem_bytes"] = sf.smem_bytes(key, a, KR, KF)
        emit(f"kernel_{key}", **row, tolerance_rel=KERNEL_RTOL, kernel_times=t_k,
             plain_times=t_p, **more)
        rows[key] = row

    def live(work):
        return dict(live_pairs=work["live_pairs"], pairs=work["pairs"])

    args = [x[k] for k in E_ARGS]
    got = (sf.schnet_fwd(*args),)
    err = compare(got, [sf.schnet_message_reference(*args)])
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel E error at {shape}: {err}")
    _same_bits(lambda *t: (sf.schnet_fwd(*t),), args, got, f"kernel E at {shape}")
    del got
    stages = stage_times(sf.schnet_fwd, args)
    t_k = time_ms(lambda: sf.schnet_fwd(*args))
    t_p = time_ms(lambda: sf.schnet_message_reference(*args))
    work = sf.fwd_work("E", x["rbf"], x["envf"], x["envf"], KF)
    emit_row("E", _so2_row(shape, err, t_k, t_p, work, card, **live(work),
                           bit_identical_rerun=True, stages_ms=stages), t_k, t_p)

    args = [x[k] for k in F_ARGS]
    got = sf.schnet_bwd(*args)
    err = compare(got, sf.schnet_message_bwd_reference(*args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel F error at {shape}: {err}")
    _same_bits(sf.schnet_bwd, args, got, f"kernel F at {shape}")
    got_ng = sf.schnet_bwd(*args, need_gw=False)
    check(got_ng[2:] == (None,) * 4 and all(torch.equal(p, q) for p, q in zip(got_ng[:2], got)),
          "kernel F without gW gives the same node and pair cotangents")
    _same_bits(lambda *t: sf.schnet_bwd(*t, need_gw=False), args, got_ng,
               f"kernel F without gW at {shape}")
    err_ng = compare(got_ng[:2], sf.schnet_message_bwd_reference(*args, need_gw=False)[:2])
    check(err_ng["max_rel_err"] <= KERNEL_RTOL, f"kernel F (no gW) error at {shape}: {err_ng}")
    del got, got_ng
    stages = stage_times(sf.schnet_bwd, args)
    stages_ng = stage_times(lambda *t: sf.schnet_bwd(*t, need_gw=False), args)
    work = sf.bwd_work("F", x["rbf"], x["envf"], x["envp"], KF)
    work_ng = sf.bwd_work("F", x["rbf"], x["envf"], x["envp"], KF, need_gw=False)
    t_k = time_ms(lambda: sf.schnet_bwd(*args))
    t_p = time_ms(lambda: sf.schnet_message_bwd_reference(*args))
    t_k_ng = time_ms(lambda: sf.schnet_bwd(*args, need_gw=False))
    t_p_ng = time_ms(lambda: sf.schnet_message_bwd_reference(*args, need_gw=False))
    row_ng = _so2_row(shape, err_ng, t_k_ng, t_p_ng, work_ng, card)
    emit_row("F", _so2_row(
        shape, err, t_k, t_p, work, card, **live(work), bit_identical_rerun=True,
        stages_ms=stages, max_abs_err_without_gw=err_ng["max_abs_err"],
        ms_without_gw=t_k_ng["median"], plain_ms_without_gw=t_p_ng["median"],
        bound_ms_without_gw=row_ng["bound_ms"], bound_by_without_gw=row_ng["bound_by"],
        bound_fma_ms_without_gw=row_ng["bound_fma_ms"], flops_without_gw=work_ng["flops_live"],
        roofline_share_without_gw=row_ng["roofline_share"], stages_ms_without_gw=stages_ng),
        t_k, t_p, kernel_times_without_gw=t_k_ng, plain_times_without_gw=t_p_ng)

    args = [x[k] for k in G_ARGS]
    got = sf.schnet_dual_fwd(*args)
    err = compare(got, sf.schnet_dual_fwd_reference(*args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel G error at {shape}: {err}")
    _same_bits(sf.schnet_dual_fwd, args, got, f"kernel G at {shape}")
    del got
    stages = stage_times(sf.schnet_dual_fwd, args)
    t_k = time_ms(lambda: sf.schnet_dual_fwd(*args))
    t_p = time_ms(lambda: sf.schnet_dual_fwd_reference(*args))
    work = sf.fwd_work("G", x["rbf"], x["envf"], x["envfd"], KF)
    emit_row("G", _so2_row(shape, err, t_k, t_p, work, card, **live(work),
                           bit_identical_rerun=True, stages_ms=stages), t_k, t_p)

    args = [x[k] for k in H_ARGS]
    got = sf.schnet_dual_bwd(*args)
    err = compare(got, sf.schnet_dual_bwd_reference(*args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel H error at {shape}: {err}")
    _same_bits(sf.schnet_dual_bwd, args, got, f"kernel H at {shape}")
    no_gw = sf.schnet_dual_bwd(*args, need_gw=False)
    check(all(torch.equal(p, q) for p, q in zip(no_gw[:2], got)),
          "kernel H without gW gives the same node cotangents")
    del got, no_gw
    stages = stage_times(sf.schnet_dual_bwd, args)
    work = sf.bwd_work("H", x["rbf"], x["envf"], x["envfd"], KF)
    t_k = time_ms(lambda: sf.schnet_dual_bwd(*args))
    t_p = time_ms(lambda: sf.schnet_dual_bwd_reference(*args))
    emit_row("H", _so2_row(shape, err, t_k, t_p, work, card, **live(work),
                           bit_identical_rerun=True, stages_ms=stages), t_k, t_p)
    return rows


def schnet_kernel_phases(dev, card: str, ptxas: dict) -> dict:
    """Kernels E-H at every bucket shape of SchNet's predict and train paths
    (the kernels line's numbers as in kernel_phases; every row carries the
    source's registers and spills, ptxas)."""
    from nabladft_tpu_torch.ops import schnet_fused as sf

    per = {k: [] for k in SCHNET_KERNELS}
    for a in BUCKETS:
        for k, row in schnet_kernel_bucket(sf, dev, a, card).items():
            per[k].append(row)
        torch.cuda.empty_cache()
    rows = headline_rows(per, SCHNET_KERNELS, "schnet_fused", ("F",))
    for k in "EFGH":
        rows[k]["ptxas"] = ptxas.get("schnet_fused", {})
    return rows


def rotation(seed: int = 5) -> np.ndarray:
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


# the two model families chip_smoke drives: config, kernel module, launch
# counters (forward, backward, backward's gW stage, dual forward, dual
# backward) and the prefix of their phase names
FAMILIES = {
    "painn": dict(config="painn-oc", ops="painn_fused", prefix="",
                  counters=("painn_fwd", "painn_bwd", "painn_bwd_gw", "painn_dual_fwd",
                            "painn_dual_bwd"),
                  # A-D's products on the engine and their stages; D's gW on the
                  # engine's weight-gradient product (train steps only)
                  predict_present=("so2_mma_kernel", "painn_fwd_stage_kernel",
                                   "painn_bwd_stage_kernel"),
                  train_present=("so2_mma_kernel", "painn_fwd_stage_kernel",
                                 "painn_bwd_stage_kernel", "painn_dual_fwd_stage_kernel",
                                 "painn_dual_bwd_stage_kernel", "so2_mmw_kernel")),
    "schnet": dict(config="schnet", ops="schnet_fused", prefix="schnet_",
                   counters=("schnet_fwd", "schnet_bwd", "schnet_bwd_gw", "schnet_dual_fwd",
                             "schnet_dual_bwd"),
                   # E-H's products on the engine and their stages; H's gW on the
                   # engine's weight-gradient product (train steps only)
                   predict_present=("so2_mma_kernel", "schnet_fwd_stage_kernel",
                                    "schnet_bwd_stage_kernel"),
                   train_present=("so2_mma_kernel", "schnet_fwd_stage_kernel",
                                  "schnet_bwd_stage_kernel", "schnet_dual_fwd_stage_kernel",
                                  "schnet_dual_bwd_stage_kernel", "so2_mmw_kernel")),
}


def live_pair_share(model, batches) -> dict:
    """{A: live pairs, pairs, share} over PaiNN batches by bucket: the pairs
    whose rbf_env row is not zero, those kernels A and B work on."""
    out = {}
    with torch.no_grad():
        for batch in batches:
            rbf = model.features(batch.to("cuda"))["rbf_env"]
            b, a = rbf.shape[:2]
            d = out.setdefault(a, {"live_pairs": 0, "pairs": 0})
            d["live_pairs"] += int((rbf != 0).any(-1).sum())
            d["pairs"] += b * a * a
    for d in out.values():
        d["share"] = d["live_pairs"] / d["pairs"]
    return dict(sorted(out.items()))


def reset_all_launches() -> None:
    from nabladft_tpu_torch.ops import eqv2_attn, escn_layer, painn_fused, qhnet_tp, schnet_fused

    painn_fused.reset_launches()
    schnet_fused.reset_launches()
    qhnet_tp.reset_launches()
    escn_layer.reset_launches()
    eqv2_attn.reset_launches()


def all_launches() -> dict:
    from nabladft_tpu_torch.ops import eqv2_attn, escn_layer, painn_fused, qhnet_tp, schnet_fused

    return {**painn_fused.LAUNCHES, **schnet_fused.LAUNCHES, **qhnet_tp.LAUNCHES,
            **escn_layer.LAUNCHES, **eqv2_attn.LAUNCHES}


def predict_phase(tmp: Path, db: Path, family: str) -> dict:
    """`job_type: predict` of one family over the seeded DB (see the module
    docstring); returns the launch counts of the run."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data.ase_codec import AseDatabase
    from nabladft_tpu_torch.models.base import forward
    from nabladft_tpu_torch.train import Trainer

    fam = FAMILIES[family]
    fwd, bwd, bwd_gw = fam["counters"][:3]
    cfg = smoke_config(str(db), str(tmp / f"predictions_{family}.db"), str(tmp),
                       config=fam["config"])

    # the main path: counts reset just before, read just after
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    res = pipelines.run(cfg)
    torch.cuda.synchronize()
    launches = all_launches()
    peak_mem = torch.cuda.max_memory_allocated()

    n_batches = res["batches"]
    n_layers = cfg["model"]["kwargs"]["n_interactions"]
    check(res["rows"] == N_MOLS, f"rows written {res['rows']} != {N_MOLS}")
    for k in (fwd, bwd):
        check(launches[k] == n_layers * n_batches,
              f"{k} launched {launches[k]} times, expected {n_layers} x {n_batches} batches")
    check(launches[bwd_gw] == 0, f"{bwd_gw} launched {launches[bwd_gw]} times on predict")
    out_rows = list(AseDatabase(cfg["output_db"]).select_all())
    check(len(out_rows) == N_MOLS, "output DB row count")
    for rec in out_rows:
        e, f = np.asarray(rec.data["energy_pred"]), np.asarray(rec.data["forces_pred"])
        check(e.shape == (1,) and f.shape == (rec.natoms, 3), "prediction shapes")
        check(bool(np.isfinite(e).all() and np.isfinite(f).all()), "finite predictions")

    # the kernels were checked at every shape the main path gave them
    dm = pipelines.build_datamodule(cfg)
    shapes = sorted({tuple(b.z.shape) for b in dm.predict_dataloader()})
    check(all(s in [(KB, a) for a in BUCKETS] for s in shapes),
          f"predict batch shapes {shapes} outside the kernel phase's {BUCKETS}")

    # every batch against the CPU plain path with the same seeded weights
    cpu = Trainer(pipelines.build_model(cfg, torch.device("cpu")), "cpu")
    check(cpu.model.use_pallas == "off", "CPU reference runs the plain message")
    ref = list(cpu.predict(dm.predict_dataloader()))
    check(sum(len(r["energy"]) for r in ref) == N_MOLS, "CPU reference covers every molecule")
    e_ref = np.concatenate([r["energy"] for r in ref])
    e_gpu = np.array([rec.data["energy_pred"][0] for rec in out_rows])
    np.testing.assert_allclose(e_gpu, e_ref, **E_TOL)
    k, f_err = 0, 0.0
    for r in ref:
        for i, na in enumerate(r["n_atoms"]):
            f_gpu = np.asarray(out_rows[k].data["forces_pred"])
            np.testing.assert_allclose(f_gpu, r["forces"][i][:na], **F_TOL)
            f_err = max(f_err, float(np.abs(f_gpu - r["forces"][i][:na]).max()))
            k += 1
    e_err = float(np.abs(e_gpu - e_ref).max())

    # throughput of the predict loop (model on the card): one warm-up pass,
    # then PASSES timed passes over the same loader
    gpu = Trainer(pipelines.build_model(cfg, torch.device("cuda")))
    check(gpu.model.use_pallas == "fused", "the card runs the fused kernels")
    rates = []
    for p in range(PASSES + 1):
        t0 = time.perf_counter()
        n_pred = sum(len(o["energy"]) for o in gpu.predict(dm.predict_dataloader()))
        torch.cuda.synchronize()
        if p:
            rates.append(n_pred / (time.perf_counter() - t0))
    rates.sort()

    # rotation: E invariant, F co-rotates
    batch = next(iter(dm.predict_dataloader())).to("cuda")
    rot = torch.from_numpy(rotation()).cuda()
    out = forward(gpu.model, batch)
    out_r = forward(gpu.model, batch.replace(pos=batch.pos @ rot.T))
    np.testing.assert_allclose(out_r["energy"].cpu().numpy(), out["energy"].cpu().numpy(),
                               **E_TOL)
    np.testing.assert_allclose(out_r["forces"].cpu().numpy(),
                               (out["forces"] @ rot.T).cpu().numpy(), **F_TOL)

    profile_phase(fam["prefix"] + "profile", gpu, dm, present=fam["predict_present"])
    live = live_pair_share(gpu.model, dm.predict_dataloader()) if family == "painn" else None
    emit(fam["prefix"] + "predict", config=fam["config"], rows=res["rows"], batches=n_batches,
         live_pairs_by_bucket=live,
         batch_shapes=shapes, launches=launches, run_seconds=res["seconds"],
         cpu_ref_molecules=len(e_ref), cpu_ref_max_energy_abs_err=e_err,
         cpu_ref_max_force_abs_err=f_err,
         molecules_per_second={"median": rates[PASSES // 2], "min": rates[0],
                               "max": rates[-1], "passes": rates},
         peak_device_memory_bytes=peak_mem, rotation_ok=True,
         tolerances={"energy": E_TOL, "forces": F_TOL})
    return launches


def profile_phase(phase: str, trainer, dm, n_batches: int = 2, top: int = 12,
                  present=()) -> None:
    """torch.profiler over `n_batches` predict steps (bucket 32): device time
    by kernel, and the device's busy share of the wall time; each name in
    `present` must be part of some kernel's name."""
    batches = list(itertools.islice(dm.predict_dataloader(), n_batches))
    profile_steps(phase, trainer._predict_step, batches, top, present=present)


def profile_steps(phase: str, step, batches, top: int = 12, present=(), absent=(),
                  calls=None) -> None:
    """torch.profiler over `step` on each batch: device time by kernel, and
    the device's busy share of the wall time. Each name in `present` must be
    part of some kernel's name, and none in `absent` of any; `calls()`, read
    after the steps, gives {name: launches} that the kernels whose names
    hold `name` must add up to."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            step(batch.to("cuda"))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: a CPU op's self device time repeats its kernels'
    events = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(t for _, t, _ in events)
    events.sort(key=lambda e: -e[1])
    for name in present:
        check(any(name in k for k, _, _ in events), f"{phase}: no kernel named {name}")
    for name in absent:
        check(not any(name in k for k, _, _ in events), f"{phase}: a kernel named {name}")
    want = calls() if calls else {}
    got = {name: sum(c for k, _, c in events if name in k) for name in want}
    check(got == want, f"{phase}: launches {got}, expected {want}")
    emit(phase, batches=len(batches), batch_shapes=[list(b.z.shape) for b in batches],
         wall_ms=wall_us / 1e3, device_ms=device_us / 1e3,
         device_busy_share=device_us / wall_us,
         top=[{"name": k[:80], "device_ms": t / 1e3, "share": t / max(device_us, 1e-9),
               "calls": c} for k, t, c in events[:top]],
         present=list(present), absent=list(absent), calls=got)


def read_csv(path: Path) -> list:
    import csv

    with open(path) as f:
        return [{k: float(v) for k, v in row.items() if v != ""} for row in csv.DictReader(f)]


def train_phase(tmp: Path, db: Path, family: str) -> dict:
    """The train and test jobs of one family, then the gradient check and a
    profile of two train steps; returns the launch counts of the run."""
    from nabladft_tpu_torch import pipelines

    fam = FAMILIES[family]
    fwd, bwd, bwd_gw, dual_fwd, dual_bwd = fam["counters"]
    ckpt, outputs = tmp / f"ckpt_{family}", tmp / f"outputs_{family}"
    cfg = train_config(str(db), str(tmp), str(ckpt), str(outputs), config=fam["config"])
    dm = pipelines.build_datamodule(cfg)
    n_train, n_val, n_test = (len(dm.train_dataloader()), len(dm.val_dataloader()),
                              len(dm.test_dataloader()))

    # the main path: counts reset just before, read just after
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.time()
    res = pipelines.run(cfg)
    best = json.loads((ckpt / "index.json").read_text())["best"][0]["path"]
    test = pipelines.run(dict(cfg, job_type="test", ckpt_path=str(ckpt / best)))
    torch.cuda.synchronize()
    launches = all_launches()
    peak_mem = torch.cuda.max_memory_allocated()

    steps, n_layers = res["step"], cfg["model"]["kwargs"]["n_interactions"]
    check(steps == TRAIN_EPOCHS * n_train,
          f"{steps} train steps, expected {TRAIN_EPOCHS} x {n_train}")
    want = dict.fromkeys(launches, 0)  # the other family's kernels: none
    want.update({dual_fwd: n_layers * steps, dual_bwd: n_layers * steps,
                 fwd: n_layers * (steps + TRAIN_EPOCHS * n_val + n_test),
                 bwd: n_layers * (steps + TRAIN_EPOCHS * n_val + n_test), bwd_gw: 0})
    check(launches == want, f"train/test launches {launches}, expected {want}")
    check((ckpt / "last.ckpt").exists() and (ckpt / best).exists(), "checkpoint files")
    rows = read_csv(outputs / cfg["name"] / "metrics.csv")
    step_rows = [r for r in rows if "train/total" in r]
    val_rows = [r for r in rows if "val/loss" in r]
    check(len(step_rows) == steps and len(val_rows) == TRAIN_EPOCHS, "a CSV row per step and epoch")
    for r in step_rows:
        check(all(np.isfinite(r[k]) for k in ("train/total", "train/energy", "train/forces",
                                              "grad_norm")), f"finite train metrics {r}")
        check(r["skipped_nonfinite"] == 0.0, f"no skipped step {r}")
    for m in [res, test] + val_rows:
        check(all(np.isfinite(v) for v in m.values()), f"finite metrics {m}")
    check({"test/loss", "test/energy/mae", "test/forces/mae"} <= set(test), f"test metrics {test}")
    # train-step throughput over the last epoch (every bucket shape seen before)
    rates = sorted(r["mols_per_sec"] for r in step_rows if r["epoch"] == TRAIN_EPOCHS - 1)
    epoch_ends = [t_start] + [r["time"] for r in val_rows]
    epoch_seconds = [b - a for a, b in zip(epoch_ends, epoch_ends[1:])]

    grads = gradient_check(cfg, dm)
    trainer = pipelines.build_trainer(dict(cfg, log_csv=False, ckpt_dir=None),
                                      torch.device("cuda"))
    batches = list(itertools.islice(dm.train_dataloader(), 2))
    profile_steps(fam["prefix"] + "train_profile", trainer._train_step, batches,
                  present=fam["train_present"])
    live = (live_pair_share(trainer.model, dm.train_dataloader()) if family == "painn"
            else None)
    emit(fam["prefix"] + "train", config=fam["config"], steps=steps, batches_per_epoch=n_train,
         live_pairs_by_bucket=live,
         val_batches=n_val, test_batches=n_test,
         launches=launches, expected_launches=want, final_val=res, test=test,
         train_losses_first_last=[step_rows[0]["train/total"], step_rows[-1]["train/total"]],
         grad_norm_max=max(r["grad_norm"] for r in step_rows),
         molecules_per_second={"median": rates[len(rates) // 2], "min": rates[0],
                               "max": rates[-1], "steps": rates, "epoch": TRAIN_EPOCHS - 1},
         seconds_per_epoch=epoch_seconds, peak_device_memory_bytes=peak_mem,
         gradient_check=grads)
    return launches


def gradient_check(cfg: dict, dm) -> list:
    """For the first train batch of each bucket: the parameter gradients of
    the kernel path (force_grads "pallas": A-D or E-H) against the plain module's
    double backward (force_grads "direct") on the card, same seeded weights."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.train import Trainer, TrainerConfig

    dev = torch.device("cuda")
    t = dict(cfg["trainer"], loss_specs=cfg["model"]["loss_specs"],
             loss_coefs=cfg["model"]["loss_coefs"])
    plain_cfg = dict(cfg, model=dict(cfg["model"], kwargs=dict(cfg["model"]["kwargs"],
                                                               use_pallas="off")))
    fused = Trainer(pipelines.build_model(cfg, dev), dev,
                    TrainerConfig(**dict(t, force_grads="pallas")))
    plain = Trainer(pipelines.build_model(plain_cfg, dev), dev,
                    TrainerConfig(**dict(t, force_grads="direct")))
    check(fused.model.use_pallas == "fused" and plain.model.use_pallas == "off", "model modes")
    first = {}
    for batch in dm.train_dataloader():
        first.setdefault(batch.z.shape[1], batch)
    out = []
    for a, batch in sorted(first.items()):
        batch = batch.to(dev)
        lf, lp = fused._compute_grads(batch), plain._compute_grads(batch)
        err = _grad_errs(fused.model, plain.model)
        worst_name = max(err, key=err.get)
        worst = err[worst_name]
        check(worst <= GRAD_RTOL, f"gradient check at A={a}: {worst_name} off by {worst:.3e}")
        check(abs(float(lf["total"]) - float(lp["total"])) <= 1e-4 * abs(float(lp["total"])),
              f"loss at A={a}: {float(lf['total'])} vs {float(lp['total'])}")
        out.append({"shape": list(batch.z.shape), "max_rel_grad_err": worst,
                    "worst_param": worst_name, "loss_kernel": float(lf["total"]),
                    "loss_plain": float(lp["total"])})
    check(sorted(first) == list(BUCKETS), f"gradient check buckets {sorted(first)}")
    return out


def _opt_model(cfg: dict, dev, use_pallas: bool):
    """The optimize job's model on `dev` (`build_optimize_model`, as
    `run_optimize_job` builds it), with ``optimize.use_pallas`` set."""
    from nabladft_tpu_torch.optimize.task import build_optimize_model

    model = build_optimize_model(
        dict(cfg, optimize=dict(cfg["optimize"], use_pallas=use_pallas)), dev)
    want = "fused" if use_pallas and dev.type == "cuda" else "off"
    check(model.use_pallas == want, f"optimize model runs {model.use_pallas}, not {want}")
    return model


def optimize_phase(tmp: Path, db: Path) -> dict:
    """`job_type: optimize` of configs/painn-oc_optim.yaml from the best
    checkpoint of the PaiNN train phase over the DB's first OPT_MOLS
    molecules (see the module docstring); returns the launch counts of the
    run."""
    from torch.profiler import ProfilerActivity, profile

    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data import AseDatabase, BucketedLoader, EnergyDataset, LoaderConfig
    from nabladft_tpu_torch.optimize import BatchwiseCalculator, lbfgs_relax
    from nabladft_tpu_torch.optimize.lbfgs import init_lbfgs_state, relax_chunked

    src = tmp / "optimize_in.db"
    seeded, out = AseDatabase(db), AseDatabase(src, create=True)
    try:
        inputs = list(itertools.islice(seeded.select_all(), OPT_MOLS))
        for rec in inputs:
            out.write(rec)
    finally:
        seeded.close()
        out.close()
    ckpt = tmp / "ckpt_painn"
    best = json.loads((ckpt / "index.json").read_text())["best"][0]["path"]
    cfg = optimize_config(str(src), str(tmp), str(ckpt / best), str(tmp / "optimized.db"))

    # the main path: counts reset just before, read just after
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    stats = pipelines.run(cfg)
    torch.cuda.synchronize()
    launches = all_launches()
    peak_mem = torch.cuda.max_memory_allocated()

    n_layers = cfg["model"]["kwargs"]["n_interactions"]
    evals = stats["total_lbfgs_steps"] + stats["batches"]  # Σ_batches (nsteps + 1)
    want = dict.fromkeys(launches, 0)  # B's gW stage and C-P: none
    want.update(painn_fwd=n_layers * evals, painn_bwd=n_layers * evals)
    check(launches == want, f"optimize launches {launches}, expected {want}")
    check(stats["n_molecules"] == OPT_MOLS, f"relaxed {stats['n_molecules']} of {OPT_MOLS}")
    rows = list(AseDatabase(cfg["output_db"]).select_all())
    check(len(rows) == OPT_MOLS, "optimize output row count")
    for rec, inp in zip(rows, inputs):
        check(rec.key_value_pairs == inp.key_value_pairs, "input key-value pairs kept")
        check(set(rec.data) == set(inp.data) | {"model_energy", "model_forces"}, "data keys")
        check(all(np.array_equal(rec.data[k], inp.data[k]) for k in inp.data), "input data kept")
        check(np.array_equal(rec.numbers, inp.numbers), "atomic numbers kept")
        e, f = np.asarray(rec.data["model_energy"]), np.asarray(rec.data["model_forces"])
        check(e.shape == (1,) and f.shape == (rec.natoms, 3), "model energy / forces shapes")
        check(bool(np.isfinite(rec.positions).all() and np.isfinite(e).all()
                   and np.isfinite(f).all()), "finite relaxed rows")

    dev = torch.device("cuda")
    fused = BatchwiseCalculator(_opt_model(cfg, dev, True))
    plain = BatchwiseCalculator(_opt_model(cfg, dev, False))
    cpu = BatchwiseCalculator(_opt_model(cfg, torch.device("cpu"), False))
    o = cfg["optimize"]
    kw = dict(memory=o["memory"], maxstep=o["maxstep"])
    loader = BucketedLoader(EnergyDataset(str(src), root=str(tmp), bucket_boundaries=BUCKETS),
                            config=LoaderConfig(batch_size=o["batch_size"], shuffle=False))
    e_init, first = {}, {}
    for host in loader:
        first.setdefault(host.z.shape[1], host)
        e0, _ = fused(host.to(dev))
        for slot in np.flatnonzero(host.graph_mask.numpy()):
            e_init[int(host.mol_id[slot])] = float(e0[slot])
    check(sorted(first) == list(BUCKETS), f"optimize buckets {sorted(first)}")
    drops = np.array([e_init[inp.id] - rec.data["model_energy"][0]
                      for rec, inp in zip(rows, inputs)])

    # per bucket: OPT_CHECK_ITERS iterations fused and plain on the card,
    # and the first against the CPU plain path
    checks = []
    for a, host in sorted(first.items()):
        batch = host.to(dev)
        runs = []
        for calc in (fused, plain):
            states = []  # after 0, 1, ... iterations (pos, E and F are fresh tensors a step)
            r, _ = relax_chunked(calc, batch, fmax=o["fmax"], max_steps=OPT_CHECK_ITERS,
                                 interval=1, on_chunk=lambda it, st, ss=states: ss.append(st),
                                 **kw)
            runs.append((r, states))
        (r_f, s_f), (r_p, s_p) = runs
        check(r_f.nsteps == r_p.nsteps, f"A={a}: {r_f.nsteps} vs {r_p.nsteps} iterations")
        gaps = [_max_abs(f.pos - p.pos) for f, p in zip(s_f, s_p)]
        held = gaps[:OPT_POS_ITERS + 1]  # shorter only if every molecule converged first
        check(held[-1] <= OPT_POS_ATOL,
              f"A={a}: fused positions {held[-1]:.3e} Å off plain after {len(held) - 1} "
              "iterations")
        # E and F against the plain module at the fused positions, after
        # every iteration (the two runs' own energies also differ by |F|·|Δx|)
        e_err = f_err = 0.0
        for st in s_f:
            e_p, f_p = plain(batch.replace(pos=st.pos))
            np.testing.assert_allclose(st.energy.cpu().numpy(), e_p.cpu().numpy(), **E_TOL)
            np.testing.assert_allclose(st.forces.cpu().numpy(), f_p.cpu().numpy(), **F_TOL)
            e_err = max(e_err, _max_abs(st.energy - e_p))
            f_err = max(f_err, _max_abs(st.forces - f_p))
        r_1 = lbfgs_relax(fused, batch, fmax=o["fmax"], max_steps=1, **kw)
        r_c = lbfgs_relax(cpu, host, fmax=o["fmax"], max_steps=1, **kw)
        cpu_err = _max_abs(r_1.pos.cpu() - r_c.pos)
        check(cpu_err <= OPT_POS_ATOL, f"A={a}: first step {cpu_err:.3e} Å off the CPU")
        e_c, f_c = cpu(host.replace(pos=r_1.pos.cpu()))
        np.testing.assert_allclose(r_1.energy.cpu().numpy(), e_c.numpy(), **E_TOL)
        np.testing.assert_allclose(r_1.forces.cpu().numpy(), f_c.numpy(), **F_TOL)
        checks.append({"shape": list(host.z.shape), "iterations": r_f.nsteps,
                       "plain_pos_gap_by_iteration": gaps,
                       "plain_max_energy_err": e_err, "plain_max_force_err": f_err,
                       "plain_run_max_energy_diff": _max_abs(r_f.energy - r_p.energy),
                       "cpu_first_step_max_pos_err": cpu_err,
                       "cpu_first_step_max_energy_err": _max_abs(r_1.energy.cpu() - e_c)})

    # "mt" (the reference's c1 / c2) on the first batch: A and B once an evaluation
    n_evals = [0]

    def counted(batch):
        n_evals[0] += 1
        return fused(batch)

    batch = first[BUCKETS[0]].to(dev)
    reset_all_launches()
    r_mt = lbfgs_relax(counted, batch, fmax=o["fmax"], max_steps=MT_STEPS, line_search="mt",
                       ls_c1=MT_C1, ls_c2=MT_C2, **kw)
    torch.cuda.synchronize()
    mt_launches = {k: n for k, n in all_launches().items() if n}
    check(mt_launches == {"painn_fwd": n_layers * n_evals[0], "painn_bwd": n_layers * n_evals[0]},
          f"mt launches {mt_launches} for {n_evals[0]} evaluations")
    check(all(bool(torch.isfinite(t).all()) for t in (r_mt.pos, r_mt.energy, r_mt.forces)),
          "every mt lane finite")

    # two iterations with a full ring (the recursion over all `memory` slots)
    # under the profiler, at the largest bucket
    batch = first[BUCKETS[-1]].to(dev)
    state = init_lbfgs_state(fused, batch, 1e-6, o["memory"])._replace(iteration=o["memory"])
    _, state = relax_chunked(fused, batch, fmax=1e-6, max_steps=o["memory"] + 1, interval=1,
                             resume_state=state, **kw)  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, state = relax_chunked(fused, batch, fmax=1e-6, max_steps=state.iteration + 2,
                                 interval=2, resume_state=state, **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    # kernels only: the recursion's named range also shows on the device's
    # track, over the kernels it launched
    events = [(e.key, e.self_device_time_total, e.count) for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
              and e.key != "lbfgs.two_loop"]
    device_us = sum(t for _, t, _ in events)
    events.sort(key=lambda e: -e[1])
    two_loop = [e for e in averages if e.key == "lbfgs.two_loop"
                and e.device_type == torch.autograd.DeviceType.CPU]
    check([e.count for e in two_loop] == [2],
          f"two profiled iterations: {[(e.device_type, e.count) for e in two_loop]}")
    two_loop = two_loop[0]

    emit("painn_optimize", config="painn-oc_optim", molecules=stats["n_molecules"],
         batches=stats["batches"], ckpt=best, launches=launches, expected_launches=want,
         evaluations=evals, seconds=stats["seconds"],
         molecules_per_second=stats["n_molecules"] / stats["seconds"],
         batch_iterations_per_second=stats["total_lbfgs_steps"] / stats["seconds"],
         total_lbfgs_steps=stats["total_lbfgs_steps"], n_converged=stats["n_converged"],
         converged_fraction=stats["converged_fraction"],
         mean_energy_drop=float(drops.mean()), share_energy_lowered=float((drops > 0).mean()),
         peak_device_memory_bytes=peak_mem, fused_vs_plain=checks,
         mt={"steps": r_mt.nsteps, "evaluations": n_evals[0], "launches": mt_launches,
             "converged": int(r_mt.converged.sum())},
         profile={"shape": list(batch.z.shape), "iterations": 2, "ring_slots": o["memory"],
                  "wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
                  "device_busy_share": device_us / wall_us,
                  "two_loop_host_ms_per_iteration": two_loop.cpu_time_total / 1e3 / 2,
                  "two_loop_device_ms_per_iteration": two_loop.device_time_total / 1e3 / 2,
                  "top": [{"name": k[:80], "device_ms": t / 1e3, "calls": c}
                          for k, t, c in events[:12]]},
         tolerances={"positions_abs": OPT_POS_ATOL, "positions_after_iterations": OPT_POS_ITERS,
                     "energy": E_TOL, "forces": F_TOL})
    return launches


QHNET_KERNELS = {  # key: (name, JAX kernel body line in nabladft_tpu/ops/pallas/qhnet_tp.py)
    "I": ("qhnet_conv_fwd (I)", 200), "J": ("qhnet_conv_bwd (J)", 226),
    "K": ("qhnet_pair_fwd (K)", 414), "L": ("qhnet_pair_bwd (L)", 448),
}
QH_ARGS = {
    "I": ("x", "cgsh", "hr_c", "hs_c", "w2r_c", "b2r_c", "w2s_c", "b2s_c"),
    "K": ("x", "zi", "maskf", "hr_p", "hs_p", "w2r_p", "b2r_p", "w2s_p", "b2s_p"),
}
QH_ARGS.update(J=QH_ARGS["I"] + ("g_conv",), L=QH_ARGS["K"] + ("g_pair",))


def qhnet_kernel_inputs(dev, b: int, a: int, c: int, hc=QH_CONV_H, hp=QH_PAIR_H,
                        seed: int = SEED) -> dict:
    """Seeded inputs of kernels I-L, built as QHNet builds them: each
    molecule has a/2..a real atoms (the rest padding) at random positions
    (Bohr); cgsh = the edge SH (component-normalized, zero off the 12 Bohr
    radius graph) @ cgsh_matrix; zi = node @ cgz_matrix of the same node
    features as x; maskf the full-graph mask (no self pairs, no padding);
    gate hiddens, weights and cotangents random. Also node_mask and adj."""
    from nabladft_tpu_torch.ops import qhnet_tp as qt, so3

    g = torch.Generator().manual_seed(seed)

    def mk(*shape, scale=0.3):
        return torch.randn(*shape, generator=g) * scale

    lmax, s = qt.LMAX, qt.S
    pc = len(qt.tp_paths(lmax)) * c
    n_atoms = torch.randint(max(a // 2, 1), a + 1, (b,), generator=g)
    real = torch.arange(a)[None] < n_atoms[:, None]
    pos = mk(b, a, 3, scale=4.0)
    diff = pos[:, None] - pos[:, :, None]
    dist = diff.norm(dim=-1)
    full = real[:, :, None] & real[:, None, :] & ~torch.eye(a, dtype=torch.bool)
    adj = full & (dist < 12.0)
    unit = torch.where(full[..., None], diff / dist.clamp(min=1e-9)[..., None], 0.0)
    sh = so3.real_sph_harm(unit, lmax, normalized=False)
    cgsh = torch.where(adj[..., None], sh, 0.0) @ torch.from_numpy(qt.cgsh_matrix(lmax))
    node = mk(b, a, s, c) * real[:, :, None, None]
    zi = torch.einsum("basc,sk->bakc", node, torch.from_numpy(qt.cgz_matrix(lmax)))
    x = dict(x=node.transpose(1, 2), cgsh=cgsh, zi=zi, maskf=full.float()[..., None],
             g_conv=mk(b, a, s, c), g_pair=mk(b, a, s, a, c), node_mask=real, adj=adj)
    for tag, (h1, h2) in (("c", hc), ("p", hp)):
        x.update({f"hr_{tag}": mk(b, a, a, h1, scale=1.0), f"hs_{tag}": mk(b, a, a, h2, scale=1.0),
                  f"w2r_{tag}": mk(h1, pc, scale=h1 ** -0.5),
                  f"w2s_{tag}": mk(h2, pc, scale=h2 ** -0.5),
                  f"b2r_{tag}": mk(pc, scale=0.1), f"b2s_{tag}": mk(pc, scale=0.1)})
    return {k: t.to(dev).contiguous() for k, t in x.items()}


def escn_kernel_inputs(dev, b: int, a: int, seed: int = SEED, **kw) -> dict:
    """Seeded inputs of kernels M and N, built as eSCN builds them (widths of
    configs/escn-oc.yaml unless `kw` shrinks them): each molecule has a/2..a
    real atoms (the rest padding, z = 0) of H C N O at random positions (Å,
    ~10 Å across); d = the compact truncated Wigner values of the 8 Å /
    40-neighbour graph's edge frames, zero off the graph; xe from a seeded
    layer's EdgeBlock; that layer's weights `ws`; x and the cotangent g
    random. Also node_mask and the pair mask."""
    from nabladft_tpu_torch.models import create_model
    from nabladft_tpu_torch.ops import graph, so3
    from nabladft_tpu_torch.train import seeded_generator

    cfg = dict(ESCN_KW, num_layers=1, **kw)
    g = torch.Generator().manual_seed(seed)
    n_atoms = torch.randint(max(a // 2, 1), a + 1, (b,), generator=g)
    real = torch.arange(a)[None] < n_atoms[:, None]
    zs = torch.tensor([1, 6, 7, 8])[torch.randint(0, 4, (b, a), generator=g)] * real
    pos = torch.randn(b, a, 3, generator=g) * 2.5 * real[..., None]
    model = create_model("escn", device="cpu", generator=seeded_generator(seed), **cfg)
    layer = model.layers[0]
    nl = graph.neighbor_list(pos, real, cfg["cutoff"], cfg["max_neighbors"])
    mask_d, unit_d, dist_d = graph.dense_from_neighbor_list(nl, a)
    d = so3.wigner_trunc_compact_from_rot(so3.rot_to_z(unit_d), cfg["l_max"], cfg["m_max"])
    with torch.no_grad():
        xe = layer.edge_block(dist_d, zs[:, None, :].expand(b, a, a),
                              zs[:, :, None].expand(b, a, a))
    s, c = (cfg["l_max"] + 1) ** 2, cfg["sphere_channels"]
    x = dict(x=torch.randn(b, a, s, c, generator=g) * 0.5, d=d * mask_d[..., None], xe=xe,
             g=torch.randn(b, a, s, c, generator=g), node_mask=real, pair_mask=mask_d > 0)
    out = {k: t.to(dev).contiguous() for k, t in x.items()}
    out["ws"] = [getattr(layer, n).detach().to(dev).contiguous()
                 for n in layer.weight_names(cfg["m_max"])]
    out["dims"] = dict(l_max=cfg["l_max"], m_max=cfg["m_max"], n_grid=layer.grid_points)
    return out


def eqv2_kernel_inputs(dev, b: int, a: int, seed: int = SEED, drop: bool = True, **kw) -> dict:
    """Seeded inputs of kernels O and P, built as EquiformerV2 builds them
    (widths of configs/equiformer_v2.yaml unless `kw` shrinks them): each
    molecule has a/2..a real atoms (the rest padding, z = 0) of H C N O at
    random positions (Å, ~10 Å across); idx, d, xe and maskf from a seeded
    one-block model's `edge_inputs` over the 12 Å / 30-neighbour graph, that
    block's attention weights `ws` in the kernel's layout; x and the
    cotangent g random; dropk a seeded keep mask (p 0.1, pre-scaled by
    1/0.9) or, with drop=False, ones. Also `ones` (eval mode's dropk) and
    node_mask."""
    from nabladft_tpu_torch.models import create_model
    from nabladft_tpu_torch.train import seeded_generator

    cfg = dict(EQV2_KW, num_layers=1, **kw)
    g = torch.Generator().manual_seed(seed)
    n_atoms = torch.randint(max(a // 2, 1), a + 1, (b,), generator=g)
    real = torch.arange(a)[None] < n_atoms[:, None]
    zs = torch.tensor([1, 6, 7, 8])[torch.randint(0, 4, (b, a), generator=g)] * real
    pos = torch.randn(b, a, 3, generator=g) * 2.5 * real[..., None]
    model = create_model("equiformer_v2", device="cpu", generator=seeded_generator(seed),
                         use_pallas="fused", **cfg)
    ga = model.block_0.ga
    with torch.no_grad():
        ctx = model.edge_inputs(pos, real, zs)
        ws = [w.detach() for w in ga.kernel_weights()]
    s, c = (cfg["l_max"] + 1) ** 2, cfg["sphere_channels"]
    nh, co = cfg["num_heads"], cfg["num_heads"] * cfg["attn_value_channels"]
    keep = torch.rand(*ctx["maskf"].shape, nh, generator=g) >= 0.1
    x = dict(x=torch.randn(b, a, s, c, generator=g) * 0.5, idx=ctx["idx"], d=ctx["d"],
             xe=ctx["xe"], maskf=ctx["maskf"],
             dropk=keep.float() / 0.9 if drop else ctx["ones"], ones=ctx["ones"],
             g=torch.randn(b, a, s, co, generator=g), node_mask=real)
    out = {k: t.to(dev).contiguous() for k, t in x.items()}
    out["ws"] = [w.to(dev).contiguous() for w in ws]
    out["dims"] = ga.kernel_dims()
    return out


def stage_times(fn, args) -> dict:
    """{kernel name: device ms} of one call of `fn` (torch.profiler): where a
    kernel built of several launches spends its time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.key)[:60]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def qhnet_kernel_phases(dev, card: str, ptxas: dict) -> dict:
    """Kernels I-L at the QHNet train path's shapes (B=QH_BATCH, A in
    BUCKETS, C=128, LMAX 4, H1/H2 32/32 for the conv and 8/128 for the
    pair) against their plain versions: errors (checked), kernel / plain /
    bound times; each runs twice for the same bits, and its line carries the
    device ms of each kernel its launch runs (`stages_ms`). The bounds
    count the live pairs' work (`qt.flops_bytes`): `bound_ms` with the gate
    products at the 3xTF32 tensor-core rate, `bound_fma_ms` all at the fp32
    FMA rate.
    The kernels line's numbers as in kernel_phases; each row carries the
    source's registers, spills and shared memory (ptxas)."""
    from nabladft_tpu_torch.ops import qhnet_tp as qt

    fns = {"I": (qt.qhnet_conv_fwd, qt.conv_fwd_reference, "cgsh", "c"),
           "J": (qt.qhnet_conv_bwd, qt.conv_bwd_reference, "cgsh", "c"),
           "K": (qt.qhnet_pair_fwd, qt.pair_fwd_reference, "zi", "p"),
           "L": (qt.qhnet_pair_bwd, qt.pair_bwd_reference, "zi", "p")}
    per = {k: [] for k in QHNET_KERNELS}
    for a in BUCKETS:
        x = qhnet_kernel_inputs(dev, QH_BATCH, a, QH_C, seed=SEED + 2000 + a)
        shape = [QH_BATCH, a, QH_C]
        for k, (fn, ref, table, tag) in fns.items():
            args = [x[n] for n in QH_ARGS[k]]
            as_tuple = (lambda t: t if isinstance(t, tuple) else (t,))
            got = as_tuple(fn(*args))
            err = compare(got, as_tuple(ref(*args)))
            check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel {k} error at {shape}: {err}")
            again = as_tuple(fn(*args))
            check(all(torch.equal(p, q) for p, q in zip(got, again)),
                  f"kernel {k} deterministic at {shape}")
            extra = dict(bit_identical_rerun=True, stages_ms=stage_times(fn, args))
            del got, again
            torch.cuda.empty_cache()
            t_k = time_ms(lambda: fn(*args))
            t_p = time_ms(lambda: ref(*args))
            live = qt.live_pairs(k, x["cgsh"] if k in "IJ" else x["maskf"])
            work = qt.flops_bytes(k, x["x"], x[table], x[f"hr_{tag}"], x[f"hs_{tag}"], live)
            row = _so2_row(shape, err, t_k, t_p, work, card, flops_all_pairs=work["flops"],
                           live_pairs=live, pairs=work["pairs"], **extra)
            emit(f"kernel_{k}", **row, tolerance_rel=KERNEL_RTOL, kernel_times=t_k,
                 plain_times=t_p)
            per[k].append(row)
        del x
        torch.cuda.empty_cache()
    rows = headline_rows(per, QHNET_KERNELS, "qhnet_tp", ())
    for k in rows:
        rows[k]["ptxas"] = ptxas.get("qhnet_tp", {})
    return rows


def orbital_rotation(zs, orbitals: dict, rot: torch.Tensor, o_max: int) -> torch.Tensor:
    """Block-diagonal Wigner-D over the orbital shells of one molecule."""
    from nabladft_tpu_torch.ops import so3

    ds = [d[0] for d in so3.wigner_d(rot[None].double(), 2)]
    t = torch.eye(o_max, dtype=torch.float64, device=rot.device)
    off = 0
    for z in zs:
        for l in orbitals[int(z)]:
            k = 2 * l + 1
            t[off:off + k, off:off + k] = ds[l]
            off += k
    return t


def qhnet_train_phase(tmp: Path) -> dict:
    """QHNet's train and test jobs (configs/qhnet.yaml at full width) on a
    seeded Hamiltonian DB, then the gradient, H and covariance checks per
    atom bucket and a profile of two train steps; returns the launch counts
    of the jobs."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data.synthetic import write_random_hamiltonian_db

    db = write_random_hamiltonian_db(tmp / "hamiltonian.db", QH_MOLS, MIN_ATOMS, MAX_ATOMS,
                                     SEED)
    ckpt, outputs = tmp / "ckpt_qhnet", tmp / "outputs_qhnet"
    cfg = train_config(str(db), str(tmp), str(ckpt), str(outputs), config="qhnet")
    dm = pipelines.build_datamodule(cfg)
    n_train, n_val, n_test = (len(dm.train_dataloader()), len(dm.val_dataloader()),
                              len(dm.test_dataloader()))
    dropped = dm.dataset.n_dropped
    filled = sorted({dm.dataset.bucket_shape(b)[0] for b in dm.dataset.bucket_of if b >= 0})
    check(filled == list(BUCKETS), f"every atom bucket holds molecules: {filled}")

    # the main path: counts reset just before, read just after
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.time()
    res = pipelines.run(cfg)
    best = json.loads((ckpt / "index.json").read_text())["best"][0]["path"]
    test = pipelines.run(dict(cfg, job_type="test", ckpt_path=str(ckpt / best)))
    torch.cuda.synchronize()
    launches = all_launches()
    peak_mem = torch.cuda.max_memory_allocated()

    steps, n_layers = res["step"], cfg["model"]["kwargs"]["num_layers"]
    # Self / Pair heads on the layers after start_layer
    n_pair = n_layers - 1 - cfg["model"]["kwargs"].get("start_layer", 2)
    evals = TRAIN_EPOCHS * n_val + n_test
    check(steps == TRAIN_EPOCHS * n_train, f"{steps} train steps, expected {TRAIN_EPOCHS} x {n_train}")
    # remat: the backward pass runs each Conv and Pair layer's forward again
    want = dict.fromkeys(launches, 0)  # the other families' kernels: none
    want.update({"qhnet_conv_fwd": 2 * n_layers * steps + n_layers * evals,
                 "qhnet_conv_bwd": n_layers * steps,
                 "qhnet_pair_fwd": 2 * n_pair * steps + n_pair * evals,
                 "qhnet_pair_bwd": n_pair * steps})
    check(launches == want, f"qhnet train/test launches {launches}, expected {want}")
    check((ckpt / "last.ckpt").exists() and (ckpt / best).exists(), "checkpoint files")
    rows = read_csv(outputs / cfg["name"] / "metrics.csv")
    step_rows = [r for r in rows if "train/total" in r]
    val_rows = [r for r in rows if "val/loss" in r]
    check(len(step_rows) == steps and len(val_rows) == TRAIN_EPOCHS, "a CSV row per step and epoch")
    for r in step_rows:
        check(all(np.isfinite(r[k]) for k in ("train/total", "train/hamiltonian", "grad_norm")),
              f"finite train metrics {r}")
        check(r["skipped_nonfinite"] == 0.0, f"no skipped step {r}")
    for m in [res, test] + val_rows:
        check(all(np.isfinite(v) for v in m.values()), f"finite metrics {m}")
    check({"val/loss", "val/hamiltonian/mae"} <= set(res), f"val metrics {res}")
    check({"test/loss", "test/hamiltonian/mae"} <= set(test), f"test metrics {test}")
    rates = sorted(r["mols_per_sec"] for r in step_rows if r["epoch"] == TRAIN_EPOCHS - 1)
    epoch_ends = [t_start] + [r["time"] for r in val_rows]
    epoch_seconds = [b - a for a, b in zip(epoch_ends, epoch_ends[1:])]

    checks = qhnet_model_checks(cfg, dm)
    trainer = pipelines.build_trainer(dict(cfg, log_csv=False, ckpt_dir=None),
                                      torch.device("cuda"))
    batches = list(itertools.islice(dm.train_dataloader(), 2))
    reset_all_launches()  # each I-L launch runs the engine's products twice
    profile_steps("qhnet_train_profile", trainer._train_step, batches, top=24,
                  present=("so2_mma_kernel", "so2_mmw_kernel", "qhnet_conv_tp_fwd_kernel",
                           "qhnet_pair_tp_fwd_kernel", "qhnet_conv_tp_bwd_kernel",
                           "qhnet_pair_gx_kernel", "qhnet_pair_tp_bwd_kernel"),
                  absent=("qhnet_gemm_nt_kernel", "qhnet_gw_kernel", "qhnet_conv_fwd_kernel",
                          "qhnet_pair_fwd_kernel"),
                  calls=lambda: {"so2_mma_kernel": 2 * sum(
                      n for k, n in all_launches().items() if k.startswith("qhnet_"))})
    emit("qhnet_train", config="qhnet", molecules=QH_MOLS, dropped_molecules=dropped,
         steps=steps, batches_per_epoch=n_train, val_batches=n_val, test_batches=n_test,
         launches=launches, expected_launches=want, final_val=res, test=test,
         train_losses_first_last=[step_rows[0]["train/total"], step_rows[-1]["train/total"]],
         grad_norm_max=max(r["grad_norm"] for r in step_rows),
         molecules_per_second={"median": rates[len(rates) // 2], "min": rates[0],
                               "max": rates[-1], "steps": rates, "epoch": TRAIN_EPOCHS - 1},
         seconds_per_epoch=epoch_seconds, peak_device_memory_bytes=peak_mem,
         model_checks=checks,
         tolerances={"grad_rel": QH_GRAD_RTOL, "h_rel": QH_H_RTOL, "covariance_rel": QH_COV_RTOL})
    return launches


def qhnet_model_checks(cfg: dict, dm) -> list:
    """For the first train batch of each atom bucket, on the card with the
    same seeded weights: the kernel path's (I-L) parameter gradients and H
    against the plain module's (use_pallas "off"), and the kernel path's H
    of the batch rotated against T(R) H T(R)^T."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.train import Trainer, TrainerConfig

    dev = torch.device("cuda")
    t = dict(cfg["trainer"], loss_specs=cfg["model"]["loss_specs"],
             loss_coefs=cfg["model"]["loss_coefs"])
    plain_cfg = dict(cfg, model=dict(cfg["model"], kwargs=dict(cfg["model"]["kwargs"],
                                                               use_pallas="off")))
    fused = Trainer(pipelines.build_model(cfg, dev), dev, TrainerConfig(**t))
    plain = Trainer(pipelines.build_model(plain_cfg, dev), dev, TrainerConfig(**t))
    check(fused.model.use_pallas == "fused" and plain.model.use_pallas == "off", "model modes")
    orbitals = fused.model.layout.orbitals
    rot = torch.from_numpy(rotation()).to(dev)
    first = {}
    for batch in dm.train_dataloader():
        first.setdefault(batch.z.shape[1], batch)
    out = []
    for a, batch in sorted(first.items()):
        batch = batch.to(dev)
        lf, lp = fused._compute_grads(batch), plain._compute_grads(batch)
        err = _grad_errs(fused.model, plain.model)
        worst_name = max(err, key=err.get)
        worst = err[worst_name]
        check(worst <= QH_GRAD_RTOL, f"gradient check at A={a}: {worst_name} off by {worst:.3e}")
        with torch.no_grad():
            h_f = fused.model(batch)["hamiltonian"]
            h_p = plain.model(batch)["hamiltonian"]
            h_r = fused.model(batch.replace(pos=batch.pos @ rot.T))["hamiltonian"]
        h_scale = float(h_p.abs().max())
        h_err = float((h_f - h_p).abs().max())
        check(h_err <= QH_H_RTOL * h_scale, f"H at A={a}: {h_err} vs max |H| {h_scale}")
        cov = 0.0
        for k in range(batch.z.shape[0]):
            if not bool(batch.graph_mask[k]):
                continue
            zs = batch.z[k][batch.node_mask[k]].tolist()
            tr = orbital_rotation(zs, orbitals, rot, h_f.shape[-1])
            want = tr @ h_f[k].double() @ tr.T
            cov = max(cov, float((h_r[k].double() - want).abs().max()))
        check(cov <= QH_COV_RTOL * h_scale, f"covariance at A={a}: {cov} vs max |H| {h_scale}")
        out.append({"shape": list(batch.z.shape), "orbitals": batch.orb_mask.shape[1],
                    "max_rel_grad_err": worst, "worst_param": worst_name,
                    "loss_kernel": float(lf["total"]), "loss_plain": float(lp["total"]),
                    "max_abs_h_err": h_err, "max_abs_h": h_scale,
                    "max_abs_covariance_err": cov})
    check(sorted(first) == list(BUCKETS), f"model check buckets {sorted(first)}")
    return out


ESCN_KERNELS = {  # key: (name, JAX kernel body line in nabladft_tpu/ops/pallas/escn_layer.py)
    "M": ("escn_fwd (M)", 385), "N": ("escn_bwd (N)", 398),
}
# the plain versions of M and N, and the plain module on the card, run
# ESCN_PLAIN_MOLS molecules at a time: their autograd and einsum intermediates
# grow with B·A². Molecules are independent, so the chunks' per-molecule
# outputs concatenate and N's weight gradients sum.
ESCN_PLAIN_MOLS = 16
# eSCN on the card, fused against plain: E and F within ESCN_OUT_RTOL x the
# output's largest magnitude (at random weights the forces are ~1e-5, the
# residue of sphere samples that nearly cancel, below any absolute
# tolerance); parameter gradients within ESCN_GRAD_RTOL x max |g| per tensor,
# each fp32 path's distance from the plain module in float64 printed beside
# it (that cancellation moves the force head's bias gradients by fp32
# rounding alone). Under a rotation E stays within ESCN_OUT_RTOL x max |E|; F
# co-rotates only up to the truncated grid's aliasing (2M+1 longitudes in
# each edge's frame), a property of the model: the fused and plain modules'
# forces on the rotated batch are held to each other, and their equivariance
# errors are printed.
ESCN_OUT_RTOL, ESCN_GRAD_RTOL = 1e-4, 1e-3
# molecules of each bucket's first batch held against the CPU plain path
# (eight full-width layers on the host's cores), and in the gradient check
# (the plain module's autograd in float64)
ESCN_CPU_MOLS = 2


def _plain_in_chunks(ref, args, n_mol: int, kw: dict, n: int):
    """A plain kernel version over the batch, n molecules at a time: args'
    first n_mol inputs (and kw's cotangent g) are per molecule, the rest
    (the weights) shared. A forward's output is concatenated; a backward's
    cotangents with a batch axis (M/N's gx, gxe; O/P's gx, gxi, gxe)
    concatenated and its weight gradients summed in chunk order."""
    kw = dict(kw)
    g = kw.pop("g", None)
    parts = []
    for i in range(0, args[0].shape[0], n):
        sl = slice(i, i + n)
        parts.append(ref(*[a[sl] for a in args[:n_mol]], *args[n_mol:], **kw,
                         **({} if g is None else {"g": g[sl]})))
    if g is None:
        return torch.cat(parts)
    n_cat = len(parts[0]) - (len(args) - n_mol)  # the cotangents with a batch axis
    out = [torch.cat([q[k] for q in parts]) for k in range(n_cat)]
    for k in range(n_cat, len(parts[0])):
        acc = parts[0][k].clone()
        for q in parts[1:]:
            acc += q[k]
        out.append(acc)
    return tuple(out)


def escn_kernel_phases(dev, card: str, ptxas: dict) -> dict:
    """Kernels M and N at every shape the eSCN paths give them (B=BATCH, A in
    BUCKETS, escn-oc widths), on eSCN-built inputs, against their plain
    versions (run ESCN_PLAIN_MOLS molecules at a time, timed over the whole
    batch): errors (checked), kernel / plain / bound times; N twice for the
    same bits. The bound counts the FLOP model's work of the live pairs (the
    kernels skip the rest): `bound_ms` with the products at the 3xTF32
    tensor-core rate, `bound_fma_ms` all at the fp32 FMA rate (`tc_bound`);
    `flops_all_pairs` is the model over all B·A² pairs. Each row carries
    the kernels' registers, spills and shared memory (ptxas)."""
    from nabladft_tpu_torch.ops import escn_layer as el

    fns = {"M": (el.escn_fwd, el.escn_fwd_reference), "N": (el.escn_bwd, el.escn_bwd_reference)}
    per = {k: [] for k in ESCN_KERNELS}
    for a in BUCKETS:
        x = escn_kernel_inputs(dev, BATCH, a, seed=SEED + 3000 + a)
        args, dims = (x["x"], x["d"], x["xe"], *x["ws"]), x["dims"]
        shape = [BATCH, a, ESCN_KW["sphere_channels"]]
        live = el.live_pairs(x["d"])
        for k, (fn, ref) in fns.items():
            kw = dict(dims, g=x["g"]) if k == "N" else dims
            as_tuple = (lambda t: t if isinstance(t, tuple) else (t,))
            plain = (lambda ref=ref, kw=kw: _plain_in_chunks(ref, args, 3, kw, ESCN_PLAIN_MOLS))
            got = as_tuple(fn(*args, **kw))
            err = compare(got, as_tuple(plain()))
            check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel {k} error at {shape}: {err}")
            extra = {"live_pairs": live, "pairs": BATCH * a * a,
                     "plain_molecules_per_call": ESCN_PLAIN_MOLS}
            if k == "N":
                again = as_tuple(fn(*args, **kw))
                check(all(torch.equal(p, q) for p, q in zip(got, again)),
                      f"kernel N deterministic at {shape}")
                extra["bit_identical_rerun"] = True
                del again
            del got
            torch.cuda.empty_cache()
            t_k = time_ms(lambda: fn(*args, **kw))
            t_p = time_ms(plain)
            work = el.flops_bytes(k, x["x"], x["d"], x["xe"], x["ws"], **dims)
            row = _so2_row(shape, err, t_k, t_p, work, card, flops_all_pairs=work["flops"],
                           **extra)
            emit(f"kernel_{k}", **row, tolerance_rel=KERNEL_RTOL, kernel_times=t_k,
                 plain_times=t_p)
            per[k].append(row)
        del x, args
        torch.cuda.empty_cache()
    rows = headline_rows(per, ESCN_KERNELS, "escn_layer", ())
    for k in rows:
        rows[k]["ptxas"] = ptxas.get("escn_layer", {})
    return rows


def _mols(batch, sl: slice):
    """The molecules `sl` of a batch (every field's leading axis)."""
    import dataclasses

    return batch.replace(**{f.name: getattr(batch, f.name)[sl] for f in dataclasses.fields(batch)
                            if getattr(batch, f.name) is not None})


def _forward_in_chunks(model, batch, n: int) -> dict:
    """`forward` of the model over the batch, n molecules at a time."""
    from nabladft_tpu_torch.models.base import forward

    outs = [forward(model, _mols(batch, slice(i, i + n))) for i in range(0, batch.z.shape[0], n)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


EQV2_KERNELS = {  # key: (name, JAX kernel body line in nabladft_tpu/ops/pallas/eqv2_attn.py)
    "O": ("eqv2_fwd (O)", 640), "P": ("eqv2_bwd (P)", 741),
}
EQV2_ARGS = ("x", "x", "idx", "d", "xe", "maskf", "dropk")
# the plain versions of O and P, and the plain module on the card, run
# EQV2_PLAIN_MOLS molecules at a time (their autograd and einsum
# intermediates grow with the B·A·K edge slots); the chunks' per-molecule
# outputs concatenate and P's weight gradients sum
EQV2_PLAIN_MOLS = 16
# EquiformerV2 on the card, fused against plain: E and F within
# EQV2_OUT_RTOL x the output's largest magnitude, parameter gradients within
# EQV2_GRAD_RTOL x max |g| per tensor (each fp32 path's distance from the
# plain module in float64 printed beside it). Under a rotation E and F move
# by the per-edge truncated grid's aliasing (2M+1 longitudes in each edge's
# frame), the model's own: the plain module and JAX's XLA model move E by
# ~5e-3 of max |E| at full width, so E is held within EQV2_E_ROT x max |E|,
# the fused and plain modules' outputs on the rotated batch to each other
# within EQV2_OUT_RTOL, and F's equivariance error is printed.
EQV2_OUT_RTOL, EQV2_GRAD_RTOL, EQV2_E_ROT = 1e-4, 1e-3, 2e-2
# molecules of each bucket's first batch held against the CPU plain path (13
# full-width attention calls on the host's cores), and in the gradient
# check (the plain autograd in float64)
EQV2_CPU_MOLS, EQV2_GRAD_MOLS = 1, 2
# timed passes of EquiformerV2's predict loop after a warm-up pass (cut from
# PASSES: a pass over the 256 molecules takes seconds)
EQV2_PASSES = 3


def _eqv2_args(inp, **over):
    """Kernel O / P's positional arguments, `over` replacing inputs."""
    t = dict(inp, **over)
    return [t[k] for k in EQV2_ARGS] + t["ws"]


def so2_products_phase(dev, card: str, inp: dict, rows: int) -> None:
    """The product engine alone on P's largest product: conv 1's m=0 rows
    [rows, 1792] (seeded, ~N(0, 0.5²)) times the block's w1 [1792, 1536],
    over `rows` = the live edges; its error against float64, its time beside
    one fp32 torch.matmul of the same rows (library_ms, TF32 off), the
    achieved TFLOP/s and the fp32 FMA and 3xTF32 tensor-core bounds."""
    from nabladft_tpu_torch.ops import eqv2_attn as ea

    peak_flops, peak_bw, peak_tf32 = peaks(card, tensor_cores=True)
    w = inp["ws"][2]
    k, n = w.shape
    g = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randn(rows, k, generator=g, device=dev) * 0.5
    c = torch.empty(rows, n, device=dev)
    probs = [dict(segs=[dict(a=a, b=w, k=k)], n=n, c=c)]
    ea.so2_products(probs, rows)
    ref = a.double() @ w.double()
    err = compare((c,), (ref,))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"so2_products error: {err}")
    del ref
    t_k = time_ms(lambda: ea.so2_products(probs, rows))
    t_l = time_ms(lambda: torch.matmul(a, w))
    flops, nbytes = 2 * rows * k * n, 4 * (rows * k + k * n + rows * n)
    t_bytes = nbytes / peak_bw * 1e3
    emit("so2_products", rows=rows, k=k, n=n, **err, tolerance_rel=KERNEL_RTOL,
         ms=t_k["median"], library_ms=t_l["median"], library="torch.matmul fp32 (TF32 off)",
         tflops=flops / t_k["median"] / 1e9, library_tflops=flops / t_l["median"] / 1e9,
         bound_tc_ms=max(flops / (peak_tf32 / TC_PASSES) * 1e3, t_bytes),
         bound_fma_ms=max(flops / peak_flops * 1e3, t_bytes), flops=flops, bytes=nbytes,
         kernel_times=t_k, library_times=t_l)
    del a, c
    torch.cuda.empty_cache()


def eqv2_kernel_phases(dev, card: str, ptxas: dict) -> dict:
    """Kernels O and P at every shape the EquiformerV2 paths give them
    (B=BATCH, A in BUCKETS, configs/equiformer_v2.yaml widths), on
    EquiformerV2-built inputs, against their plain versions (run
    EQV2_PLAIN_MOLS molecules at a time, timed over the whole batch): O with
    dropk ones (eval) and a seeded keep mask (train), P with the mask, every
    cotangent checked, twice for the same bits; kernel / plain / bound
    times. The bound counts the FLOP model's work of the live edges (the
    kernels skip the rest), as M and N's does; `flops_all_slots` is the
    model over all B·A·K edge slots. At A=HEADLINE_A also the engine alone
    on P's largest product (`so2_products_phase`)."""
    from nabladft_tpu_torch.ops import eqv2_attn as ea

    per = {k: [] for k in EQV2_KERNELS}
    for a in BUCKETS:
        inp = eqv2_kernel_inputs(dev, BATCH, a, seed=SEED + 4000 + a, drop=True)
        shape = [BATCH, a, EQV2_KW["sphere_channels"]]
        live = ea.live_edges(inp["maskf"])
        extra = {"live_edges": live, "edge_slots": inp["maskf"].numel(),
                 "plain_molecules_per_call": EQV2_PLAIN_MOLS}
        args, dims = _eqv2_args(inp), inp["dims"]

        # O: dropk = ones (the eval paths) and the seeded keep mask (train)
        errs = {}
        for tag, over in (("ones", {"dropk": inp["ones"]}), ("mask", {})):
            a_tag = _eqv2_args(inp, **over)
            got = ea.eqv2_fwd(*a_tag, **dims)
            err = compare((got,), (_plain_in_chunks(ea.eqv2_fwd_reference, a_tag, 7, dims,
                                                     EQV2_PLAIN_MOLS),))
            check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel O ({tag}) error at {shape}: {err}")
            errs[tag] = err
            del got
        torch.cuda.empty_cache()
        t_k = time_ms(lambda: ea.eqv2_fwd(*args, **dims))
        t_p = time_ms(lambda: _plain_in_chunks(ea.eqv2_fwd_reference, args, 7, dims,
                                               EQV2_PLAIN_MOLS))
        work = ea.flops_bytes("O", inp["x"], inp["idx"], inp["d"], inp["xe"], inp["maskf"],
                              inp["dropk"], inp["ws"], **dims)
        row = _so2_row(shape, errs["mask"], t_k, t_p, work, card, flops_all_slots=work["flops"],
                       max_rel_err_dropk_ones=errs["ones"]["max_rel_err"],
                       max_rel_err_dropk_mask=errs["mask"]["max_rel_err"], **extra)
        row["max_abs_err"] = max(errs["ones"]["max_abs_err"], errs["mask"]["max_abs_err"])
        emit("kernel_O", **row, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p)
        per["O"].append(row)

        if a == HEADLINE_A:
            so2_products_phase(dev, card, inp, live)

        # P: every cotangent, run twice for the same bits
        got = ea.eqv2_bwd(*args, g=inp["g"], **dims)
        bwd_kw = dict(dims, g=inp["g"])
        err = compare(got, _plain_in_chunks(ea.eqv2_bwd_reference, args, 7, bwd_kw,
                                            EQV2_PLAIN_MOLS))
        # max_rel_err is the largest over the cotangents, each against its own scale
        check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel P error at {shape}: {err}")
        again = ea.eqv2_bwd(*args, g=inp["g"], **dims)
        check(all(torch.equal(p, q) for p, q in zip(got, again)),
              f"kernel P deterministic at {shape}")
        del got, again
        torch.cuda.empty_cache()
        t_k = time_ms(lambda: ea.eqv2_bwd(*args, g=inp["g"], **dims))
        t_p = time_ms(lambda: _plain_in_chunks(ea.eqv2_bwd_reference, args, 7, bwd_kw,
                                               EQV2_PLAIN_MOLS))
        work = ea.flops_bytes("P", inp["x"], inp["idx"], inp["d"], inp["xe"], inp["maskf"],
                              inp["dropk"], inp["ws"], **dims)
        row = _so2_row(shape, err, t_k, t_p, work, card, flops_all_slots=work["flops"],
                       bit_identical_rerun=True,
                       cotangents=["gx", "gxi", "gxe"] + ea.weight_names(dims["m_max"]), **extra)
        emit("kernel_P", **row, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p)
        per["P"].append(row)
        del inp, args
        torch.cuda.empty_cache()
    rows = headline_rows(per, EQV2_KERNELS, "eqv2_attn", ())
    for k in rows:
        rows[k]["ptxas"] = ptxas.get("eqv2_attn", {})
    return rows


# the direct-force SO(2) families chip_smoke drives: config, kernel counters
# (forward, backward), message / attention calls per forward, the plain
# module's and the CPU reference's molecules per call, the gradient check's
# molecules, tolerances (outputs, gradients, E under a rotation), timed
# predict passes, and whether the model draws dropout in training
DIRECT = {
    "escn": dict(config="escn-oc", fwd="escn_fwd", bwd="escn_bwd",
                 calls=lambda kw: kw["num_layers"], plain_mols=ESCN_PLAIN_MOLS,
                 cpu_mols=ESCN_CPU_MOLS, grad_mols=ESCN_CPU_MOLS, out_rtol=ESCN_OUT_RTOL,
                 grad_rtol=ESCN_GRAD_RTOL, e_rot=ESCN_OUT_RTOL, passes=PASSES, dropout=False),
    "eqv2": dict(config="equiformer_v2", fwd="eqv2_fwd", bwd="eqv2_bwd",
                 calls=lambda kw: kw["num_layers"] + 1, plain_mols=EQV2_PLAIN_MOLS,
                 cpu_mols=EQV2_CPU_MOLS, grad_mols=EQV2_GRAD_MOLS, out_rtol=EQV2_OUT_RTOL,
                 grad_rtol=EQV2_GRAD_RTOL, e_rot=EQV2_E_ROT, passes=EQV2_PASSES, dropout=True),
}


def _plain_cfg(cfg: dict) -> dict:
    return dict(cfg, model=dict(cfg["model"], kwargs=dict(cfg["model"]["kwargs"],
                                                          use_pallas="off")))


def direct_predict_phase(tmp: Path, db: Path, family: str) -> dict:
    """`job_type: predict` of a direct-force family (eSCN, EquiformerV2) at
    full width and depth, batch BATCH, over the seeded DB: rows, finite
    values, the forward kernel once per message / attention call of each
    batch, the backward never, no dropout drawn; per bucket, the first batch
    and the same batch rotated against the plain module on the card (eval
    mode, as the job runs the model), its first molecules against the CPU
    plain path; E under the rotation within the family's limit, F's
    equivariance error printed; molecules/s of the predict loop."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data.ase_codec import AseDatabase
    from nabladft_tpu_torch.models import equiformer_v2 as eqv2_mod
    from nabladft_tpu_torch.models.base import forward
    from nabladft_tpu_torch.train import Trainer

    fam = DIRECT[family]
    cfg = smoke_config(str(db), str(tmp / f"predictions_{family}.db"), str(tmp),
                       config=fam["config"])
    n_calls = fam["calls"](cfg["model"]["kwargs"])

    # the main path: counts reset just before, read just after
    reset_all_launches()
    eqv2_mod.reset_dropout_draws()
    torch.cuda.reset_peak_memory_stats()
    res = pipelines.run(cfg)
    torch.cuda.synchronize()
    launches = all_launches()
    draws = dict(eqv2_mod.DROPOUT_DRAWS)
    peak_mem = torch.cuda.max_memory_allocated()

    n_batches = res["batches"]
    check(res["rows"] == N_MOLS, f"rows written {res['rows']} != {N_MOLS}")
    want = dict.fromkeys(launches, 0)
    want[fam["fwd"]] = n_calls * n_batches
    check(launches == want, f"{family} predict launches {launches}, expected {want}")
    check(draws == {"alpha": 0, "drop_path": 0}, f"dropout drawn on predict: {draws}")
    dm = pipelines.build_datamodule(cfg)
    # the writer keeps the loader's order of the real molecules
    order = [mid for b in dm.predict_dataloader()
             for mid, real in zip(b.mol_id.tolist(), b.graph_mask.tolist()) if real]
    out_rows = dict(zip(order, AseDatabase(cfg["output_db"]).select_all()))
    check(len(out_rows) == N_MOLS, "output DB row count")
    for rec in out_rows.values():
        e, f = np.asarray(rec.data["energy_pred"]), np.asarray(rec.data["forces_pred"])
        check(e.shape == (1,) and f.shape == (rec.natoms, 3), "prediction shapes")
        check(bool(np.isfinite(e).all() and np.isfinite(f).all()), "finite predictions")

    shapes = sorted({tuple(b.z.shape) for b in dm.predict_dataloader()})
    check(all(s in [(BATCH, a) for a in BUCKETS] for s in shapes), f"predict batch shapes {shapes}")
    dev = torch.device("cuda")
    gpu = Trainer(pipelines.build_model(cfg, dev).eval(), dev)
    plain = Trainer(pipelines.build_model(_plain_cfg(cfg), dev).eval(), dev)
    cpu = Trainer(pipelines.build_model(cfg, torch.device("cpu")).eval(), "cpu")
    check(gpu.model.use_pallas == "fused" and plain.model.use_pallas == "off"
          and cpu.model.use_pallas == "off", "model modes")
    first = {}
    for batch in dm.predict_dataloader():
        first.setdefault(batch.z.shape[1], batch)
    checks = []
    rot = torch.from_numpy(rotation()).to(dev)
    for a, batch in sorted(first.items()):
        bg = batch.to(dev)
        bg_r = bg.replace(pos=bg.pos @ rot.T)
        out_f, out_r = forward(gpu.model, bg), forward(gpu.model, bg_r)
        out_p = _forward_in_chunks(plain.model, bg, fam["plain_mols"])
        out_pr = _forward_in_chunks(plain.model, bg_r, fam["plain_mols"])
        first_c = slice(0, fam["cpu_mols"])
        out_c = forward(cpu.model, _mols(batch, first_c))
        m = bg.graph_mask.cpu().numpy()
        # the job's rows are the fused model's outputs of this batch
        for i, mol_id in enumerate(batch.mol_id.tolist()):
            if m[i]:
                rec = out_rows[mol_id]
                check(abs(rec.data["energy_pred"][0] - float(out_f["energy"][i])) <= 1e-6 *
                      max(abs(float(out_f["energy"][i])), 1e-6), "job rows = the fused model")
        scale = {"energy": _max_abs(out_p["energy"]), "forces": _max_abs(out_p["forces"])}
        row = {"shape": list(batch.z.shape), "max_abs_energy": scale["energy"],
               "max_abs_force": scale["forces"]}
        for tag, got, ref in (("card_plain", out_f, out_p), ("card_plain_rotated", out_r, out_pr),
                              ("cpu_plain", {k: v[first_c].cpu() for k, v in out_f.items()},
                               out_c)):
            for k in ("energy", "forces"):
                err = _max_abs(got[k] - ref[k].to(got[k].device))
                row[f"{k}_abs_err_vs_{tag}"] = err
                row[f"{k}_rel_err_vs_{tag}"] = err / scale[k]
                check(err <= fam["out_rtol"] * scale[k],
                      f"{family} {k} at A={a} vs {tag}: {err} > {fam['out_rtol']} x {scale[k]}")
        e_rot = _max_abs(out_r["energy"] - out_f["energy"])
        check(e_rot <= fam["e_rot"] * scale["energy"],
              f"{family} energy under a rotation at A={a}: {e_rot} vs max |E| {scale['energy']}")
        # readings: E's and F's rotation errors, the fused and the plain module's
        row["rotation_energy_rel_err"] = e_rot / scale["energy"]
        row["rotation_energy_rel_err_plain"] = (_max_abs(out_pr["energy"] - out_p["energy"])
                                                / scale["energy"])
        row["rotation_force_rel_err"] = (_max_abs(out_r["forces"] - out_f["forces"] @ rot.T)
                                         / scale["forces"])
        row["rotation_force_rel_err_plain"] = (_max_abs(out_pr["forces"] - out_p["forces"] @ rot.T)
                                               / scale["forces"])
        checks.append(row)
        del out_f, out_r, out_p, out_pr
    check(sorted(first) == list(BUCKETS), f"predict buckets {sorted(first)}")
    del plain, cpu
    torch.cuda.empty_cache()

    rates = []
    for p in range(fam["passes"] + 1):
        t0 = time.perf_counter()
        n_pred = sum(len(o["energy"]) for o in gpu.predict(dm.predict_dataloader()))
        torch.cuda.synchronize()
        if p:
            rates.append(n_pred / (time.perf_counter() - t0))
    rates.sort()
    profile_phase(f"{family}_profile", gpu, dm)
    emit(f"{family}_predict", config=fam["config"], rows=res["rows"], batches=n_batches,
         batch_shapes=shapes, launches=launches, dropout_draws=draws,
         run_seconds=res["seconds"], checks=checks,
         molecules_per_second={"median": rates[len(rates) // 2], "min": rates[0],
                               "max": rates[-1], "passes": rates},
         peak_device_memory_bytes=peak_mem,
         tolerances={"output_rel": fam["out_rtol"], "rotation_energy_rel": fam["e_rot"]})
    return launches


def direct_train_phase(tmp: Path, db: Path, family: str) -> dict:
    """The train (TRAIN_EPOCHS epochs) and test jobs of a direct-force family
    at full width and depth, batch BATCH: the forward kernel once per call
    of each train step, validation and test batch, the backward once per
    call of each train step; dropout drawn on train steps only
    (EquiformerV2: 13 alpha and 24 drop-path masks a step); finite losses
    and metrics; per bucket, dropout off, the fused model's parameter
    gradients against the plain module's on the card (checked) and both
    against the plain module in float64 (printed), on the first molecules
    (the plain autograd's memory); a profile of two train steps."""
    import copy

    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.models import equiformer_v2 as eqv2_mod
    from nabladft_tpu_torch.train import Trainer, TrainerConfig

    fam = DIRECT[family]
    ckpt, outputs = tmp / f"ckpt_{family}", tmp / f"outputs_{family}"
    cfg = train_config(str(db), str(tmp), str(ckpt), str(outputs), config=fam["config"])
    dm = pipelines.build_datamodule(cfg)
    n_train, n_val, n_test = (len(dm.train_dataloader()), len(dm.val_dataloader()),
                              len(dm.test_dataloader()))
    n_layers = cfg["model"]["kwargs"]["num_layers"]
    n_calls = fam["calls"](cfg["model"]["kwargs"])

    # the main path: counts reset just before, read just after
    reset_all_launches()
    eqv2_mod.reset_dropout_draws()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.time()
    res = pipelines.run(cfg)
    draws_train = dict(eqv2_mod.DROPOUT_DRAWS)
    best = json.loads((ckpt / "index.json").read_text())["best"][0]["path"]
    test = pipelines.run(dict(cfg, job_type="test", ckpt_path=str(ckpt / best)))
    torch.cuda.synchronize()
    launches = all_launches()
    draws = dict(eqv2_mod.DROPOUT_DRAWS)
    peak_mem = torch.cuda.max_memory_allocated()

    steps = res["step"]
    check(steps == TRAIN_EPOCHS * n_train,
          f"{steps} train steps, expected {TRAIN_EPOCHS} x {n_train}")
    want = dict.fromkeys(launches, 0)
    want.update({fam["fwd"]: n_calls * (steps + TRAIN_EPOCHS * n_val + n_test),
                 fam["bwd"]: n_calls * steps})
    check(launches == want, f"{family} train/test launches {launches}, expected {want}")
    want_draws = ({"alpha": n_calls * steps, "drop_path": 2 * n_layers * steps}
                  if fam["dropout"] else {"alpha": 0, "drop_path": 0})
    check(draws_train == draws == want_draws,
          f"dropout draws {draws_train} (train), {draws} (after test), expected {want_draws}")
    check((ckpt / "last.ckpt").exists() and (ckpt / best).exists(), "checkpoint files")
    rows = read_csv(outputs / cfg["name"] / "metrics.csv")
    step_rows = [r for r in rows if "train/total" in r]
    val_rows = [r for r in rows if "val/loss" in r]
    check(len(step_rows) == steps and len(val_rows) == TRAIN_EPOCHS, "a CSV row per step and epoch")
    for r in step_rows:
        check(all(np.isfinite(r[k]) for k in ("train/total", "train/energy", "train/forces",
                                              "grad_norm")), f"finite train metrics {r}")
        check(r["skipped_nonfinite"] == 0.0, f"no skipped step {r}")
    for m in [res, test] + val_rows:
        check(all(np.isfinite(v) for v in m.values()), f"finite metrics {m}")
    check({"test/loss", "test/energy/mae", "test/forces/mae"} <= set(test), f"test metrics {test}")
    rates = sorted(r["mols_per_sec"] for r in step_rows if r["epoch"] == TRAIN_EPOCHS - 1)
    epoch_ends = [t_start] + [r["time"] for r in val_rows]
    epoch_seconds = [b - a for a, b in zip(epoch_ends, epoch_ends[1:])]

    # fused against plain on the card, fp32 and float64, one batch per bucket,
    # dropout off in all three (eval mode)
    dev = torch.device("cuda")
    t = TrainerConfig(**dict(cfg["trainer"], loss_specs=cfg["model"]["loss_specs"],
                             loss_coefs=cfg["model"]["loss_coefs"]))
    fused = Trainer(pipelines.build_model(cfg, dev).eval(), dev, t)
    plain = Trainer(pipelines.build_model(_plain_cfg(cfg), dev).eval(), dev, t)
    exact = Trainer(copy.deepcopy(plain.model).double(), dev, t)
    check(fused.model.use_pallas == "fused" and plain.model.use_pallas == "off", "model modes")
    first = {}
    for batch in dm.train_dataloader():
        first.setdefault(batch.z.shape[1], batch)
    grads = []
    for a, batch in sorted(first.items()):
        small = _mols(batch, slice(0, fam["grad_mols"])).to(dev)
        eqv2_mod.reset_dropout_draws()
        lf, lp = fused._compute_grads(small), plain._compute_grads(small)
        lx = exact._compute_grads(small.replace(**{k: getattr(small, k).double()
                                                   for k in ("pos", "energy", "forces")}))
        check(eqv2_mod.DROPOUT_DRAWS == {"alpha": 0, "drop_path": 0}, "gradient check in eval")
        torch.cuda.empty_cache()
        err = _grad_errs(fused.model, plain.model)
        name = max(err, key=err.get)
        check(err[name] <= fam["grad_rtol"],
              f"gradient check at A={a}: {name} off by {err[name]:.3e}")
        check(abs(float(lf["total"]) - float(lp["total"])) <= 1e-4 * abs(float(lp["total"])),
              f"loss at A={a}: {float(lf['total'])} vs {float(lp['total'])}")
        # readings: each fp32 path against the float64 plain module
        err_f, err_p = _grad_errs(fused.model, exact.model), _grad_errs(plain.model, exact.model)
        grads.append({"shape": list(small.z.shape), "max_rel_grad_err": err[name],
                      "worst_param": name, "worst_param_fused_vs_float64": err_f[name],
                      "worst_param_plain_vs_float64": err_p[name],
                      "max_rel_grad_err_fused_vs_float64": max(err_f.values()),
                      "max_rel_grad_err_plain_vs_float64": max(err_p.values()),
                      "worst_params_vs_float64": [max(err_f, key=err_f.get),
                                                  max(err_p, key=err_p.get)],
                      "loss_kernel": float(lf["total"]), "loss_plain": float(lp["total"]),
                      "loss_float64": float(lx["total"])})
    check(sorted(first) == list(BUCKETS), f"gradient check buckets {sorted(first)}")
    del fused, plain, exact
    torch.cuda.empty_cache()

    trainer = pipelines.build_trainer(dict(cfg, log_csv=False, ckpt_dir=None), dev)
    batches = list(itertools.islice(dm.train_dataloader(), 2))
    profile_steps(f"{family}_train_profile", trainer._train_step, batches)
    emit(f"{family}_train", config=fam["config"], steps=steps, batches_per_epoch=n_train,
         val_batches=n_val, test_batches=n_test, launches=launches, expected_launches=want,
         dropout_draws=draws, final_val=res, test=test,
         train_losses_first_last=[step_rows[0]["train/total"], step_rows[-1]["train/total"]],
         grad_norm_max=max(r["grad_norm"] for r in step_rows),
         molecules_per_second={"median": rates[len(rates) // 2], "min": rates[0],
                               "max": rates[-1], "steps": rates, "epoch": TRAIN_EPOCHS - 1},
         seconds_per_epoch=epoch_seconds, peak_device_memory_bytes=peak_mem,
         gradient_check=grads, tolerances={"grad_rel": fam["grad_rtol"]})
    return launches


ALL_KERNELS = {"A": "painn_fwd", "B": "painn_bwd", "C": "painn_dual_fwd", "D": "painn_dual_bwd",
               "E": "schnet_fwd", "F": "schnet_bwd", "G": "schnet_dual_fwd",
               "H": "schnet_dual_bwd", "I": "qhnet_conv_fwd", "J": "qhnet_conv_bwd",
               "K": "qhnet_pair_fwd", "L": "qhnet_pair_bwd", "M": "escn_fwd",
               "N": "escn_bwd", "O": "eqv2_fwd", "P": "eqv2_bwd"}  # kernel -> its launch counter


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from concurrent.futures import ThreadPoolExecutor

    from nabladft_tpu_torch.data.synthetic import write_random_db
    from nabladft_tpu_torch.ops import _kernels

    seconds = {}
    t_all = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    nvcc_version = subprocess.run([_kernels.nvcc(), "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    sources = ("painn_fused", "schnet_fused", "qhnet_tp", "escn_layer", "eqv2_attn")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        builds = dict(zip(sources, pool.map(_kernels.build, sources)))
    seconds["build"] = time.perf_counter() - t0
    ptxas = {k: ptxas_summary(v["log"]) for k, v in builds.items()}
    emit("env", device=card, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc_version,
         build_seconds=seconds["build"],
         build_seconds_by_source={k: v["seconds"] for k, v in builds.items()},
         ptxas=ptxas)

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    dev = torch.device("cuda")
    rows = timed("kernels_painn", kernel_phases, dev, card, ptxas)
    rows.update(timed("kernels_schnet", schnet_kernel_phases, dev, card, ptxas))
    rows.update(timed("kernels_qhnet", qhnet_kernel_phases, dev, card, ptxas))
    rows.update(timed("kernels_escn", escn_kernel_phases, dev, card, ptxas))
    rows.update(timed("kernels_eqv2", eqv2_kernel_phases, dev, card, ptxas))
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        db = timed("db_write", write_random_db, tmp / "smoke.db", N_MOLS, MIN_ATOMS, MAX_ATOMS,
                   SEED)
        for family in FAMILIES:
            for job, phase in (("predict", predict_phase), ("train", train_phase)):
                path = f"{family}_{job}"
                by_path[path] = timed(path, phase, tmp, db, family)
            if family == "painn":  # from the train phase's best checkpoint
                by_path["painn_optimize"] = timed("painn_optimize", optimize_phase, tmp, db)
        by_path["qhnet_train"] = timed("qhnet_train", qhnet_train_phase, tmp)
        for family in DIRECT:
            for job, phase in (("predict", direct_predict_phase), ("train", direct_train_phase)):
                path = f"{family}_{job}"
                by_path[path] = timed(path, phase, tmp, db, family)
    for k, counter in ALL_KERNELS.items():
        rows[k]["launches_by_path"] = {p: n[counter] for p, n in by_path.items()}
        rows[k]["launches"] = sum(rows[k]["launches_by_path"].values())
        check(rows[k]["launches"] > 0, f"kernel {k} launched on its path")
    seconds["total"] = time.perf_counter() - t_all
    emit("timing", seconds=seconds)
    print(json.dumps({"kernels": [rows[k] for k in ALL_KERNELS]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
