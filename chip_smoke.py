#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: kernels, predict, train, test.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the repository
checkout; no network and no PyYAML. Phases, each printing one JSON line:

  1. env     — device, torch / CUDA / nvcc versions, the card's name and
               power limit; builds csrc/painn_fused.cu and csrc/schnet_fused.cu
               (one nvcc each, started together) and prints each kernel's
               registers and spills.
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
               max of 25 runs after warm-up); D and H are run twice and must
               give the same bits.
  3. predict — for each family, `pipelines.run` of ``job_type: predict`` on
               configs/painn-oc.yaml, then configs/schnet.yaml, at full width
               and depth (hidden 128, 6 interactions, 100 RBF), batch 64,
               buckets 32/48/64, over one seeded DB of 256 molecules (8-62
               atoms, H C N O F S Cl); checks rows, finiteness, launch counts
               (the forward and backward kernel 6x per batch, the backward's
               weight-gradient stage never), every batch against the CPU
               plain path, rotation invariance / equivariance; molecules/s
               (median / min / max of 7 passes after a warm-up pass).
     profile — torch.profiler over two predict steps: device time by
               kernel and the device's busy share (printed before predict).
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
               per epoch, peak device memory.
     train_profile — torch.profiler over two train steps (printed before
               train).
  SchNet's lines carry the prefix ``schnet_`` (schnet_predict, ...).
  5. timing  — seconds of each phase; then one JSON object describing every
               ported kernel (A-H) with its launches on each path.
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
# outside the tensor cores, and memory bytes/s.
PEAKS = {
    "H100 PCIe": (51e12, 2.0e12),
    "H100 NVL": (60e12, 3.9e12),
    "H100": (67e12, 3.35e12),  # SXM5 (e.g. "NVIDIA H100 80GB HBM3")
    "H200": (67e12, 4.8e12),
}


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


CONFIGS = {"painn-oc": _painn_oc, "schnet": _schnet}


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
    nvcc -Xptxas -v output (a template kernel's name carries its integer
    arguments, as name<7,0>; dynamic shared memory is the launch's)."""
    out, name = {}, None
    for line in log.splitlines():
        # <file>_cu_<hash><len><name>, then I Li<n> E ... E for int template arguments
        m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?_kernel)((?:ILi\d+E(?:Li\d+E)*E)?)", line)
        if m and ("entry function" in line or "properties for" in line):
            name = m.group(1)
            if m.group(2):
                name += "<" + ",".join(re.findall(r"Li(\d+)E", m.group(2))) + ">"
            out.setdefault(name, {})
        elif name and "spill stores" in line:
            out[name]["spill"] = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", line):
                out[name]["static_smem_bytes"] = int(m.group(1))
    return out


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
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


def kernel_bucket(pf, dev, a: int, peak_flops: float, peak_bw: float):
    """Kernels A-D at (KB, a, KR, KF) against their plain versions: errors
    (checked), and kernel / plain / bound times. B is checked and timed both
    with the weight gradient and without it, as the predict path runs it."""
    x = kernel_inputs(dev, a)
    a_args = [x[k] for k in ("rbf", "phi", "v", "unit_t", "w")]
    b_args = [x[k] for k in ("rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv")]
    shape = [KB, a, KR, KF]

    err = compare(pf.painn_fwd(*a_args), pf.painn_message_reference(*a_args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel A error at {shape}: {err}")
    t_k = time_ms(lambda: pf.painn_fwd(*a_args))
    t_p = time_ms(lambda: pf.painn_message_reference(*a_args))
    row_a = _kernel_row(shape, err, t_k, t_p, *pf.painn_fwd_flops_bytes(x["rbf"], KF),
                        peak_flops, peak_bw)
    emit("kernel_A", **row_a, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p)

    got = pf.painn_bwd(*b_args)
    err = compare(got, pf.painn_message_bwd_reference(*b_args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel B error at {shape}: {err}")
    got_ng = pf.painn_bwd(*b_args, need_gw=False)
    check(got_ng[4] is None and all(torch.equal(p, q) for p, q in zip(got_ng[:4], got[:4])),
          "kernel B without gW gives the same node and pair cotangents")
    err_ng = compare(got_ng[:4], pf.painn_message_bwd_reference(*b_args, need_gw=False)[:4])
    check(err_ng["max_rel_err"] <= KERNEL_RTOL, f"kernel B (no gW) error at {shape}: {err_ng}")
    flops_ng, nbytes_ng = pf.painn_bwd_flops_bytes(x["rbf"], KF, need_gw=False)
    b_ms_ng, b_by_ng = bound(flops_ng, nbytes_ng, peak_flops, peak_bw)
    t_k = time_ms(lambda: pf.painn_bwd(*b_args))
    t_p = time_ms(lambda: pf.painn_message_bwd_reference(*b_args))
    t_k_ng = time_ms(lambda: pf.painn_bwd(*b_args, need_gw=False))
    t_p_ng = time_ms(lambda: pf.painn_message_bwd_reference(*b_args, need_gw=False))
    row_b = _kernel_row(shape, err, t_k, t_p, *pf.painn_bwd_flops_bytes(x["rbf"], KF),
                        peak_flops, peak_bw, max_abs_err_without_gw=err_ng["max_abs_err"],
                        ms_without_gw=t_k_ng["median"], plain_ms_without_gw=t_p_ng["median"],
                        bound_ms_without_gw=b_ms_ng, bound_by_without_gw=b_by_ng,
                        flops_without_gw=flops_ng,
                        roofline_share_without_gw=b_ms_ng / t_k_ng["median"])
    emit("kernel_B", **row_b, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p,
         kernel_times_without_gw=t_k_ng, plain_times_without_gw=t_p_ng)

    c_args = [x[k] for k in C_ARGS]
    err = compare(pf.painn_dual_fwd(*c_args), pf.painn_dual_fwd_reference(*c_args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel C error at {shape}: {err}")
    t_k = time_ms(lambda: pf.painn_dual_fwd(*c_args))
    t_p = time_ms(lambda: pf.painn_dual_fwd_reference(*c_args))
    row_c = _kernel_row(shape, err, t_k, t_p,
                        *pf.painn_dual_fwd_flops_bytes(x["rbf"], x["rbfd"], KF), peak_flops,
                        peak_bw)
    emit("kernel_C", **row_c, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p)

    d_args = [x[k] for k in D_ARGS]
    got = pf.painn_dual_bwd(*d_args)
    err = compare(got, pf.painn_dual_bwd_reference(*d_args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel D error at {shape}: {err}")
    again = pf.painn_dual_bwd(*d_args)
    check(all(torch.equal(p, q) for p, q in zip(got, again)), f"kernel D deterministic at {shape}")
    t_k = time_ms(lambda: pf.painn_dual_bwd(*d_args))
    t_p = time_ms(lambda: pf.painn_dual_bwd_reference(*d_args))
    row_d = _kernel_row(shape, err, t_k, t_p,
                        *pf.painn_dual_bwd_flops_bytes(x["rbf"], x["rbfd"], KF), peak_flops,
                        peak_bw, bit_identical_rerun=True)
    emit("kernel_D", **row_d, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p)
    return {"A": row_a, "B": row_b, "C": row_c, "D": row_d}


KERNELS = {  # key: (name, JAX kernel body line in nabladft_tpu/ops/pallas/painn_fused.py)
    "A": ("painn_fwd (A)", 114), "B": ("painn_bwd (B)", 177),
    "C": ("painn_dual_fwd (C)", 286), "D": ("painn_dual_bwd (D)", 372),
}


def kernel_phases(dev, card: str) -> dict:
    """Kernels A-D at every bucket shape of the predict and train paths. The
    kernels line's numbers are those at A=HEADLINE_A, except max_abs_err,
    the largest over all buckets; `per_bucket` holds each bucket's."""
    from nabladft_tpu_torch.ops import painn_fused as pf

    peak_flops, peak_bw = peaks(card)
    per = {k: [] for k in KERNELS}
    for a in BUCKETS:
        for k, row in kernel_bucket(pf, dev, a, peak_flops, peak_bw).items():
            per[k].append(row)
    return headline_rows(per, KERNELS, "painn_fused", ("B",))


def headline_rows(per: dict, kernels: dict, source: str, with_gw_split: tuple) -> dict:
    """The kernels line's row of each kernel: numbers at A=HEADLINE_A, except
    max_abs_err, the largest over all buckets; `per_bucket` holds each
    bucket's. `with_gw_split` kernels also carry their without-gW times."""
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "flops", "bytes", "roofline_share")
    keep_gw = ("ms_without_gw", "plain_ms_without_gw", "bound_ms_without_gw",
               "roofline_share_without_gw")
    rows = {}
    for k, (name, line) in kernels.items():
        extra = keep_gw if k in with_gw_split else ()
        head = next(r for r in per[k] if r["shape"][1] == HEADLINE_A)
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


def schnet_kernel_bucket(sf, dev, a: int, peak_flops: float, peak_bw: float):
    """Kernels E-H at (KB, a, KR, KF) against their plain versions: errors
    (checked), and kernel / plain / bound times. F is checked and timed with
    the weight gradient and without it (as the predict and force paths run
    it); H with it (as training runs it), twice, for the same bits."""
    x = schnet_kernel_inputs(dev, a)
    shape = [KB, a, KR, KF]
    rows = {}

    def emit_row(key, row, t_k, t_p, **more):
        row["dynamic_smem_bytes"] = sf.smem_bytes(key, a, KR, KF)
        emit(f"kernel_{key}", **row, tolerance_rel=KERNEL_RTOL, kernel_times=t_k,
             plain_times=t_p, **more)
        rows[key] = row

    args = [x[k] for k in E_ARGS]
    err = compare([sf.schnet_fwd(*args)], [sf.schnet_message_reference(*args)])
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel E error at {shape}: {err}")
    t_k = time_ms(lambda: sf.schnet_fwd(*args))
    t_p = time_ms(lambda: sf.schnet_message_reference(*args))
    emit_row("E", _kernel_row(shape, err, t_k, t_p,
                              *sf.schnet_fwd_flops_bytes(x["rbf"], x["envf"], KF),
                              peak_flops, peak_bw), t_k, t_p)

    args = [x[k] for k in F_ARGS]
    got = sf.schnet_bwd(*args)
    err = compare(got, sf.schnet_message_bwd_reference(*args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel F error at {shape}: {err}")
    got_ng = sf.schnet_bwd(*args, need_gw=False)
    check(got_ng[2:] == (None,) * 4 and all(torch.equal(p, q) for p, q in zip(got_ng[:2], got)),
          "kernel F without gW gives the same node and pair cotangents")
    err_ng = compare(got_ng[:2], sf.schnet_message_bwd_reference(*args, need_gw=False)[:2])
    check(err_ng["max_rel_err"] <= KERNEL_RTOL, f"kernel F (no gW) error at {shape}: {err_ng}")
    flops_ng, nbytes_ng = sf.schnet_bwd_flops_bytes(x["rbf"], x["envf"], x["envp"], KF,
                                                    need_gw=False)
    b_ms_ng, b_by_ng = bound(flops_ng, nbytes_ng, peak_flops, peak_bw)
    t_k = time_ms(lambda: sf.schnet_bwd(*args))
    t_p = time_ms(lambda: sf.schnet_message_bwd_reference(*args))
    t_k_ng = time_ms(lambda: sf.schnet_bwd(*args, need_gw=False))
    t_p_ng = time_ms(lambda: sf.schnet_message_bwd_reference(*args, need_gw=False))
    emit_row("F", _kernel_row(
        shape, err, t_k, t_p, *sf.schnet_bwd_flops_bytes(x["rbf"], x["envf"], x["envp"], KF),
        peak_flops, peak_bw, max_abs_err_without_gw=err_ng["max_abs_err"],
        ms_without_gw=t_k_ng["median"], plain_ms_without_gw=t_p_ng["median"],
        bound_ms_without_gw=b_ms_ng, bound_by_without_gw=b_by_ng, flops_without_gw=flops_ng,
        roofline_share_without_gw=b_ms_ng / t_k_ng["median"]), t_k, t_p,
        kernel_times_without_gw=t_k_ng, plain_times_without_gw=t_p_ng)

    args = [x[k] for k in G_ARGS]
    err = compare(sf.schnet_dual_fwd(*args), sf.schnet_dual_fwd_reference(*args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel G error at {shape}: {err}")
    t_k = time_ms(lambda: sf.schnet_dual_fwd(*args))
    t_p = time_ms(lambda: sf.schnet_dual_fwd_reference(*args))
    emit_row("G", _kernel_row(
        shape, err, t_k, t_p, *sf.schnet_dual_fwd_flops_bytes(x["rbf"], x["envf"], x["envfd"], KF),
        peak_flops, peak_bw), t_k, t_p)

    args = [x[k] for k in H_ARGS]
    got = sf.schnet_dual_bwd(*args)
    err = compare(got, sf.schnet_dual_bwd_reference(*args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel H error at {shape}: {err}")
    again = sf.schnet_dual_bwd(*args)
    check(all(torch.equal(p, q) for p, q in zip(got, again)), f"kernel H deterministic at {shape}")
    no_gw = sf.schnet_dual_bwd(*args, need_gw=False)
    check(all(torch.equal(p, q) for p, q in zip(no_gw[:2], got)),
          "kernel H without gW gives the same node cotangents")
    t_k = time_ms(lambda: sf.schnet_dual_bwd(*args))
    t_p = time_ms(lambda: sf.schnet_dual_bwd_reference(*args))
    emit_row("H", _kernel_row(
        shape, err, t_k, t_p, *sf.schnet_dual_bwd_flops_bytes(x["rbf"], x["envf"], x["envfd"], KF),
        peak_flops, peak_bw, bit_identical_rerun=True), t_k, t_p)
    return rows


def schnet_kernel_phases(dev, card: str) -> dict:
    """Kernels E-H at every bucket shape of SchNet's predict and train paths
    (the kernels line's numbers as in kernel_phases)."""
    from nabladft_tpu_torch.ops import schnet_fused as sf

    peak_flops, peak_bw = peaks(card)
    per = {k: [] for k in SCHNET_KERNELS}
    for a in BUCKETS:
        for k, row in schnet_kernel_bucket(sf, dev, a, peak_flops, peak_bw).items():
            per[k].append(row)
    return headline_rows(per, SCHNET_KERNELS, "schnet_fused", ("F",))


def rotation(seed: int = 5) -> np.ndarray:
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


# the two model families chip_smoke drives: config, kernel module, launch
# counters (forward, backward, backward's gW stage, dual forward, dual
# backward) and the prefix of their phase names
FAMILIES = {
    "painn": dict(config="painn-oc", ops="painn_fused", prefix="",
                  counters=("painn_fwd", "painn_bwd", "painn_bwd_gw", "painn_dual_fwd",
                            "painn_dual_bwd")),
    "schnet": dict(config="schnet", ops="schnet_fused", prefix="schnet_",
                   counters=("schnet_fwd", "schnet_bwd", "schnet_bwd_gw", "schnet_dual_fwd",
                             "schnet_dual_bwd")),
}


def reset_all_launches() -> None:
    from nabladft_tpu_torch.ops import painn_fused, schnet_fused

    painn_fused.reset_launches()
    schnet_fused.reset_launches()


def all_launches() -> dict:
    from nabladft_tpu_torch.ops import painn_fused, schnet_fused

    return {**painn_fused.LAUNCHES, **schnet_fused.LAUNCHES}


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

    profile_phase(fam["prefix"] + "profile", gpu, dm)
    emit(fam["prefix"] + "predict", config=fam["config"], rows=res["rows"], batches=n_batches,
         batch_shapes=shapes, launches=launches, run_seconds=res["seconds"],
         cpu_ref_molecules=len(e_ref), cpu_ref_max_energy_abs_err=e_err,
         cpu_ref_max_force_abs_err=f_err,
         molecules_per_second={"median": rates[PASSES // 2], "min": rates[0],
                               "max": rates[-1], "passes": rates},
         peak_device_memory_bytes=peak_mem, rotation_ok=True,
         tolerances={"energy": E_TOL, "forces": F_TOL})
    return launches


def profile_phase(phase: str, trainer, dm, n_batches: int = 2, top: int = 12) -> None:
    """torch.profiler over `n_batches` predict steps (bucket 32): device time
    by kernel, and the device's busy share of the wall time."""
    batches = list(itertools.islice(dm.predict_dataloader(), n_batches))
    profile_steps(phase, trainer._predict_step, batches, top)


def profile_steps(phase: str, step, batches, top: int = 12) -> None:
    """torch.profiler over `step` on each batch: device time by kernel, and
    the device's busy share of the wall time."""
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
    emit(phase, batches=len(batches), batch_shapes=[list(b.z.shape) for b in batches],
         wall_ms=wall_us / 1e3, device_ms=device_us / 1e3,
         device_busy_share=device_us / wall_us,
         top=[{"name": k[:80], "device_ms": t / 1e3, "share": t / max(device_us, 1e-9),
               "calls": c} for k, t, c in events[:top]])


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
    profile_steps(fam["prefix"] + "train_profile", trainer._train_step, batches)
    emit(fam["prefix"] + "train", config=fam["config"], steps=steps, batches_per_epoch=n_train,
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
        worst, worst_name = 0.0, None
        for (n, p), (_, q) in zip(fused.model.named_parameters(), plain.model.named_parameters()):
            ratio = float((p.grad - q.grad).abs().max()) / max(float(q.grad.abs().max()), 1e-30)
            if ratio > worst:
                worst, worst_name = ratio, n
        check(worst <= GRAD_RTOL, f"gradient check at A={a}: {worst_name} off by {worst:.3e}")
        check(abs(float(lf["total"]) - float(lp["total"])) <= 1e-4 * abs(float(lp["total"])),
              f"loss at A={a}: {float(lf['total'])} vs {float(lp['total'])}")
        out.append({"shape": list(batch.z.shape), "max_rel_grad_err": worst,
                    "worst_param": worst_name, "loss_kernel": float(lf["total"]),
                    "loss_plain": float(lp["total"])})
    check(sorted(first) == list(BUCKETS), f"gradient check buckets {sorted(first)}")
    return out


ALL_KERNELS = {"A": "painn_fwd", "B": "painn_bwd", "C": "painn_dual_fwd", "D": "painn_dual_bwd",
               "E": "schnet_fwd", "F": "schnet_bwd", "G": "schnet_dual_fwd",
               "H": "schnet_dual_bwd"}  # kernel -> its launch counter


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
    sources = ("painn_fused", "schnet_fused")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        builds = dict(zip(sources, pool.map(_kernels.build, sources)))
    seconds["build"] = time.perf_counter() - t0
    emit("env", device=card, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc_version,
         build_seconds=seconds["build"],
         build_seconds_by_source={k: v["seconds"] for k, v in builds.items()},
         ptxas={k: ptxas_summary(v["log"]) for k, v in builds.items()})

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    dev = torch.device("cuda")
    rows = timed("kernels_painn", kernel_phases, dev, card)
    rows.update(timed("kernels_schnet", schnet_kernel_phases, dev, card))
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        db = timed("db_write", write_random_db, tmp / "smoke.db", N_MOLS, MIN_ATOMS, MAX_ATOMS,
                   SEED)
        for family in FAMILIES:
            for job, phase in (("predict", predict_phase), ("train", train_phase)):
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
