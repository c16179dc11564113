#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: kernels, then the predict job.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the repository
checkout; no network and no PyYAML. Phases, each printing one JSON line:

  1. env     — device, torch / CUDA / nvcc versions, the card's name and
               power limit; builds the kernels from csrc/ (build seconds).
  2. kernel A (painn_fwd) and 3. kernel B (painn_bwd, with and without the
               weight gradient) at each of the predict path's shapes
               (B=64, A=32/48/64, R=100, F=128, fp32, ~30% of pairs masked),
               one line per shape: error against the plain PyTorch version,
               and the kernel's, the plain version's and the bound's times
               (CUDA events, median / min / max of 25 runs after warm-up).
  4. predict — `pipelines.run` of ``job_type: predict`` on configs/painn-oc.yaml
               at full width and depth (hidden 128, 6 interactions, 100 RBF),
               batch 64, buckets 32/48/64, over a seeded DB of 256 molecules
               (8-62 atoms, H C N O F S Cl); checks rows, finiteness, launch
               counts (A and B 6x per batch), every batch against the CPU
               plain path, rotation invariance / equivariance; molecules/s
               (median / min / max of 7 passes after a warm-up pass).
     profile — torch.profiler over two predict steps: device time by
               kernel and the device's busy share (printed before predict).
  5. kernels — one JSON object describing every ported kernel.
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
# kernel phase shapes: every (B, A) the predict path gives the kernels (each
# batch is padded to B=64 molecules of its bucket's A atoms); the kernels
# line's times are those at A=HEADLINE_A
KB, KR, KF, HEADLINE_A = BATCH, 100, 128, 48
RUNS, WARMUP = 25, 3
PASSES = 7  # timed passes of the predict loop, after one warm-up pass
# Kernel vs plain version, both fp32 on the card with sums in another
# order: max |err| <= KERNEL_RTOL * max |plain| per output.
KERNEL_RTOL = 2e-5
# GPU fused path vs the CPU plain path, and rotated vs unrotated inputs:
# the model-level tolerances of the CPU parity tests.
E_TOL = dict(rtol=2e-4, atol=1e-5)
F_TOL = dict(rtol=2e-3, atol=2e-4)

# Published dense peaks (NVIDIA data sheets, full power limit): fp32 FLOP/s
# outside the tensor cores, and memory bytes/s.
PEAKS = {
    "H100 PCIe": (51e12, 2.0e12),
    "H100 NVL": (60e12, 3.9e12),
    "H100": (67e12, 3.35e12),  # SXM5 (e.g. "NVIDIA H100 80GB HBM3")
    "H200": (67e12, 4.8e12),
}


def smoke_config(source: str, output_db: str, root: str) -> dict:
    """configs/painn-oc.yaml composed with job_type=predict,
    datamodule.source/root and output_db (the test suite checks this equals
    `load_config` of the file with those overrides; no PyYAML here)."""
    return {
        "name": "painn-oc",
        "job_type": "predict",
        "seed": 42,
        "dataset_name": "dataset_train_tiny",
        "ckpt_dir": "checkpoints/painn-oc",
        "output_dir": "outputs",
        "model": {
            "name": "painn",
            "kwargs": {"hidden": 128, "n_interactions": 6, "n_rbf": 100, "cutoff": 5.0,
                       "max_neighbors": 63, "rbf": "gaussian", "envelope": "polynomial",
                       "envelope_exponent": 5},
            "loss_specs": {"energy": "l1", "forces": "l2norm"},
            "loss_coefs": {"energy": 1.0, "forces": 1.0},
        },
        "trainer": {
            "max_epochs": 100, "optimizer": "adamw", "lr": 0.0001, "weight_decay": 0.0,
            "grad_clip": 10.0, "schedule": "plateau", "plateau_factor": 0.8,
            "plateau_patience": 10, "plateau_min_lr": 1e-06, "log_every_n_steps": 50,
            "save_top_k": 3, "monitor": "val/loss", "early_stopping_patience": 50, "seed": 42,
        },
        "datamodule": {"kind": "energy", "source": source, "root": root, "batch_size": BATCH,
                       "val_fraction": 0.1, "bucket_boundaries": list(BUCKETS)},
        "output_db": output_db,
    }


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
    """{kernel: {"registers": n, "spill": "..."}} from nvcc -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?_kernel)", line)  # <file>_cu_<hash><len><name>
        if m and ("entry function" in line or "properties for" in line):
            name = m.group(1)
            out.setdefault(name, {})
        elif name and "spill stores" in line:
            out[name]["spill"] = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
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
    return {k: t.to(dev).contiguous() for k, t in cpu.items()}


def bound(flops: int, nbytes: int, peak_flops: float, peak_bw: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_bucket(pf, dev, a: int, peak_flops: float, peak_bw: float):
    """Kernels A and B at (KB, a, KR, KF) against their plain versions: errors
    (checked), and kernel / plain / bound times. B is checked and timed both
    with the weight gradient and without it, as the predict path runs it."""
    x = kernel_inputs(dev, a)
    a_args = [x[k] for k in ("rbf", "phi", "v", "unit_t", "w")]
    b_args = [x[k] for k in ("rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv")]
    shape = [KB, a, KR, KF]

    err = compare(pf.painn_fwd(*a_args), pf.painn_message_reference(*a_args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel A error at {shape}: {err}")
    flops, nbytes = pf.painn_fwd_flops_bytes(x["rbf"], KF)
    b_ms, b_by = bound(flops, nbytes, peak_flops, peak_bw)
    t_k = time_ms(lambda: pf.painn_fwd(*a_args))
    t_p = time_ms(lambda: pf.painn_message_reference(*a_args))
    row_a = dict(shape=shape, **err, ms=t_k["median"], plain_ms=t_p["median"], bound_ms=b_ms,
                 bound_by=b_by, flops=flops, bytes=nbytes, roofline_share=b_ms / t_k["median"])
    emit("kernel_A", **row_a, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p)

    got = pf.painn_bwd(*b_args)
    err = compare(got, pf.painn_message_bwd_reference(*b_args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel B error at {shape}: {err}")
    got_ng = pf.painn_bwd(*b_args, need_gw=False)
    check(got_ng[4] is None and all(torch.equal(p, q) for p, q in zip(got_ng[:4], got[:4])),
          "kernel B without gW gives the same node and pair cotangents")
    err_ng = compare(got_ng[:4], pf.painn_message_bwd_reference(*b_args, need_gw=False)[:4])
    check(err_ng["max_rel_err"] <= KERNEL_RTOL, f"kernel B (no gW) error at {shape}: {err_ng}")
    flops, nbytes = pf.painn_bwd_flops_bytes(x["rbf"], KF)
    b_ms, b_by = bound(flops, nbytes, peak_flops, peak_bw)
    flops_ng, nbytes_ng = pf.painn_bwd_flops_bytes(x["rbf"], KF, need_gw=False)
    b_ms_ng, b_by_ng = bound(flops_ng, nbytes_ng, peak_flops, peak_bw)
    t_k = time_ms(lambda: pf.painn_bwd(*b_args))
    t_p = time_ms(lambda: pf.painn_message_bwd_reference(*b_args))
    t_k_ng = time_ms(lambda: pf.painn_bwd(*b_args, need_gw=False))
    t_p_ng = time_ms(lambda: pf.painn_message_bwd_reference(*b_args, need_gw=False))
    row_b = dict(shape=shape, **err, ms=t_k["median"], plain_ms=t_p["median"], bound_ms=b_ms,
                 bound_by=b_by, flops=flops, bytes=nbytes, roofline_share=b_ms / t_k["median"],
                 max_abs_err_without_gw=err_ng["max_abs_err"],
                 ms_without_gw=t_k_ng["median"], plain_ms_without_gw=t_p_ng["median"],
                 bound_ms_without_gw=b_ms_ng, bound_by_without_gw=b_by_ng,
                 flops_without_gw=flops_ng, roofline_share_without_gw=b_ms_ng / t_k_ng["median"])
    emit("kernel_B", **row_b, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p,
         kernel_times_without_gw=t_k_ng, plain_times_without_gw=t_p_ng)
    return row_a, row_b


def kernel_phases(dev, card: str) -> dict:
    """Kernels A and B at every bucket shape of the predict path. The kernels
    line's numbers are those at A=HEADLINE_A, except max_abs_err, the largest
    over all buckets; `per_bucket` holds each bucket's."""
    from nabladft_tpu_torch.ops import painn_fused as pf

    peak_flops, peak_bw = peaks(card)
    per = {"A": [], "B": []}
    for a in BUCKETS:
        row_a, row_b = kernel_bucket(pf, dev, a, peak_flops, peak_bw)
        per["A"].append(row_a)
        per["B"].append(row_b)
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "flops", "bytes", "roofline_share")
    keep_b = ("ms_without_gw", "plain_ms_without_gw", "bound_ms_without_gw",
              "roofline_share_without_gw")
    rows = {}
    for k, name, line in (("A", "painn_fwd (A)", 114), ("B", "painn_bwd (B)", 177)):
        head = next(r for r in per[k] if r["shape"][1] == HEADLINE_A)
        rows[k] = dict(
            name=name, route="cuda", source="nabladft_tpu_torch/csrc/painn_fused.cu",
            replaces=f"nabladft_tpu/ops/pallas/painn_fused.py:{line}",
            max_abs_err=max(r["max_abs_err"] for r in per[k]), library_ms=None,
            timed_shape=head["shape"],
            **{f: head[f] for f in keep + (keep_b if k == "B" else ())},
            per_bucket=[{f: r[f] for f in ("shape", "max_abs_err", "max_rel_err") + keep
                         + (keep_b if k == "B" else ())} for r in per[k]],
        )
    return rows


def rotation(seed: int = 5) -> np.ndarray:
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


def predict_phase(tmp: Path) -> dict:
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data.ase_codec import AseDatabase
    from nabladft_tpu_torch.data.synthetic import write_random_db
    from nabladft_tpu_torch.models.base import forward
    from nabladft_tpu_torch.ops import painn_fused as pf
    from nabladft_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    db = write_random_db(tmp / "smoke.db", N_MOLS, MIN_ATOMS, MAX_ATOMS, seed=SEED)
    t_db = time.perf_counter() - t0
    cfg = smoke_config(str(db), str(tmp / "predictions.db"), str(tmp))

    # the main path: counts reset just before, read just after
    pf.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = pipelines.run(cfg)
    torch.cuda.synchronize()
    launches = dict(pf.LAUNCHES)
    peak_mem = torch.cuda.max_memory_allocated()

    n_batches = res["batches"]
    n_layers = cfg["model"]["kwargs"]["n_interactions"]
    check(res["rows"] == N_MOLS, f"rows written {res['rows']} != {N_MOLS}")
    for k in ("painn_fwd", "painn_bwd"):
        check(launches[k] == n_layers * n_batches,
              f"{k} launched {launches[k]} times, expected {n_layers} x {n_batches} batches")
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

    profile_phase(gpu, dm)
    emit("predict", rows=res["rows"], batches=n_batches, batch_shapes=shapes, launches=launches,
         run_seconds=res["seconds"], db_write_seconds=t_db,
         cpu_ref_molecules=len(e_ref), cpu_ref_max_energy_abs_err=e_err,
         cpu_ref_max_force_abs_err=f_err,
         molecules_per_second={"median": rates[PASSES // 2], "min": rates[0],
                               "max": rates[-1], "passes": rates},
         peak_device_memory_bytes=peak_mem, rotation_ok=True,
         tolerances={"energy": E_TOL, "forces": F_TOL})
    return launches


def profile_phase(trainer, dm, n_batches: int = 2, top: int = 12) -> None:
    """torch.profiler over `n_batches` predict steps (bucket 32): device time
    by kernel, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    batches = list(itertools.islice(dm.predict_dataloader(), n_batches))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            trainer._predict_step(batch.to("cuda"))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: a CPU op's self device time repeats its kernels'
    events = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(t for _, t, _ in events)
    events.sort(key=lambda e: -e[1])
    emit("profile", batches=n_batches, wall_ms=wall_us / 1e3, device_ms=device_us / 1e3,
         device_busy_share=device_us / wall_us,
         top=[{"name": k[:80], "device_ms": t / 1e3, "share": t / max(device_us, 1e-9),
               "calls": c} for k, t, c in events[:top]])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nabladft_tpu_torch.ops import _kernels

    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    nvcc_version = subprocess.run([_kernels.nvcc(), "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    build = _kernels.build("painn_fused")
    emit("env", device=card, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc_version,
         build_seconds=time.perf_counter() - t0, ptxas=ptxas_summary(build["log"]))

    rows = kernel_phases(torch.device("cuda"), card)
    with tempfile.TemporaryDirectory() as tmp:
        launches = predict_phase(Path(tmp))
    rows["A"]["launches"] = launches["painn_fwd"]
    rows["B"]["launches"] = launches["painn_bwd"]
    print(json.dumps({"kernels": [rows["A"], rows["B"]]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
