"""The same measurements from several checkouts of this repository, run in
turn on one card, to compare two versions within one machine.

    python3 tools/compare_trees.py steps --roots _trees/parent . . _trees/parent \
        --out _trees/steps.jsonl
    python3 tools/compare_trees.py bits --roots _trees/parent . --out _trees/bits

Each root runs in a process of its own, with that root's `nabladft_tpu_torch`
and `chip_smoke.py` first on the path.

`steps`: PaiNN's predict and train steps over the seeded DB of chip_smoke.py's
PaiNN phases (configs/painn-oc.yaml at full width, batch 64, buckets
32/48/64). Per root it measures:

- predict molecules/s: PASSES timed passes of the predict loop over the 256
  molecules after a warm-up pass (as chip_smoke.py's `predict`);
- train molecules/s: every step of EPOCHS epochs over the train split after
  a warm-up epoch (a step ends on the trainer's host read of the gradient
  norm, so its time is the card's and the host's together), and each
  epoch's molecules over its steps' seconds;
- the wall ms of two train steps and of two predict steps without the
  profiler (median of REPEATS), then the wall and device ms of the same
  steps under torch.profiler (as chip_smoke.py's `train_profile` / `profile`);
- the host time of each call of kernel B's and kernel D's wrappers
  (`painn_bwd`, `painn_dual_bwd`: from the call to its return, the card not
  waited for) over the timed train epochs, and of A's and C's for scale;
- peak device memory of the predict passes and of the train epochs.

Prints one JSON line per root, in the order run, and writes them to --out.

`bits`: kernels I-P at A=48 on chip_smoke.py's seeded inputs (QHNet B=8,
eSCN and EquiformerV2 B=64, full widths): each root saves every output under
--out, and the last line says, per kernel, whether every root gave the
first root's bits.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PASSES, EPOCHS, REPEATS = 7, 4, 5
WRAPPERS = ("painn_fwd", "painn_bwd", "painn_dual_fwd", "painn_dual_bwd")


def _stats(xs: list) -> dict:
    xs = sorted(xs)
    return {"median": statistics.median(xs), "min": xs[0], "max": xs[-1], "n": len(xs)}


def _timed_wrappers(pf) -> dict:
    """Replace A-D's wrappers in `pf` (the module the autograd Functions call
    them through) by ones that record their host time in µs."""
    times = {name: [] for name in WRAPPERS}

    def wrap(name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            times[name].append((time.perf_counter() - t0) * 1e6)
            return out
        return timed

    for name in WRAPPERS:
        setattr(pf, name, wrap(name, getattr(pf, name)))
    return times


def _profiled(torch, step, batches) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            step(batch.to("cuda"))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms}


def _wall(torch, step, batches) -> dict:
    walls = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            step(batch.to("cuda"))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return _stats(walls)


def _import_root(root: Path):
    """chip_smoke and nabladft_tpu_torch of `root` (checked)."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import nabladft_tpu_torch

    pkg = Path(nabladft_tpu_torch.__file__).resolve().parent.parent
    if pkg != root.resolve() or Path(cs.__file__).resolve().parent != root.resolve():
        raise RuntimeError(f"imported {pkg} and {cs.__file__}, not {root}")
    return cs


def bits_child(root: Path, out: Path) -> dict:
    """Kernels I-P's outputs at A=48 on chip_smoke's seeded inputs, saved to
    out/<n>.pt (n: this root's place in --roots)."""
    import torch

    cs = _import_root(root)
    from nabladft_tpu_torch.ops import eqv2_attn as ea
    from nabladft_tpu_torch.ops import escn_layer as el
    from nabladft_tpu_torch.ops import qhnet_tp as qt

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, a, res = torch.device("cuda"), cs.HEADLINE_A, {}
    as_tuple = (lambda t: t if isinstance(t, tuple) else (t,))  # noqa: E731
    x = cs.qhnet_kernel_inputs(dev, cs.QH_BATCH, a, cs.QH_C, seed=cs.SEED + 2000 + a)
    for k, fn in (("I", qt.qhnet_conv_fwd), ("J", qt.qhnet_conv_bwd), ("K", qt.qhnet_pair_fwd),
                  ("L", qt.qhnet_pair_bwd)):
        res[k] = [t.cpu() for t in as_tuple(fn(*[x[n] for n in cs.QH_ARGS[k]]))]
    x = cs.escn_kernel_inputs(dev, cs.BATCH, a, seed=cs.SEED + 3000 + a)
    args, dims = (x["x"], x["d"], x["xe"], *x["ws"]), x["dims"]
    res["M"] = [t.cpu() for t in as_tuple(el.escn_fwd(*args, **dims))]
    res["N"] = [t.cpu() for t in as_tuple(el.escn_bwd(*args, g=x["g"], **dims))]
    del x, args
    inp = cs.eqv2_kernel_inputs(dev, cs.BATCH, a, seed=cs.SEED + 4000 + a, drop=True)
    args, dims = cs._eqv2_args(inp), inp["dims"]
    res["O"] = [t.cpu() for t in as_tuple(ea.eqv2_fwd(*args, **dims))]
    res["P"] = [t.cpu() for t in as_tuple(ea.eqv2_bwd(*args, g=inp["g"], **dims))]
    torch.save(res, out)
    return {"root": str(root), "saved": str(out), "shapes": {
        k: [list(t.shape) for t in v] for k, v in res.items()}}


def child(root: Path) -> dict:
    import torch

    cs = _import_root(root)
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data.synthetic import write_random_db
    from nabladft_tpu_torch.ops import _kernels
    from nabladft_tpu_torch.ops import painn_fused as pf
    from nabladft_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _kernels.build("painn_fused")
    build_s = time.perf_counter() - t0
    out = {"root": str(root), "build_seconds": build_s}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        db = write_random_db(tmp / "smoke.db", cs.N_MOLS, cs.MIN_ATOMS, cs.MAX_ATOMS, cs.SEED)
        cfg = cs.smoke_config(str(db), str(tmp / "pred.db"), str(tmp))
        dm = pipelines.build_datamodule(cfg)
        gpu = Trainer(pipelines.build_model(cfg, torch.device("cuda")))
        if gpu.model.use_pallas != "fused":
            raise RuntimeError("the card runs the fused kernels")
        torch.cuda.reset_peak_memory_stats()
        rates = []
        for p in range(PASSES + 1):
            t0 = time.perf_counter()
            n = sum(len(o["energy"]) for o in gpu.predict(dm.predict_dataloader()))
            torch.cuda.synchronize()
            if p:
                rates.append(n / (time.perf_counter() - t0))
        out["predict_mol_s"] = _stats(rates)
        out["predict_mol_s_passes"] = rates
        out["predict_peak_bytes"] = torch.cuda.max_memory_allocated()
        batches = list(itertools.islice(dm.predict_dataloader(), 2))
        out["predict_2steps_wall_ms"] = _wall(torch, gpu._predict_step, batches)
        out["predict_2steps_profiled"] = _profiled(torch, gpu._predict_step, batches)
        del gpu

        tcfg = cs.train_config(str(db), str(tmp), str(tmp / "ckpt"), str(tmp / "out"))
        tdm = pipelines.build_datamodule(tcfg)
        trainer = pipelines.build_trainer(dict(tcfg, log_csv=False, ckpt_dir=None),
                                          torch.device("cuda"))
        times = _timed_wrappers(pf)
        torch.cuda.reset_peak_memory_stats()
        step_rates, epoch_rates = [], []
        for epoch in range(EPOCHS + 1):
            if epoch == 1:
                for v in times.values():
                    v.clear()
            mols_epoch, seconds_epoch = 0, 0.0
            for batch in tdm.train_dataloader():
                mols = int(batch.graph_mask.sum())
                t0 = time.perf_counter()
                trainer._train_step(batch.to("cuda"))
                dt = time.perf_counter() - t0
                if epoch:
                    step_rates.append(mols / dt)
                    mols_epoch, seconds_epoch = mols_epoch + mols, seconds_epoch + dt
            if epoch:
                epoch_rates.append(mols_epoch / seconds_epoch)
        torch.cuda.synchronize()
        out["train_mol_s"] = _stats(step_rates)
        # an epoch's molecules over its steps' seconds: every batch counted once
        out["train_mol_s_by_epoch"] = _stats(epoch_rates)
        out["train_peak_bytes"] = torch.cuda.max_memory_allocated()
        out["host_us_per_call"] = {k: _stats(v) for k, v in times.items() if v}
        batches = list(itertools.islice(tdm.train_dataloader(), 2))
        out["train_2steps_wall_ms"] = _wall(torch, trainer._train_step, batches)
        out["train_2steps_profiled"] = _profiled(torch, trainer._train_step, batches)
        out["batch_shapes"] = [list(b.z.shape) for b in batches]
    return out


# end-to-end metrics of `steps`: (name, how to read it from a run, True if higher is better)
METRICS = (
    ("predict_mol_s", lambda r: r["predict_mol_s"]["median"], True),
    ("train_mol_s", lambda r: r["train_mol_s_by_epoch"]["median"], True),
    ("predict_2steps_wall_ms", lambda r: r["predict_2steps_wall_ms"]["median"], False),
    ("train_2steps_wall_ms", lambda r: r["train_2steps_wall_ms"]["median"], False),
    ("predict_2steps_device_ms", lambda r: r["predict_2steps_profiled"]["device_ms"], False),
    ("train_2steps_device_ms", lambda r: r["train_2steps_profiled"]["device_ms"], False),
    ("host_us_painn_bwd", lambda r: r["host_us_per_call"]["painn_bwd"]["median"], False),
    ("host_us_painn_dual_bwd", lambda r: r["host_us_per_call"]["painn_dual_bwd"]["median"],
     False),
)


def _quartiles(xs: list) -> dict:
    xs = sorted(xs)
    q = statistics.quantiles(xs, n=4, method="inclusive") if len(xs) > 1 else xs * 3
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2], "runs": xs}


def summary(runs: list) -> dict:
    """Per metric: each root's runs (median, quartiles) and, over the pairs
    of consecutive runs of two different roots (runs 0-1, 2-3, ...), how
    often the root that is not the first one read better."""
    roots = list(dict.fromkeys(r["root"] for r in runs))
    out = {}
    for name, get, higher in METRICS:
        m = {root: _quartiles([get(r) for r in runs if r["root"] == root]) for root in roots}
        wins = pairs = 0
        for a, b in zip(runs[::2], runs[1::2]):
            if a["root"] == b["root"]:
                continue
            first, other = (a, b) if a["root"] == roots[0] else (b, a)
            pairs += 1
            wins += (get(other) > get(first)) if higher else (get(other) < get(first))
        m["pairs"], m["wins_of_" + (roots[-1] if len(roots) > 1 else roots[0])] = pairs, wins
        out[name] = m
    return out


def _same_bits(files: list) -> dict:
    import torch

    runs = [torch.load(f) for f in files]
    return {k: all(len(r[k]) == len(runs[0][k]) and all(
        torch.equal(p, q) for p, q in zip(r[k], runs[0][k])) for r in runs[1:])
        for k in runs[0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("steps", "bits"))
    ap.add_argument("--roots", nargs="+", help="checkouts to run, in this order")
    ap.add_argument("--out", default=None,
                    help="steps: also write the JSON lines here; bits: the directory of "
                         "the saved outputs")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--save", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        root = Path(args.child)
        res = bits_child(root, Path(args.save)) if args.mode == "bits" else child(root)
        print(json.dumps(res), flush=True)
        return 0
    if args.mode == "bits" and not args.out:
        ap.error("bits needs --out")
    lines, saved = [], []
    for n, root in enumerate(args.roots):
        cmd = [sys.executable, __file__, args.mode, "--child", str(Path(root).resolve())]
        if args.mode == "bits":
            Path(args.out).mkdir(parents=True, exist_ok=True)
            saved.append(Path(args.out) / f"{n}.pt")
            cmd += ["--save", str(saved[-1])]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        lines.append(proc.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    if args.mode == "bits":
        same = _same_bits(saved)
        print(json.dumps({"same_bits_as_first_root": same}), flush=True)
        return 0 if all(same.values()) else 1
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    print(json.dumps({"summary": summary([json.loads(x) for x in lines])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
