"""The same measurements from several checkouts of this repository, run in
turn on one card, to compare two versions within one machine.

    python3 tools/compare_trees.py steps --family schnet \
        --roots _trees/parent . . _trees/parent --out _trees/steps.jsonl
    python3 tools/compare_trees.py kernels --family schnet --roots _trees/parent .
    python3 tools/compare_trees.py bits --roots _trees/parent . --out _trees/bits \
        --changed A C

Each root runs in a process of its own, with that root's `nabladft_tpu_torch`
and `chip_smoke.py` first on the path.

`steps`: one family's predict and train steps (`--family` painn, the default,
or schnet) over the seeded DB of chip_smoke.py's phases (configs/painn-oc.yaml
or configs/schnet.yaml at full width, batch 64, buckets 32/48/64). Per root
it measures:

- predict molecules/s: PASSES timed passes of the predict loop over the 256
  molecules after a warm-up pass (as chip_smoke.py's `predict`);
- train molecules/s: every step of EPOCHS epochs over the train split after
  a warm-up epoch (a step ends on the trainer's host read of the gradient
  norm, so its time is the card's and the host's together), and each
  epoch's molecules over its steps' seconds;
- the wall ms of two train steps and of two predict steps without the
  profiler (median of REPEATS), then the wall and device ms of the same
  steps under torch.profiler (as chip_smoke.py's `train_profile` / `profile`);
- the host time of each call of the family's four kernel wrappers (PaiNN's
  A-D, SchNet's E-H: from the call to its return, the card not waited for)
  over the timed train epochs;
- peak device memory of the predict passes and of the train epochs.

Prints one JSON line per root, in the order run, and writes them to --out;
then a summary line over the runs.

`kernels`: one family's kernel lines of chip_smoke.py (painn, schnet, escn or eqv2: its `kernel_phases` or
`schnet_kernel_phases`: each kernel against its plain version at A=32/48/64)
per root; the last line gives each kernel's ms per bucket and root.

`bits`: kernels A-P at A=48 on chip_smoke.py's seeded inputs (PaiNN,
SchNet, eSCN and EquiformerV2 B=64, QHNet B=8, full widths; B, D, F and H
with gW): each root saves every output under --out, and the last line says,
per kernel, whether every root gave the first root's bits. The kernels named
by --changed (those the roots compute differently by design) are run twice
in each root instead, and must give the same bits there; every other kernel
must give the first root's bits. The exit code is 1 where either fails.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PASSES, EPOCHS, REPEATS = 7, 4, 5
# per family: its chip_smoke config, kernel module, kernel wrappers and kernel phase
FAMILIES = {
    "painn": ("painn-oc", "painn_fused",
              ("painn_fwd", "painn_bwd", "painn_dual_fwd", "painn_dual_bwd"), "kernel_phases"),
    "schnet": ("schnet", "schnet_fused",
               ("schnet_fwd", "schnet_bwd", "schnet_dual_fwd", "schnet_dual_bwd"),
               "schnet_kernel_phases"),
    # M-P: the kernels mode only
    "escn": ("escn-oc", "escn_layer", ("escn_fwd", "escn_bwd"), "escn_kernel_phases"),
    "eqv2": ("equiformer_v2", "eqv2_attn", ("eqv2_fwd", "eqv2_bwd"), "eqv2_kernel_phases"),
}


def _stats(xs: list) -> dict:
    xs = sorted(xs)
    return {"median": statistics.median(xs), "min": xs[0], "max": xs[-1], "n": len(xs)}


def _timed_wrappers(mod, wrappers) -> dict:
    """Replace the kernel wrappers in `mod` (the module the autograd
    Functions call them through) by ones that record their host time in µs."""
    times = {name: [] for name in wrappers}

    def wrap(name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            times[name].append((time.perf_counter() - t0) * 1e6)
            return out
        return timed

    for name in wrappers:
        setattr(mod, name, wrap(name, getattr(mod, name)))
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


def bits_child(root: Path, out: Path, changed: tuple) -> dict:
    """Kernels A-P's outputs at A=48 on chip_smoke's seeded inputs, saved to
    out/<n>.pt (n: this root's place in --roots); the `changed` kernels run
    twice, and the line says whether they gave the same bits."""
    import torch

    cs = _import_root(root)
    from nabladft_tpu_torch.ops import eqv2_attn as ea
    from nabladft_tpu_torch.ops import escn_layer as el
    from nabladft_tpu_torch.ops import painn_fused as pf
    from nabladft_tpu_torch.ops import qhnet_tp as qt
    from nabladft_tpu_torch.ops import schnet_fused as sf

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, a, res, rerun = torch.device("cuda"), cs.HEADLINE_A, {}, {}

    def run(k, fn, *args, **kw):
        def outputs():
            got = fn(*args, **kw)
            return [t.cpu() for t in (got if isinstance(got, tuple) else (got,)) if t is not None]
        res[k] = outputs()
        if k in changed:
            rerun[k] = all(torch.equal(p, q) for p, q in zip(res[k], outputs()))

    x = cs.kernel_inputs(dev, a)
    run("A", pf.painn_fwd, *[x[n] for n in ("rbf", "phi", "v", "unit_t", "w")])
    run("B", pf.painn_bwd, *[x[n] for n in (
        "rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv")])
    run("C", pf.painn_dual_fwd, *[x[n] for n in cs.C_ARGS])
    run("D", pf.painn_dual_bwd, *[x[n] for n in cs.D_ARGS])
    x = cs.schnet_kernel_inputs(dev, a)
    for k, fn, names in (("E", sf.schnet_fwd, cs.E_ARGS), ("F", sf.schnet_bwd, cs.F_ARGS),
                         ("G", sf.schnet_dual_fwd, cs.G_ARGS),
                         ("H", sf.schnet_dual_bwd, cs.H_ARGS)):
        run(k, fn, *[x[n] for n in names])
    x = cs.qhnet_kernel_inputs(dev, cs.QH_BATCH, a, cs.QH_C, seed=cs.SEED + 2000 + a)
    for k, fn in (("I", qt.qhnet_conv_fwd), ("J", qt.qhnet_conv_bwd), ("K", qt.qhnet_pair_fwd),
                  ("L", qt.qhnet_pair_bwd)):
        run(k, fn, *[x[n] for n in cs.QH_ARGS[k]])
    x = cs.escn_kernel_inputs(dev, cs.BATCH, a, seed=cs.SEED + 3000 + a)
    args, dims = (x["x"], x["d"], x["xe"], *x["ws"]), x["dims"]
    run("M", el.escn_fwd, *args, **dims)
    run("N", el.escn_bwd, *args, g=x["g"], **dims)
    del x, args
    inp = cs.eqv2_kernel_inputs(dev, cs.BATCH, a, seed=cs.SEED + 4000 + a, drop=True)
    args, dims = cs._eqv2_args(inp), inp["dims"]
    run("O", ea.eqv2_fwd, *args, **dims)
    run("P", ea.eqv2_bwd, *args, g=inp["g"], **dims)
    torch.save(res, out)
    return {"root": str(root), "saved": str(out), "same_bits_on_rerun": rerun, "shapes": {
        k: [list(t.shape) for t in v] for k, v in res.items()}}


def kernels_child(root: Path, family: str) -> dict:
    """The family's kernel lines of chip_smoke.py at every bucket."""
    import torch

    cs = _import_root(root)
    from nabladft_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    _, source, _, phase = FAMILIES[family]
    ptxas = {source: cs.ptxas_summary(_kernels.build(source)["log"])}
    fn = getattr(cs, phase)
    args = [torch.device("cuda"), torch.cuda.get_device_name(0)]
    if "ptxas" in inspect.signature(fn).parameters:
        args.append(ptxas)
    rows = fn(*args)
    keep = ("ms", "plain_ms", "ms_without_gw", "plain_ms_without_gw", "max_rel_err")
    return {"root": str(root), "family": family,
            "kernels": {k: [{"a": r["shape"][1], **{f: r[f] for f in keep if f in r}}
                            for r in row["per_bucket"]] for k, row in rows.items()}}


def child(root: Path, family: str) -> dict:
    import importlib

    import torch

    cs = _import_root(root)
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data.synthetic import write_random_db
    from nabladft_tpu_torch.ops import _kernels
    from nabladft_tpu_torch.train import Trainer

    config, source, wrappers, _ = FAMILIES[family]
    mod = importlib.import_module(f"nabladft_tpu_torch.ops.{source}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _kernels.build(source)
    build_s = time.perf_counter() - t0
    out = {"root": str(root), "family": family, "build_seconds": build_s}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        db = write_random_db(tmp / "smoke.db", cs.N_MOLS, cs.MIN_ATOMS, cs.MAX_ATOMS, cs.SEED)
        cfg = cs.smoke_config(str(db), str(tmp / "pred.db"), str(tmp), config=config)
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

        tcfg = cs.train_config(str(db), str(tmp), str(tmp / "ckpt"), str(tmp / "out"),
                               config=config)
        tdm = pipelines.build_datamodule(tcfg)
        trainer = pipelines.build_trainer(dict(tcfg, log_csv=False, ckpt_dir=None),
                                          torch.device("cuda"))
        times = _timed_wrappers(mod, wrappers)
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
    ("predict_peak_bytes", lambda r: r["predict_peak_bytes"], False),
    ("train_peak_bytes", lambda r: r["train_peak_bytes"], False),
)


def _metrics(family: str) -> tuple:
    """METRICS and the host µs of each call of the family's four wrappers."""
    def host(name):
        return lambda r: r["host_us_per_call"][name]["median"]
    return METRICS + tuple((f"host_us_{w}", host(w), False) for w in FAMILIES[family][2])


def _quartiles(xs: list) -> dict:
    xs = sorted(xs)
    q = statistics.quantiles(xs, n=4, method="inclusive") if len(xs) > 1 else xs * 3
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2], "runs": xs}


def summary(runs: list, family: str) -> dict:
    """Per metric: each root's runs (median, quartiles) and, over the pairs
    of consecutive runs of two different roots (runs 0-1, 2-3, ...), how
    often the root that is not the first one read better."""
    roots = list(dict.fromkeys(r["root"] for r in runs))
    out = {}
    for name, get, higher in _metrics(family):
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
    ap.add_argument("mode", choices=("steps", "kernels", "bits"))
    ap.add_argument("--family", choices=tuple(FAMILIES), default="painn",
                    help="steps, kernels: the model family")
    ap.add_argument("--roots", nargs="+", help="checkouts to run, in this order")
    ap.add_argument("--out", default=None,
                    help="steps: also write the JSON lines here; bits: the directory of "
                         "the saved outputs")
    ap.add_argument("--changed", nargs="*", default=[],
                    help="bits: kernels computed differently by design, held to their own "
                         "bits on a rerun in each root instead of to the first root's")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--save", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        root = Path(args.child)
        if args.mode == "bits":
            res = bits_child(root, Path(args.save), tuple(args.changed))
        elif args.mode == "kernels":
            res = kernels_child(root, args.family)
        else:
            res = child(root, args.family)
        print(json.dumps(res), flush=True)
        return 0
    if args.mode == "bits" and not args.out:
        ap.error("bits needs --out")
    lines, saved = [], []
    for n, root in enumerate(args.roots):
        cmd = [sys.executable, __file__, args.mode, "--family", args.family, "--child",
               str(Path(root).resolve())]
        if args.mode == "bits":
            Path(args.out).mkdir(parents=True, exist_ok=True)
            saved.append(Path(args.out) / f"{n}.pt")
            cmd += ["--save", str(saved[-1]), "--changed", *args.changed]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        lines.append(proc.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    if args.mode == "bits":
        same = _same_bits(saved)
        rerun = {json.loads(x)["root"]: json.loads(x)["same_bits_on_rerun"] for x in lines}
        print(json.dumps({"same_bits_as_first_root": same, "same_bits_on_rerun": rerun,
                          "changed": args.changed}), flush=True)
        ok = all(v for k, v in same.items() if k not in args.changed) and all(
            all(r.get(k, False) for k in args.changed) for r in rerun.values())
        return 0 if ok else 1
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    runs = [json.loads(x) for x in lines]
    if args.mode == "kernels":
        ms = {k: {r["root"]: {b["a"]: [b["ms"], b.get("ms_without_gw")] for b in r["kernels"][k]}
                  for r in runs} for k in runs[0]["kernels"]}
        print(json.dumps({"ms_by_kernel_root_bucket": ms}), flush=True)
        return 0
    print(json.dumps({"summary": summary(runs, args.family)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
