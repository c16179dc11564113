#!/usr/bin/env python3
"""Where the bf16 mode of kernels M-P differs from its plain version, per output.

    python3 tools/so2_bf16_errors.py [--batch 64] [--atoms 32 48]

Needs one CUDA card. On chip_smoke's inputs (configs/escn-oc.yaml and
configs/equiformer_v2.yaml widths, B molecules of each A), for each output of
M, N, O and P: the bf16 kernel and the fp32 kernel against the plain bf16
version (run chip_smoke's plain-molecule chunks at a time), as the largest
error over the output's largest magnitude ("max_rel"), the relative
Frobenius error ("fro_rel"), and the share of elements off by more than
1e-3 of the largest magnitude. Rounding flips (the two sides sum in another
order before a bf16 rounding) give a few large elements and a small
Frobenius error; a rounding point missed or added gives an error spread over
every element, the size of the fp32 kernel's. With --cpu-plain, also the
plain bf16 version run on the CPU against the one on the card: the same
rounding points, sums in another order, which shows how far a kernel's
rounding flips carry through its stages. Prints one JSON line per kernel
and shape, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def errors(got, ref) -> dict:
    d, r = (got.double() - ref.double()), ref.double()
    scale = float(r.abs().max().clamp_min(1e-30))
    return {"max_rel": float(d.abs().max()) / scale,
            "fro_rel": float(d.norm() / r.norm().clamp_min(1e-30)),
            "share_over_1e-3": float((d.abs() > 1e-3 * scale).double().mean())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=cs.BATCH)
    ap.add_argument("--atoms", type=int, nargs="+", default=[32, 48])
    ap.add_argument("--cpu-plain", action="store_true",
                    help="also run the plain bf16 versions on the CPU (small batches only)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("so2_bf16_errors: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from nabladft_tpu_torch.ops import eqv2_attn as ea
    from nabladft_tpu_torch.ops import escn_layer as el

    dev = torch.device("cuda")
    names = {"M": ["out"],
             "N": ["gx", "gxe", "wg", "bg", "w1_0", "w2_0", "fc1_m1", "w2r_m1", "w2i_m1",
                   "fc1_m2", "w2r_m2", "w2i_m2"],
             "O": ["agg"], "P": ["gx", "gxi", "gxe"] + ea.weight_names(2)}
    for a in args.atoms:
        x = cs.escn_kernel_inputs(dev, args.batch, a, seed=cs.SEED + 3000 + a)
        inp = cs.eqv2_kernel_inputs(dev, args.batch, a, seed=cs.SEED + 4000 + a, drop=True)
        e_args, o_args = (x["x"], x["d"], x["xe"], *x["ws"]), tuple(cs._eqv2_args(inp))
        specs = {"M": (el.escn_fwd, el.escn_fwd_reference, e_args, 3, x["dims"], None,
                       cs.ESCN_PLAIN_MOLS),
                 "N": (el.escn_bwd, el.escn_bwd_reference, e_args, 3, x["dims"], x["g"],
                       cs.ESCN_PLAIN_MOLS),
                 "O": (ea.eqv2_fwd, ea.eqv2_fwd_reference, o_args, 7, inp["dims"], None,
                       cs.EQV2_PLAIN_MOLS),
                 "P": (ea.eqv2_bwd, ea.eqv2_bwd_reference, o_args, 7, inp["dims"], inp["g"],
                       cs.EQV2_PLAIN_MOLS)}
        for k, (fn, ref, fargs, n_mol, dims, g, n_plain) in specs.items():
            kw16 = dict(dims, mxu_bf16=True, **({} if g is None else {"g": g}))
            kw32 = dict(kw16, mxu_bf16=False)
            tup = (lambda t: t if isinstance(t, tuple) else (t,))
            want = tup(cs._plain_in_chunks(ref, fargs, n_mol, kw16, n_plain))
            got16, got32 = tup(fn(*fargs, **kw16)), tup(fn(*fargs, **kw32))
            torch.cuda.synchronize()
            rows = {n: {"bf16_kernel": errors(p, q), "fp32_kernel": errors(p32, q)}
                    for n, p, p32, q in zip(names[k], got16, got32, want)}
            if args.cpu_plain:
                cpu = tup(ref(*[t.cpu() for t in fargs],
                              **{q: (v.cpu() if torch.is_tensor(v) else v)
                                 for q, v in kw16.items()}))
                for n, c, q in zip(names[k], cpu, want):
                    rows[n]["plain_cpu_vs_card"] = errors(c, q.cpu())
            print(json.dumps({"kernel": k, "shape": [args.batch, a], "outputs": rows}),
                  flush=True)
            del want, got16, got32
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
