"""Kernel B's two designs, timed by the products that tell them apart.

    python3 tools/painn_b_products.py

B runs wm = rbf W and rp = rbfp W over the live pairs on the SO(2) product
engine (one persistent launch of two problems, K = R = 100, N = 3F = 384),
then a per-pair stage that reads both and forms g_dist = sum_f gwm * rp.
The other design forms gwm first and gets g_dist = sum_r rbfp * (gwm W^T):
the launch computes wm alone, one more product t = gwm W^T (K = 3F, N = R)
follows the stage, and a per-pair dot of t with the rbfp row gives g_dist.
The stage moves the same bytes in both (it writes gwm instead of reading
rp). So per bucket this prints, on chip_smoke.py's kernel-B inputs (B=64,
R=100, F=128, A = 32 / 48 / 64), the median ms (25 CUDA-event runs) of:

- `wm_rp`: wm and rp, as B launches them now;
- `wm`: wm alone, as the other design would launch it;
- `t`: gwm W^T over the live rows, one tile a block and persistent;
- `dot_bound`: the per-pair dot's bytes (t and the rbfp rows read, g_dist
  written) at 3.35 TB/s, a lower bound for a kernel not written;

and `other_minus_now` = wm + min(t) + dot_bound - wm_rp: above zero, the
other design is slower even with its dot at its bound. Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from nabladft_tpu_torch.ops import eqv2_attn as ea  # noqa: E402
from nabladft_tpu_torch.ops import painn_fused as pf  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def bucket(dev, a: int) -> dict:
    x = cs.kernel_inputs(dev, a)
    rbf, rbfp, w = x["rbf"], x["rbfp"], x["w"]
    r, f3 = w.shape
    _, rows, _ = pf.painn_live_pairs(rbf, rbfp)
    live = len(rows)
    eidx = rows.int()
    flat, flatp = rbf.reshape(-1, r), rbfp.reshape(-1, r)
    wm = torch.empty(live, f3, device=dev)
    rp = torch.empty(live, f3, device=dev)
    both = [dict(segs=[dict(a=flat, b=w, k=r)], n=f3, c=wm, gather=True),
            dict(segs=[dict(a=flatp, b=w, k=r)], n=f3, c=rp, gather=True)]
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    gwm = torch.randn(live, f3, generator=g, device=dev)
    t = torch.empty(live, r, device=dev)
    tprob = [dict(segs=[dict(a=gwm, b=w, k=f3, btrans=True)], n=r, c=t)]

    # the products against their plain versions first
    ea.so2_products(both, live, eidx, persistent=True)
    ea.so2_products(tprob, live)
    err_rp = float((rp - flatp[rows] @ w).abs().max() / (flatp[rows] @ w).abs().max())
    err_t = float((t - gwm @ w.T).abs().max() / (gwm @ w.T).abs().max())
    cs.check(max(err_rp, err_t) <= cs.KERNEL_RTOL, f"product errors {err_rp}, {err_t}")

    ms = {
        "wm_rp": cs.time_ms(lambda: ea.so2_products(both, live, eidx, persistent=True)),
        "wm": cs.time_ms(lambda: ea.so2_products(both[:1], live, eidx, persistent=True)),
        "t_tiles": cs.time_ms(lambda: ea.so2_products(tprob, live)),
        "t_persistent": cs.time_ms(lambda: ea.so2_products(tprob, live, persistent=True)),
    }
    ms = {k: v["median"] for k, v in ms.items()}
    ms["dot_bound"] = 4 * (2 * live * r + live) / HBM_BYTES_PER_S * 1e3
    other = ms["wm"] + min(ms["t_tiles"], ms["t_persistent"]) + ms["dot_bound"]
    return {"a": a, "live_pairs": live, "pairs": rbf.shape[0] * a * a, "ms": ms,
            "max_rel_err": {"rp": err_rp, "t": err_t},
            "other_minus_now_ms": other - ms["wm_rp"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("painn_b_products: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.nvidia_smi(), flush=True)
    for a in cs.BUCKETS:
        print(json.dumps(bucket(dev, a)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
