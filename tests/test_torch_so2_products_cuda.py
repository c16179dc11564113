"""The SO(2) product engine of kernels M-P (nabladft_tpu_torch/csrc/so2_common.cuh:
3xTF32 wgmma fed by TMA and cp.async) against float64 torch.matmul on the card.

Every test needs a CUDA card and nvcc and skips without one. The file imports
no JAX (tests/conftest.py does, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_so2_products_cuda.py

`ea.so2_products` / `ea.so2_wgrads` run the engine on one problem list
through the library's probe entry points; the reference is their plain
version on float64 copies of the same inputs. Shapes: ragged row counts (1,
127, 129 and 68,632 live rows of more slots), N 4 / 132 / 640 / 1,536 and K
8 / 24 / 1,792, signed and transposed segments, gathered A rows and scattered
C rows, the three epilogues (the gate-multiply one also with a bias, in
place), and the weight gradients (rows, gathered,
column sums), run twice for the same bits; and the live-row list
(`live_rows`) against its plain version, exactly. Tolerance: max |engine - float64|
<= 2e-5 x max |float64| per output, the kernels' tolerance in chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

from nabladft_tpu_torch.ops import eqv2_attn as ea

REL = 2e-5


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _close(got, ref, what):
    err = float((got.double() - ref).abs().max())
    scale = float(ref.abs().max())
    assert err <= REL * scale, f"{what}: max |err| {err:.3e} > {REL} x {scale:.3e}"


def _run_both(make, tensors, n_rows, eidx, outs, wgrad=False):
    """make(t) -> problems over the tensor dict t: once in float32 through the
    engine, once in float64 through the plain version; compare `outs`."""
    f32 = {k: v.clone() for k, v in tensors.items()}
    f64 = {k: v.double().clone() for k, v in tensors.items()}
    fn, ref = (ea.so2_wgrads, ea.so2_wgrads_reference) if wgrad else (
        ea.so2_products, ea.so2_products_reference)
    fn(make(f32), n_rows, eidx)
    torch.cuda.synchronize()
    ref(make(f64), n_rows, eidx)
    for k in outs:
        _close(f32[k], f64[k], k)
    return f32


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 127, 129, 68632])
def test_products_ragged_rows(card, rows):
    rng = np.random.default_rng(rows)
    slots = rows + 300
    t = {"a": _rand(rng, slots, 24).to(card), "b": _rand(rng, 24, 132).to(card),
         "c": torch.zeros(slots, 132, device=card)}

    def make(x):
        return [dict(segs=[dict(a=x["a"], b=x["b"], k=24)], n=132, c=x["c"])]

    got = _run_both(make, t, rows, None, ["c"])
    assert float(got["c"][rows:].abs().max()) == 0.0  # rows past the count untouched


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(4, 8), (132, 24), (640, 1792), (1536, 1792)])
def test_products_widths(card, n, k):
    rng = np.random.default_rng(n + k)
    rows = 1000
    t = {"a": _rand(rng, rows, k + 8).to(card), "b": _rand(rng, k, n + 4, scale=k ** -0.5).to(card),
         "c": torch.zeros(rows, n, device=card)}

    def make(x):  # A and B as column views of wider buffers
        return [dict(segs=[dict(a=x["a"][:, 8:], b=x["b"][:, 4:], k=k)], n=n, c=x["c"])]

    _run_both(make, t, rows, None, ["c"])


@pytest.mark.cuda
def test_products_signed_transposed_segments(card):
    rng = np.random.default_rng(7)
    rows, n = 3000, 256
    ks = (1536, 8, 24, 896)
    t = {f"a{i}": _rand(rng, rows, k).to(card) for i, k in enumerate(ks)}
    t.update({"b0": _rand(rng, ks[0], n, scale=0.03).to(card),
              "b1": _rand(rng, n, ks[1]).to(card),          # transposed: [N, K]
              "b2": _rand(rng, ks[2], n).to(card),
              "b3": _rand(rng, n, ks[3], scale=0.03).to(card),  # transposed
              "c": torch.zeros(rows, n, device=card)})

    def make(x):
        segs = [dict(a=x["a0"], b=x["b0"], k=ks[0]),
                dict(a=x["a1"], b=x["b1"], k=ks[1], btrans=True, sign=-1),
                dict(a=x["a2"], b=x["b2"], k=ks[2], sign=-1),
                dict(a=x["a3"], b=x["b3"], k=ks[3], btrans=True)]
        return [dict(segs=segs, n=n, c=x["c"])]

    _run_both(make, t, rows, None, ["c"])


@pytest.mark.cuda
def test_products_gather_gates_and_scatter_gated(card):
    rng = np.random.default_rng(11)
    slots, rows, k, n = 5000, 4321, 384, 640
    eidx = torch.from_numpy(np.sort(rng.choice(slots, rows, replace=False)).astype(np.int32))
    eidx = eidx.to(card)
    t = {"xe": _rand(rng, slots, k).to(card), "w": _rand(rng, k, n, scale=0.05).to(card),
         "bias": _rand(rng, n).to(card), "z": torch.zeros(slots, n, device=card),
         "s": torch.zeros(slots, n, device=card),
         "f": _rand(rng, slots, 2 * k).to(card), "w2": _rand(rng, n, 2 * k, scale=0.03).to(card),
         "gate": _rand(rng, slots, n).to(card), "h": torch.zeros(slots, n, device=card),
         "hg": torch.zeros(slots, n, device=card), "sc": torch.zeros(slots + 7, 2 * k, device=card),
         "g2": _rand(rng, slots, n).to(card), "w3": _rand(rng, 2 * k, n, scale=0.03).to(card)}

    def make(x):
        return [
            # the radial / gate product: rows gathered, bias, silu
            dict(segs=[dict(a=x["xe"], b=x["w"], k=k)], n=n, epi="gates", c=x["z"], c2=x["s"],
                 bias=x["bias"], gather=True),
            # a hidden product: gate multiply
            dict(segs=[dict(a=x["f"], b=x["w2"], k=2 * k, btrans=True)], n=n, epi="gated",
                 c=x["h"], c2=x["hg"], gate=x["gate"]),
            # gxe: rows scattered to the slots
            dict(segs=[dict(a=x["g2"], b=x["w3"], k=n, btrans=True)], n=2 * k, c=x["sc"],
                 scatter=True),
        ]

    _run_both(make, t, rows, eidx, ["z", "s", "h", "hg", "sc"])


@pytest.mark.cuda
@pytest.mark.parametrize("persistent", [False, True])
def test_products_gated_bias_in_place(card, persistent):
    """QHNet's w = u_r u_s: u_r (gathered rows, bias) first, then u_s with
    its bias added and the u_r row multiplied in, written over u_r; one
    block a tile, or one block per SM over all the tiles."""
    rng = np.random.default_rng(12)
    slots, rows, n = 3000, 2345, 8320
    eidx = torch.from_numpy(np.sort(rng.choice(slots, rows, replace=False)).astype(np.int32))
    eidx = eidx.to(card)
    t = {"hr": _rand(rng, slots, 8).to(card), "w2r": _rand(rng, 8, n, scale=0.3).to(card),
         "b2r": _rand(rng, n, scale=0.1).to(card), "hs": _rand(rng, slots, 128).to(card),
         "w2s": _rand(rng, 128, n, scale=0.09).to(card),
         "b2s": _rand(rng, n, scale=0.1).to(card), "w": torch.zeros(rows, n, device=card)}
    f32 = {k: v.clone() for k, v in t.items()}
    f64 = {k: v.double().clone() for k, v in t.items()}
    for x in (f32, f64):
        fn = (functools.partial(ea.so2_products, persistent=persistent) if x is f32
              else ea.so2_products_reference)
        fn([dict(segs=[dict(a=x["hr"], b=x["w2r"], k=8)], n=n, epi="gates", c=x["w"],
                 bias=x["b2r"], gather=True)], rows, eidx)
        fn([dict(segs=[dict(a=x["hs"], b=x["w2s"], k=128)], n=n, epi="gated", c2=x["w"],
                 gate=x["w"], bias=x["b2s"], gather=True)], rows, eidx)
    torch.cuda.synchronize()
    _close(f32["w"], f64["w"], "w")


@pytest.mark.cuda
def test_wgrads_twice_same_bits(card):
    rng = np.random.default_rng(13)
    slots, rows = 70000, 68632
    eidx = torch.from_numpy(np.sort(rng.choice(slots, rows, replace=False)).astype(np.int32))
    eidx = eidx.to(card)
    t = {"fp": _rand(rng, slots, 1792).to(card), "fm": _rand(rng, slots, 1792).to(card),
         "gp": _rand(rng, slots, 896).to(card), "gm": _rand(rng, slots, 896).to(card),
         "xe": _rand(rng, slots, 384).to(card), "rad": _rand(rng, slots, 1792).to(card),
         "w": torch.zeros(1792, 2 * 896, device=card), "wr": torch.zeros(384, 1792, device=card),
         "b": torch.zeros(1, 1792, device=card), "s": torch.zeros(4, 4, device=card)}

    def make(x):
        return [
            dict(segs=[dict(a=x["fp"], b=x["gp"]), dict(a=x["fm"], b=x["gm"], sign=-1)],
                 m=1792, n=896, out=x["w"][:, :896]),
            dict(segs=[dict(a=x["fp"], b=x["gm"])], m=1792, n=896, out=x["w"][:, 896:]),
            dict(segs=[dict(a=x["xe"], b=x["rad"])], amode="gather", m=384, n=1792, out=x["wr"]),
            dict(segs=[dict(a=None, b=x["rad"], sign=-1)], amode="ones", m=1, n=1792, out=x["b"]),
            dict(segs=[dict(a=x["fp"], b=x["gp"])], m=4, n=4, out=x["s"]),
        ]

    got = _run_both(make, t, rows, eidx, ["w", "wr", "b", "s"], wgrad=True)
    again = {k: v.clone() for k, v in t.items()}
    ea.so2_wgrads(make(again), rows, eidx)
    torch.cuda.synchronize()
    for k in ("w", "wr", "b", "s"):
        assert torch.equal(got[k], again[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 129])
def test_wgrads_few_rows(card, rows):
    rng = np.random.default_rng(rows)
    slots = rows + 40
    t = {"a": _rand(rng, slots, 260).to(card), "b": _rand(rng, slots, 132).to(card),
         "o": torch.zeros(260, 132, device=card)}

    def make(x):
        return [dict(segs=[dict(a=x["a"], b=x["b"])], m=260, n=132, out=x["o"])]

    _run_both(make, t, rows, None, ["o"], wgrad=True)


@pytest.mark.cuda
@pytest.mark.parametrize("segments,seg,share", [
    (3072, 48, 0.7),   # PaiNN's B / D at B=64, A=48 (a sender's receivers)
    (4096, 64, 0.3),   # A=64, mostly dead
    (2048, 30, 0.9),   # EquiformerV2's 30 neighbours a receiver
    (1500, 100, 0.5),  # segments past 3 warps' lanes, not a multiple of 32
    (5000, 1, 0.5),    # more segments than the scan's 1,024 threads hold evenly
    (0, 48, 0.5),      # no slot at all
])
def test_live_rows_list_every_live_slot(card, segments, seg, share):
    """The live-row list every kernel of B, D and I-P runs: exactly the plain
    list (nonzero and a cumulative count), with dead, full and empty
    segments."""
    rng = np.random.default_rng(segments + seg)
    flags = (rng.random(segments * seg) < share).astype(np.int32)
    if segments > 4:
        flags.reshape(segments, seg)[1] = 0  # a segment with no live slot
        flags.reshape(segments, seg)[3] = 1  # one with every slot live
    f = torch.from_numpy(flags)
    got = ea.so2_live_rows(f.to(card), seg)
    ref = ea.so2_live_rows_reference(f, seg)
    assert got[3] == ref[3]
    for g, r, what in zip(got[:3], ref[:3], ("eidx", "pos", "rs")):
        assert torch.equal(g.cpu(), r), what
