"""The port's Wandb and TensorBoard loggers and its profiling against the JAX
package's, on the CPU.

* The same sequence of log_metrics / log_hyperparams / log_histograms /
  finalize calls through both packages' loggers: the Wandb logger against a
  stub `wandb` module (the package is not installed) records the same calls;
  the TensorBoard event files read back with the same scalar tags, steps and
  values, and the same histogram tags and steps.
* `pipelines.build_trainer` adds the loggers where the config enables them
  (`wandb.enable`, `tensorboard.enable`), as the JAX package's.
* A CPU train run with `profile_dir` writes a Chrome trace of its steps; with
  `log_mfu` and a peak the test stands in for the card's measured one, each
  logged step carries a finite positive "mfu" equal to the counted FLOPs at
  the logged step rate over the peak. Without one (the CPU measures none) no
  mfu is logged, as the JAX package logs none where it knows no peak.
* The counted FLOPs are FlopCounterMode's ATen operators plus the FLOPs the
  kernel launches report (`_kernels.count_flops`).
* `StepTimer` and `mfu` follow the JAX package's arithmetic.
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

from nabladft_tpu.train import loggers as jax_loggers
from nabladft_tpu.train import profiling as jax_profiling
from nabladft_tpu_torch import pipelines
from nabladft_tpu_torch.ops import _kernels
from nabladft_tpu_torch.train import loggers, profiling
from tests.test_torch_train import _Toy, _toy_batches, _toy_trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CALLS = [({"train/total": 1.5, "grad_norm": 0.25, "lr": 1e-3}, 1),
         ({"train/total": 1.25, "grad_norm": 0.5, "lr": 1e-3}, 2),
         ({"val/loss": 0.75, "epoch": 0}, 2),
         ({"train/total": 1.0, "mfu": 0.125}, 4)]
HPARAMS = {"model": {"name": "painn", "kwargs": {"hidden": 16}}, "lr": 1e-3, "name": "x"}


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"params": {"layer_0": {"message": {"filter_kernel": rng.normal(size=(8, 48))},
                                   "update": {"Dense_0": {"kernel": rng.normal(size=(16, 16))}}},
                       "atom_embedding": {"embedding": rng.normal(size=(10, 16))}}}


def _drive(lg) -> None:
    lg.log_hyperparams(HPARAMS)
    for metrics, step in CALLS:
        lg.log_metrics(metrics, step)
    for step in (2, 4):
        lg.log_histograms(_tree(step), step)
    lg.finalize()


class _StubRun:
    def __init__(self, record, **init):
        self.record = record
        record.append(("init", init))
        self.config = types.SimpleNamespace(
            update=lambda params, **kw: record.append(("config.update", params, kw)))

    def log(self, metrics, step=None):
        self.record.append(("log", dict(metrics), step))

    def finish(self):
        self.record.append(("finish",))


@pytest.fixture
def stub_wandb(monkeypatch):
    record = []
    mod = types.ModuleType("wandb")
    mod.init = lambda **kw: _StubRun(record, **kw)
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return record


def test_wandb_logger_makes_the_jax_loggers_calls(stub_wandb):
    _drive(jax_loggers.WandbLogger("proj", name="run"))
    want = list(stub_wandb)
    stub_wandb.clear()
    _drive(loggers.WandbLogger("proj", name="run"))
    assert stub_wandb == want
    assert want[0] == ("init", {"project": "proj", "name": "run"}) and want[-1] == ("finish",)


def _events(path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(path), size_guidance={"scalars": 0, "histograms": 0})
    acc.Reload()
    tags = acc.Tags()
    scalars = {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in tags["scalars"]}
    hists = {t: [e.step for e in acc.Histograms(t)] for t in tags["histograms"]}
    return scalars, hists


def test_tensorboard_event_files_match_jax(tmp_path):
    _drive(jax_loggers.TensorBoardLogger(tmp_path / "jax"))
    _drive(loggers.TensorBoardLogger(tmp_path / "torch"))
    (js, jh), (ts, th) = _events(tmp_path / "jax"), _events(tmp_path / "torch")
    assert ts == js and th == jh
    assert ts["train/total"] == [(1, 1.5), (2, 1.25), (4, 1.0)]
    assert th["params/params/layer_0/message/filter_kernel"] == [2, 4]
    hp_j, hp_t = (sorted(p.name for p in (tmp_path / k).rglob("*") if p.is_dir())
                  for k in ("jax", "torch"))
    assert hp_t == hp_j  # the hparams run directory


def test_pipelines_add_the_enabled_loggers(tmp_path, stub_wandb):
    from tests.test_torch_optimize_task import REPO
    from nabladft_tpu_torch.config import load_config

    cfg = load_config(REPO / "configs" / "painn-oc.yaml", overrides={
        "model": {"kwargs": {"hidden": 8, "n_interactions": 1, "n_rbf": 4}},
        "output_dir": str(tmp_path), "wandb": {"enable": True, "project": "p"},
        "tensorboard": {"enable": True}})
    trainer = pipelines.build_trainer(cfg, torch.device("cpu"))
    kinds = [type(lg).__name__ for lg in trainer.loggers.loggers]
    assert kinds == ["StdoutLogger", "CSVLogger", "WandbLogger", "TensorBoardLogger"]
    assert stub_wandb[0] == ("init", {"project": "p", "name": cfg["name"]})
    assert (tmp_path / cfg["name"] / "tb").is_dir()
    trainer.loggers.finalize()


class _Recorder(loggers.Logger):
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append((step, dict(metrics)))


def test_profile_dir_writes_a_trace_and_log_mfu_logs_mfu(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "measured_peak_flops", lambda device, dtype: 1e9)
    trainer = _toy_trainer(max_epochs=1, log_every_n_steps=1, profile_dir=str(tmp_path / "prof"),
                           log_mfu=True)
    trainer.loggers = rec = _Recorder()
    trainer.fit(_Toy(_toy_batches(n=2)))
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    steps = [(s, m) for s, m in rec.rows if "train/total" in m]
    assert [s for s, _ in steps] == [1, 2]
    assert trainer.step_flops > 0 and trainer.kernel_flops == 0 and trainer.peak_flops == 1e9
    for _, m in steps:
        assert np.isfinite(m["mfu"]) and m["mfu"] > 0
        assert m["mfu"] == pytest.approx(trainer.step_flops * m["steps_per_sec"] / 1e9)


def test_log_mfu_off_the_card_logs_no_mfu():
    trainer = _toy_trainer(max_epochs=1, log_every_n_steps=1, log_mfu=True)
    trainer.loggers = rec = _Recorder()
    trainer.fit(_Toy(_toy_batches(n=2)))
    steps = [m for _, m in rec.rows if "train/total" in m]
    assert len(steps) == 2 and trainer.peak_flops is None and trainer.step_flops > 0
    assert not any("mfu" in m for m in steps)


def test_step_flops_counts_the_matmuls_and_the_kernels():
    a, b = torch.ones(8, 16), torch.ones(16, 4)

    def step(x, y):
        _kernels.count_flops(lambda: 100)  # a launch reporting its work
        return torch.mm(x, y)

    (flops, kernel), out = profiling.step_flops(step, a, b)
    assert (flops, kernel) == (2 * 8 * 16 * 4 + 100, 100) and torch.equal(out, a @ b)
    seen = []
    _kernels.count_flops(lambda: seen.append(1) or 1)  # no tally open: work not run
    with _kernels.flop_tally() as outer:
        _kernels.count_flops(lambda: 5)
        with _kernels.flop_tally() as inner:
            _kernels.count_flops(lambda: 7)
    assert not seen and outer == [5.0] and inner == [7.0]


def test_step_timer_and_mfu_follow_jax():
    jt, tt = jax_profiling.StepTimer(), profiling.StepTimer(peak_flops=2e9)
    for dt in (0.5, 0.25, 0.125):
        assert tt.update(dt) == pytest.approx(jt.update(dt))
    tt.flops = 1e8
    got, want = tt.metrics(16), jt.metrics(16)
    assert {k: got[k] for k in want} == pytest.approx(want)
    assert got["mfu"] == pytest.approx(1e8 / tt.avg / 2e9)
    assert profiling.mfu(1e8, 0.0, 2e9) is None and profiling.mfu(1e8, 1.0, 0.0) is None
    assert profiling.measured_peak_flops(torch.device("cpu")) is None
