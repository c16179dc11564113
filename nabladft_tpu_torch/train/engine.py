"""The training / evaluation / predict engine.

The port of ``nabladft_tpu/train/engine.py`` on one device (the card
unless the caller names another): weighted multi-task losses, three ways to
take the force loss's parameter gradient, AdamW with the plateau LR, EMA,
top-k checkpoints, keep-best / restore-best-for-test, early stopping,
`max_steps` / `max_seconds` / `stop_at_lr`, and a non-finite skip guard
(warmup counts the updates it let through). Train steps run the model in
train mode (dropout drawn from a generator seeded from the seed and the
step); validation, test and predict in eval mode.
Weights are the model's own (a seeded ``torch.Generator`` when it was
built, or carried across from the JAX package); buffers are never updated.

Force-loss gradients for models with F = -∂E/∂pos (``force_grads``):
  * ``direct``    — double backward through autograd's forces (plain
    modules only: the fused kernels' backward is first-order);
  * ``surrogate`` — a force pass with the parameters held fixed, then
    w = stop_grad(∂L_F/∂F)·mask and one forward-AD dual pass of the same
    module with pos dual in direction w; since Σ w·F = -(jvp of Σ E along
    w), the loss other(primal) - tangent(Σ E) has the same parameter
    gradient as the direct form, from first-order reverse mode only;
  * ``pallas``    — the surrogate on a fused model: the force pass runs
    the first-order kernels with no weight gradient (PaiNN's A and B,
    SchNet's E and F), the dual pass the dual kernels (C and D; G and H).
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from torch import nn

from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.models.base import ModelOutput, forward
from nabladft_tpu_torch.train import losses as losses_lib
from nabladft_tpu_torch.train.checkpoints import CheckpointManager, load_state, read_aux
from nabladft_tpu_torch.train.loggers import Logger, StdoutLogger
from nabladft_tpu_torch.train.metrics import MetricAccumulator, batch_metric_sums
from nabladft_tpu_torch.train.schedulers import PlateauState, build_schedule
from nabladft_tpu_torch.train.state import (
    build_optimizer, current_learning_rate, ema_init, ema_update, set_learning_rate,
)
from nabladft_tpu_torch.utils import resolve_device

logger = logging.getLogger(__name__)

FORCE_GRADS = ("direct", "surrogate", "pallas")


def seeded_generator(seed: int) -> torch.Generator:
    """The CPU generator model weights are drawn from."""
    return torch.Generator(device="cpu").manual_seed(int(seed))


@dataclass
class TrainerConfig:
    """The JAX package's fields and defaults. Not ported yet, and raising
    when set: n_dp > 1, lookahead_k, profile_dir, log_mfu and the
    step-indexed schedules. fit_scale_factors / scale_fit_batches concern
    models with fitted scale factors (none ported); total_steps only the
    step-indexed schedules."""

    max_epochs: int = 100
    max_steps: Optional[int] = None
    max_seconds: Optional[float] = None
    optimizer: str = "adamw"  # adamw | adam | amsgrad | sgd
    lr: float = 1e-4
    weight_decay: float = 0.0
    wd_skip_1d: bool = True
    grad_clip: Optional[float] = None
    schedule: str = "plateau"  # plateau | constant
    schedule_kwargs: Dict[str, Any] = field(default_factory=dict)
    total_steps: Optional[int] = None
    warmup_steps: int = 0
    plateau_factor: float = 0.8
    plateau_patience: int = 10
    plateau_min_lr: float = 1e-6
    ema_decay: float = 0.0  # 0 disables EMA
    eval_with_ema: bool = True
    lookahead_k: int = 0
    lookahead_alpha: float = 0.5
    log_every_n_steps: int = 50
    hist_every_n_steps: Optional[int] = None
    ckpt_dir: Optional[str] = None
    save_top_k: int = 3
    monitor: str = "val/loss"
    early_stopping_patience: Optional[int] = None
    val_every_n_steps: Optional[int] = None
    stop_at_lr: Optional[float] = None
    seed: int = 42
    n_dp: Optional[int] = None
    profile_dir: Optional[str] = None
    log_mfu: bool = False
    loss_specs: Dict[str, str] = field(
        default_factory=lambda: {"energy": "l1", "forces": "l2norm"})
    loss_coefs: Dict[str, float] = field(
        default_factory=lambda: {"energy": 1.0, "forces": 1.0})
    loss_max_errors: Optional[Dict[str, float]] = None
    force_grads: str = "direct"  # direct | surrogate | pallas
    fast_force_grads: bool = False  # legacy alias: True = "surrogate"
    fit_scale_factors: bool = True
    scale_fit_batches: int = 4
    keep_best_params: bool = True
    restore_best_for_test: bool = True


def _check_ported(cfg: TrainerConfig) -> None:
    unported = {
        "n_dp > 1 (ROADMAP queue 1: multi-GPU data parallelism)": (cfg.n_dp or 1) > 1,
        "lookahead_k (ROADMAP queue 1: PhiSNet's Lookahead)": bool(cfg.lookahead_k),
        "profile_dir (ROADMAP queue 1: trainer remainders)": bool(cfg.profile_dir),
        "log_mfu (ROADMAP queue 1: trainer remainders)": cfg.log_mfu,
    }
    for what, on in unported.items():
        if on:
            raise NotImplementedError(f"TrainerConfig {what} is not ported yet")


class Trainer:
    """fit / validate / test / predict over a model on one device."""

    def __init__(self, model: nn.Module, device=None, config: Optional[TrainerConfig] = None,
                 loggers: Optional[Logger] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg = config or TrainerConfig()
        _check_ported(cfg)
        build_schedule(cfg.schedule, cfg.lr, cfg.total_steps or cfg.max_steps or 1_000_000,
                       cfg.warmup_steps, **cfg.schedule_kwargs)
        self._force_grads = cfg.force_grads
        if cfg.fast_force_grads and self._force_grads == "direct":
            self._force_grads = "surrogate"
        if self._force_grads not in FORCE_GRADS:
            raise ValueError(f"force_grads must be one of {FORCE_GRADS}, got {cfg.force_grads!r}")
        if self._force_grads == "pallas" and getattr(model, "use_pallas", "off") != "fused":
            raise ValueError("force_grads='pallas' needs a model built with use_pallas='fused'")
        self.loggers = loggers or StdoutLogger()
        self.plateau = PlateauState(factor=cfg.plateau_factor, patience=cfg.plateau_patience,
                                    min_lr=cfg.plateau_min_lr)
        self.optimizer = build_optimizer(model.named_parameters(), cfg.optimizer, cfg.lr,
                                         cfg.weight_decay, cfg.wd_skip_1d)
        self.ema = ema_init(model) if cfg.ema_decay > 0 else None
        self.step = 0
        # updates applied (the skip guard's steps excluded): the warmup's count,
        # as optax.scale_by_schedule's state that the JAX guard reverts
        self.applied = 0
        # train-mode dropout (EquiformerV2) draws from a generator seeded from
        # cfg.seed and the step, as the JAX engine folds the step into its key
        self._dropout_gen = (torch.Generator(device=self.device)
                             if hasattr(model, "dropout_generator") else None)
        self._lr = cfg.lr  # the plateau-driven rate, before warmup
        # (step, params, ema) copies at the best `monitor`
        self._best_snapshot = None
        self.ckpt = (CheckpointManager(Path(cfg.ckpt_dir), top_k=cfg.save_top_k,
                                       monitor=cfg.monitor) if cfg.ckpt_dir else None)

    # -- gradients -----------------------------------------------------------

    def _params(self):
        return [p for p in self.model.parameters() if p.requires_grad]

    def _uses_forces(self) -> bool:
        return (getattr(self.model, "derivative_forces", False)
                and "forces" in self.cfg.loss_specs)

    def _compute_grads(self, batch: MolBatch) -> Dict[str, torch.Tensor]:
        """Fill each parameter's .grad with the gradient of the total loss;
        returns the detached losses."""
        cfg = self.cfg
        for p in self._params():
            p.grad = None
        if self._uses_forces() and self._force_grads != "direct":
            return self._surrogate_grads(batch)
        if self._uses_forces():
            if getattr(self.model, "use_pallas", "off") != "off":
                raise ValueError("force_grads='direct' differentiates the forces twice, which "
                                 "the fused message kernels do not support; use 'pallas'")
            pos = batch.pos.detach().requires_grad_(True)
            out = dict(self.model(batch.replace(pos=pos)))
            e = torch.where(batch.graph_mask, out["energy"], torch.zeros_like(out["energy"]))
            (g,) = torch.autograd.grad(e.sum(), pos, create_graph=True)
            out["forces"] = -g * batch.node_mask[..., None]
        else:
            out = self.model(batch)
        losses = losses_lib.multitask_loss(out, batch, cfg.loss_specs, cfg.loss_coefs,
                                           max_errors=cfg.loss_max_errors)
        losses["total"].backward()
        return {k: v.detach() for k, v in losses.items()}

    def _surrogate_grads(self, batch: MolBatch) -> Dict[str, torch.Tensor]:
        """The surrogate force gradient (see the module docstring)."""
        cfg = self.cfg
        out = forward(self.model, batch)  # parameters held fixed
        losses = losses_lib.multitask_loss(out, batch, cfg.loss_specs, cfg.loss_coefs,
                                           max_errors=cfg.loss_max_errors)
        forces = out["forces"].requires_grad_(True)
        with torch.enable_grad():
            f_loss = losses_lib.LOSS_FNS[f"forces_{cfg.loss_specs['forces']}"](
                forces, batch.forces, batch.node_mask)
            (w,) = torch.autograd.grad(cfg.loss_coefs.get("forces", 1.0) * f_loss, forces)
        w = w * batch.node_mask[..., None]
        non_force = {k: v for k, v in cfg.loss_specs.items() if k != "forces"}
        with fwAD.dual_level():
            out_d = self.model(batch.replace(pos=fwAD.make_dual(batch.pos, w)))
            e = torch.where(batch.graph_mask, out_d["energy"], torch.zeros_like(out_d["energy"]))
            e_tangent = fwAD.unpack_dual(e.sum()).tangent
            primal = {k: fwAD.unpack_dual(t).primal for k, t in out_d.items()}
            other = losses_lib.multitask_loss(primal, batch, non_force, cfg.loss_coefs)
        # F = -∇E  ⇒  Σ w·F = -(jvp of Σ E along w)
        (other["total"] - e_tangent).backward()
        return {k: v.detach() for k, v in losses.items()}

    def _train_step(self, batch: MolBatch) -> Dict[str, Any]:
        """One optimizer step; skipped (optimizer state untouched) when the
        gradient norm or the loss is not finite."""
        cfg = self.cfg
        if self._dropout_gen is not None:
            self._dropout_gen.manual_seed(
                int(np.random.SeedSequence([cfg.seed, self.step]).generate_state(1)[0]))
            self.model.dropout_generator = self._dropout_gen
        losses = self._compute_grads(batch)
        grads = [p.grad for p in self._params() if p.grad is not None]
        gnorm = (torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
                 if grads else torch.zeros((), device=self.device))
        gnorm_host = float(gnorm)  # before clipping, as the JAX guard
        finite = bool(np.isfinite(gnorm_host) and torch.isfinite(losses["total"]))
        if finite:
            if cfg.grad_clip and gnorm_host >= cfg.grad_clip:
                torch._foreach_mul_(grads, cfg.grad_clip / gnorm_host)
            if cfg.warmup_steps:
                set_learning_rate(self.optimizer,
                                  self._lr * min(1.0, (self.applied + 1) / cfg.warmup_steps))
            self.optimizer.step()
            self.applied += 1
        for p in self._params():
            p.grad = None
        if self.ema is not None:
            ema_update(self.ema, self.model, cfg.ema_decay)
        self.step += 1
        metrics: Dict[str, Any] = {f"train/{k}": v for k, v in losses.items()}
        metrics["grad_norm"] = gnorm_host
        metrics["skipped_nonfinite"] = 0.0 if finite else 1.0
        return metrics

    # -- eval ----------------------------------------------------------------

    def _eval_params(self) -> Optional[Dict[str, torch.Tensor]]:
        if self.ema is not None and self.cfg.eval_with_ema:
            return self.ema
        return None

    @contextlib.contextmanager
    def _eval_mode(self):
        """The model in eval mode (no dropout), its mode restored after."""
        was = self.model.training
        self.model.eval()
        try:
            yield
        finally:
            self.model.train(was)

    def _eval_step(self, batch: MolBatch) -> Dict[str, torch.Tensor]:
        with self._eval_mode():
            out = forward(self.model, batch, self._eval_params())
        losses = losses_lib.multitask_loss(out, batch, self.cfg.loss_specs, self.cfg.loss_coefs)
        sums = batch_metric_sums(out, batch)
        sums["loss_sum"] = losses["total"]
        return sums

    def _predict_step(self, batch: MolBatch) -> ModelOutput:
        with self._eval_mode():
            return forward(self.model, batch, self._eval_params())

    def validate(self, loader: Iterable[MolBatch], prefix: str = "val") -> Dict[str, float]:
        acc = MetricAccumulator()
        loss_sum, n_batches = 0.0, 0
        for batch in loader:
            sums = self._eval_step(batch.to(self.device))
            loss_sum += float(sums.pop("loss_sum"))
            n_batches += 1
            acc.update(sums)
        metrics = {f"{prefix}/{k}": v for k, v in acc.compute().items()}
        if n_batches:
            metrics[f"{prefix}/loss"] = loss_sum / n_batches
        return metrics

    def test(self, loader: Iterable[MolBatch]) -> Dict[str, float]:
        """Metrics with the `test/` prefix, on the best-`monitor` parameters
        of the last fit when `restore_best_for_test`."""
        if self.cfg.restore_best_for_test:
            self.restore_best()
        return self.validate(loader, prefix="test")

    def predict(self, loader: Iterable[MolBatch]) -> Iterator[Dict[str, np.ndarray]]:
        """Yields per-batch host outputs with padding molecules removed, plus
        `mol_id` and `n_atoms`."""
        for batch in loader:
            out = self._predict_step(batch.to(self.device))
            keep = batch.graph_mask.numpy()
            host = {name: t.cpu().numpy()[keep] for name, t in out.items()}
            host["mol_id"] = batch.mol_id.numpy()[keep]
            host["n_atoms"] = batch.n_atoms.numpy()[keep]
            yield host

    # -- state ---------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "applied": self.applied, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "ema": self.ema}

    def load_checkpoint(self, path, resume: bool = False) -> None:
        """Load a checkpoint this engine wrote: weights and EMA; with
        `resume`, also the step, optimizer state and plateau counters."""
        state = load_state(Path(path), self.device)
        self.model.load_state_dict(state["model"])
        if self.ema is not None and state.get("ema") is not None:
            for n, t in state["ema"].items():
                self.ema[n].copy_(t)
        if resume:
            self.step = int(state["step"])
            self.applied = int(state.get("applied", state["step"]))
            self.optimizer.load_state_dict(state["optimizer"])
            self._lr = current_learning_rate(self.optimizer)
            aux = read_aux(Path(path))
            if aux and "plateau" in aux:
                p = aux["plateau"]
                self.plateau.best, self.plateau.bad_epochs = p["best"], p["bad_epochs"]
                self.plateau.multiplier = p["multiplier"]
        logger.info("loaded checkpoint %s (step %d)", path, int(state["step"]))

    def _ckpt_aux(self) -> Optional[Dict[str, Any]]:
        if self.cfg.schedule != "plateau":
            return None
        p = self.plateau
        return {"plateau": {"best": p.best, "bad_epochs": p.bad_epochs,
                            "multiplier": p.multiplier}}

    def _on_monitored(self, monitored: float) -> None:
        if self.cfg.schedule == "plateau":
            self._lr = self.plateau.step(monitored, self.cfg.lr)
            set_learning_rate(self.optimizer, self._lr)

    def _snapshot(self) -> None:
        clone = lambda d: {n: t.detach().clone() for n, t in d.items()}  # noqa: E731
        self._best_snapshot = (self.step, clone(dict(self.model.named_parameters())),
                               clone(self.ema) if self.ema is not None else None)

    def restore_best(self) -> bool:
        """Swap in the best-`monitor` parameter snapshot taken during fit.
        Returns False when no snapshot exists."""
        if self._best_snapshot is None:
            return False
        step, params, ema = self._best_snapshot
        logger.info("restoring best %s params from step %d", self.cfg.monitor, step)
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(params[n])
            if ema is not None:
                for n, t in ema.items():
                    self.ema[n].copy_(t)
        return True

    # -- the loop ------------------------------------------------------------

    def fit(self, datamodule, ckpt_path: Optional[str] = None) -> Dict[str, float]:
        """Train; returns the last validation metrics."""
        cfg = self.cfg
        self.model.train()
        train_loader = datamodule.train_dataloader()
        if ckpt_path:
            self.load_checkpoint(ckpt_path, resume=True)
        stop = False
        best, bad_epochs = float("inf"), 0
        final_metrics: Dict[str, float] = {}
        t_last = t_fit0 = time.perf_counter()
        mols = 0
        for epoch in range(cfg.max_epochs):
            for batch in train_loader:
                mols += int(batch.graph_mask.sum())
                metrics = self._train_step(batch.to(self.device))
                step = self.step
                if step % cfg.log_every_n_steps == 0:
                    now = time.perf_counter()
                    host = {k: float(v) for k, v in metrics.items()}
                    host["epoch"] = epoch
                    host["steps_per_sec"] = cfg.log_every_n_steps / max(now - t_last, 1e-9)
                    host["mols_per_sec"] = mols / max(now - t_last, 1e-9)
                    host["lr"] = current_learning_rate(self.optimizer)
                    self.loggers.log_metrics(host, step)
                    t_last, mols = now, 0
                if cfg.hist_every_n_steps and step % cfg.hist_every_n_steps == 0:
                    self.loggers.log_histograms(self.model.state_dict(), step)
                if cfg.val_every_n_steps and step % cfg.val_every_n_steps == 0:
                    mid = self.validate(datamodule.val_dataloader())
                    mid["epoch"] = epoch
                    self.loggers.log_metrics(mid, step)
                    final_metrics = mid
                    if mid.get(cfg.monitor) is not None:
                        self._on_monitored(mid[cfg.monitor])
                    if self.ckpt:
                        self.ckpt.save(self.state_dict(), step, mid, aux=self._ckpt_aux())
                    t_last, mols = time.perf_counter(), 0  # rates exclude validation
                if cfg.max_steps and step >= cfg.max_steps:
                    stop = True
                    break
                if cfg.max_seconds and time.perf_counter() - t_fit0 > cfg.max_seconds:
                    logger.info("stopping: max_seconds %.0f reached", cfg.max_seconds)
                    stop = True
                    break
                lr_now = current_learning_rate(self.optimizer)
                if cfg.stop_at_lr and lr_now < cfg.stop_at_lr:
                    logger.info("stopping: lr %.2e below floor", lr_now)
                    stop = True
                    break

            val_metrics = self.validate(datamodule.val_dataloader())
            val_metrics["epoch"] = epoch
            self.loggers.log_metrics(val_metrics, self.step)
            final_metrics = val_metrics
            monitored = val_metrics.get(cfg.monitor)
            if monitored is not None:
                self._on_monitored(monitored)
                if self.ckpt:
                    self.ckpt.save(self.state_dict(), self.step, val_metrics,
                                   aux=self._ckpt_aux())
                if monitored < best - 1e-12:
                    best, bad_epochs = monitored, 0
                    if cfg.keep_best_params:
                        self._snapshot()
                else:
                    bad_epochs += 1
                    if cfg.early_stopping_patience and bad_epochs > cfg.early_stopping_patience:
                        logger.info("early stopping at epoch %d", epoch)
                        stop = True
            elif self.ckpt:
                self.ckpt.save(self.state_dict(), self.step, val_metrics, aux=self._ckpt_aux())
            t_last, mols = time.perf_counter(), 0
            if stop:
                break
        logger.info("fit finished at step %d", self.step)
        return final_metrics
