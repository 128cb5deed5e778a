"""The training loop. Mirrors ``dad3dheads_tpu/train/loop.py``: fit over
epochs with per-step losses and metrics, sanity validation before training,
validation every n epochs and optionally every n steps, top-k checkpoints on
the monitored metric, plateau LR, early stopping, a SIGTERM/SIGINT save of
``last``, evaluation of the best checkpoint, the inference export and, with
``export_aot``, the deployment artifact (``api/export.py``).

The loop is host orchestration; every number is computed on the device by
the two steps, and metrics are summed there: one host read per epoch. Not
ported yet (ROADMAP queue 1, "The rest of training"): ``auto_lr`` and ``auto_bs`` (refused)
and TensorBoard, scalars and image panels (``images_log_freq`` logs a
warning); the scalars go to ``metrics.jsonl``.
"""

from __future__ import annotations

import copy
import json
import logging
import math
import os
import signal
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..core.flame import FlameModel
from ..losses import LossModule
from .checkpoint import CheckpointManager
from .schedulers import EarlyStopping, ReduceLROnPlateau, get_schedule
from .state import TrainState, init_train_state
from .step import build_eval_step, build_train_step

logger = logging.getLogger(__name__)


class MetricAccumulator:
    """Sums per-step log scalars on the device (one stacked add per step);
    ``means()`` reads them to the host once."""

    def __init__(self):
        self._keys: List[str] = []
        self._sums: Optional[torch.Tensor] = None
        self._n = 0

    def add(self, logs: Dict[str, torch.Tensor]) -> None:
        values = torch.stack([v.float() for v in logs.values()])
        if self._sums is None:
            self._keys, self._sums = list(logs), values
        else:
            self._sums = self._sums + values
        self._n += 1

    def means(self) -> Dict[str, float]:
        if self._sums is None:
            return {}
        return {k: v / self._n for k, v in zip(self._keys, self._sums.cpu().tolist())}


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Arrays and tensors to the device; other values (a loader batch's
    lists of sample indices and file names) stay on the host as they are."""
    return {
        k: torch.as_tensor(v).to(device, non_blocking=True) if isinstance(v, (np.ndarray, torch.Tensor)) else v
        for k, v in batch.items()
    }


class Trainer:
    """Orchestrates fit / validate / checkpoint / early stop for DAD-3DNet on
    one device."""

    def __init__(
        self,
        config: Dict[str, Any],
        train_loader: Optional[Iterable] = None,
        val_loader: Optional[Iterable] = None,
        flame: Optional[FlameModel] = None,
        device: torch.device | str = "cuda",
    ):
        self.config = config
        self.device = torch.device(device)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.flame = flame if flame is not None else FlameModel.load(device=self.device)

        for key in ("auto_lr", "auto_bs"):
            if config.get(key):
                raise NotImplementedError(f"{key} is not ported yet (ROADMAP queue 1, 'The rest of training')")
        if config.get("images_log_freq"):
            logger.warning(
                "images_log_freq=%s: TensorBoard and its image panels are not ported yet (ROADMAP queue "
                "1, 'The rest of training'); the scalars go to metrics.jsonl", config["images_log_freq"],
            )
        if config.get("debug_nans"):
            torch.autograd.set_detect_anomaly(True, check_nan=True)

        self.img_size = int(config.get("img_size", 256))
        self.max_epochs = int(config.get("max_epochs", 100))
        self.min_epochs = int(config.get("min_epochs", 0))
        self.monitor = config.get("metric_to_monitor", "metrics/reproject_nme_2d")
        self.monitor_mode = config.get("metric_mode", "min")
        self.experiment_dir = config.get("experiment_dir", "experiments/run")
        os.makedirs(self.experiment_dir, exist_ok=True)

        self.opt_cfg = dict(config.get("optimizer", {"name": "adam", "lr": 1e-4}))
        self.base_lr = float(self.opt_cfg.get("lr", 1e-4))
        sched_cfg = config.get("scheduler", {}) or {}
        self.warmup_steps = int(sched_cfg.get("warmup_steps", 0))
        self.schedule = get_schedule(sched_cfg, base_lr=1.0)  # a factor
        self.plateau = (
            ReduceLROnPlateau(
                mode=self.monitor_mode,
                factor=float(sched_cfg.get("factor", 0.5)),
                patience=int(sched_cfg.get("patience", 8)),
            )
            if sched_cfg.get("name") == "plateau"
            else None
        )
        self.early_stopping = (
            EarlyStopping(patience=int(config["early_stopping"]), mode=self.monitor_mode)
            if config.get("early_stopping")
            else None
        )
        self.gradient_clip_val = float(config.get("gradient_clip_val", 0.0))

        loss_module = LossModule(config.get("loss"))
        hm_stride = int(config.get("stride", 4))
        hm_radius = int(config.get("radius", 5))
        self.train_step = build_train_step(
            loss_module, self.img_size, self.warmup_steps, heatmap_stride=hm_stride, heatmap_radius=hm_radius
        )
        self.eval_step = build_eval_step(
            loss_module, self.img_size, heatmap_stride=hm_stride, heatmap_radius=hm_radius
        )

        self.ckpt = CheckpointManager(
            os.path.join(self.experiment_dir, "checkpoints"),
            monitor=self.monitor if self.monitor.startswith("valid") else f"valid/{self.monitor}",
            mode=self.monitor_mode,
            save_top_k=int(config.get("save_top_k", 3)),
        )
        self.checkpoint_every_n_epochs = int(config.get("checkpoint_every_n_epochs", 1))
        self.sanity_val_steps = int(config.get("sanity_val_steps", 2))
        self.val_check_interval = config.get("val_check_interval")
        if isinstance(self.val_check_interval, float) and not 0.0 < self.val_check_interval <= 1.0:
            raise ValueError(
                f"val_check_interval={self.val_check_interval}: a float must be a fraction of an epoch in "
                "(0, 1]; pass an int for a step count"
            )
        self.check_val_every_n_epoch = int(config.get("check_val_every_n_epoch", 1))
        if self.check_val_every_n_epoch < 1:
            raise ValueError(f"check_val_every_n_epoch={self.check_val_every_n_epoch}: must be >= 1")
        self._log_file = open(os.path.join(self.experiment_dir, "metrics.jsonl"), "a")

    # -- logging ----------------------------------------------------------
    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        self._log_file.write(json.dumps({"step": step, **metrics}) + "\n")
        self._log_file.flush()

    # -- state -------------------------------------------------------------
    def init_state(self) -> TrainState:
        """A fresh state from the config's model and optimizer, its weights
        drawn from a CPU generator seeded with ``seed``."""
        return init_train_state(
            self.config.get("model", {}),
            self.opt_cfg,
            torch.Generator().manual_seed(int(self.config.get("seed", 0))),
            self.device,
            self.gradient_clip_val,
        )

    def _batches(self, loader: Iterable):
        for batch in loader:
            yield _to_device(batch, self.device)

    # -- validation --------------------------------------------------------
    def _validate(self, state: TrainState, max_steps: Optional[int] = None) -> Dict[str, float]:
        """The eval step over the val loader (optionally only its first
        ``max_steps`` batches): ``valid/*`` means."""
        vacc = MetricAccumulator()
        for i, batch in enumerate(self._batches(self.val_loader)):
            if max_steps is not None and i >= max_steps:
                break
            vacc.add(self.eval_step(state, self.flame, batch))
        return {f"valid/{k}": v for k, v in vacc.means().items()}

    def _resolve_val_interval(self, steps_per_epoch: Optional[int]) -> Optional[int]:
        """val_check_interval in train steps: ints pass through; a float
        fraction needs the epoch's length (None until epoch 1 ends)."""
        v = self.val_check_interval
        if v is None or self.val_loader is None:
            return None
        if isinstance(v, float):
            return None if steps_per_epoch is None else max(1, int(steps_per_epoch * v))
        return max(1, int(v))

    # -- fit ---------------------------------------------------------------
    def fit(self, state: Optional[TrainState] = None, resume: bool = False) -> TrainState:
        if state is None:
            state = self.init_state()
        if resume:
            try:
                self.ckpt.restore_last(state)
                logger.info("resumed from last checkpoint at step %d", state.step)
            except FileNotFoundError:
                logger.info("no checkpoint to resume from; starting fresh")
        torch.manual_seed(int(self.config.get("seed", 0)) + 1)  # dropout
        lr_mult = 1.0

        preempted = {"flag": False}

        def _on_signal(signum, frame):
            logger.warning("signal %d received: checkpointing and stopping", signum)
            preempted["flag"] = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _on_signal)
            except ValueError:  # not the main thread
                pass

        host_step = state.step
        steps_per_epoch: Optional[int] = None
        best_seen = self.ckpt.best_value()
        try:
            if self.val_loader is not None and self.sanity_val_steps > 0:
                self._validate(state, max_steps=self.sanity_val_steps)
                logger.info("sanity validation (%d steps) passed", self.sanity_val_steps)

            for epoch in range(state.epoch, self.max_epochs):
                state.epoch = epoch
                t0 = time.time()
                acc = MetricAccumulator()
                n_batches = 0
                sched_factor = float(self.schedule(epoch)) if self.schedule else 1.0
                val_interval = self._resolve_val_interval(steps_per_epoch)
                for batch in self._batches(self.train_loader):
                    host_step += 1
                    acc.add(self.train_step(state, self.flame, batch, lr_mult * sched_factor))
                    n_batches += 1
                    if val_interval and host_step % val_interval == 0:
                        mid_val = self._validate(state)
                        self.log_metrics(mid_val, host_step)
                        mv = mid_val.get(self.ckpt.monitor, math.nan)
                        if math.isfinite(mv) and (best_seen is None or self.ckpt.is_better(mv, best_seen)):
                            best_seen = mv
                            self.ckpt.hold(state, epoch, {self.ckpt.monitor: mv, **mid_val})
                    if preempted["flag"]:
                        break
                if preempted["flag"]:
                    self.ckpt.save(state, epoch, {})
                    self.ckpt.flush_held()
                    logger.info("preemption checkpoint saved at step %d", host_step)
                    break
                train_metrics = {f"train/{k}": v for k, v in acc.means().items()}
                steps_per_epoch = n_batches

                val_metrics: Dict[str, float] = {}
                if self.val_loader is not None and (epoch + 1) % self.check_val_every_n_epoch == 0:
                    val_metrics = self._validate(state)

                # the LR applied this epoch: base * plateau * schedule * warmup
                warmup = min(1.0, (host_step + 1.0) / self.warmup_steps) if self.warmup_steps > 0 else 1.0
                epoch_metrics = {
                    **train_metrics, **val_metrics,
                    "train/learning_rate": self.base_lr * lr_mult * sched_factor * warmup,
                }
                self.log_metrics(epoch_metrics, state.step)
                logger.info(
                    "epoch %d done in %.1fs (%d batches): loss=%.4f %s",
                    epoch, time.time() - t0, n_batches, epoch_metrics.get("train/loss", math.nan),
                    {k: round(v, 4) for k, v in val_metrics.items() if "nme" in k},
                )

                monitored = epoch_metrics.get(self.ckpt.monitor, epoch_metrics.get("train/loss", math.nan))
                improved = math.isfinite(monitored) and (
                    best_seen is None or self.ckpt.is_better(monitored, best_seen)
                )
                if improved:
                    best_seen = monitored
                saved = (epoch + 1) % self.checkpoint_every_n_epochs == 0 or epoch + 1 >= self.max_epochs
                if saved:
                    self.ckpt.save(state, epoch, {self.ckpt.monitor: monitored, **epoch_metrics})
                elif improved:
                    self.ckpt.hold(state, epoch, {self.ckpt.monitor: monitored, **epoch_metrics})

                if self.plateau is not None and math.isfinite(monitored):
                    lr_mult = self.plateau.step(monitored, self.base_lr * lr_mult)
                if (
                    self.early_stopping is not None
                    and epoch + 1 >= self.min_epochs
                    and math.isfinite(monitored)
                    and self.early_stopping.step(monitored)
                ):
                    logger.info("early stopping at epoch %d", epoch)
                    if not saved:
                        self.ckpt.save(state, epoch, {})  # refresh last for resume
                    break
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
            self.ckpt.flush_held()

        # export the best checkpoint by the monitored metric, else the final
        # state; the best is loaded into a copy, so fit returns the final one
        export_state = state
        if self.ckpt.best is not None:
            export_state = self.ckpt.restore(TrainState(copy.deepcopy(state.model), state.optimizer, state.step,
                                                        state.epoch))
            if self.val_loader is not None and self.config.get("eval_best", True):
                bacc = MetricAccumulator()
                for batch in self._batches(self.val_loader):
                    bacc.add(self.eval_step(export_state, self.flame, batch))
                best_metrics = {f"best/{k}": v for k, v in bacc.means().items()}
                self.log_metrics(best_metrics, host_step)
                logger.info(
                    "best-checkpoint eval: %s",
                    {k: round(v, 4) for k, v in best_metrics.items() if "nme" in k or k == "best/loss"},
                )
        export_path = self.ckpt.export_inference(export_state)
        logger.info("exported inference checkpoint to %s", export_path)
        if self.config.get("export_aot", False):
            # the deployment artifact beside it, with programs for this device and the CPU
            from ..api.export import SUFFIX, export_predictor

            aot_path = export_path.rsplit(".", 1)[0] + SUFFIX
            export_predictor(export_state.model, self.flame, aot_path, img_size=self.img_size,
                             devices=tuple(dict.fromkeys((self.device.type, "cpu"))))
            logger.info("exported the deployment artifact to %s", aot_path)
        return state
