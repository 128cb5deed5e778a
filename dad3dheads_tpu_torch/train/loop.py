"""The training loop. Mirrors ``dad3dheads_tpu/train/loop.py``: fit over
epochs with per-step losses and metrics, sanity validation before training,
validation every n epochs and optionally every n steps, top-k checkpoints on
the monitored metric (written by a writer thread with ``async_checkpoint``,
the default), plateau LR, early stopping, a SIGTERM/SIGINT save of ``last``,
evaluation of the best checkpoint, the inference export and, with
``export_aot``, the deployment artifact (``api/export.py``). Before training,
``auto_bs`` probes the largest batch that fits and ``auto_lr`` sweeps the
learning rate, each on a throwaway state.

The loop is host orchestration; every number is computed on the device by
the two steps, and metrics are summed there: one host read per epoch. The
scalars go to ``metrics.jsonl`` and to TensorBoard (``experiment_dir/tb``,
when ``tensorboard`` is installed), and every ``images_log_freq`` steps a
panel forward draws pred-vs-GT landmark and heatmap panels there, off the
step path.

With a ``mesh`` under ``torch.distributed`` (``cli.train distributed=true``,
one process per device), every rank runs the loop in lockstep on its share
of each global batch (the loader splits by data row); the steps average
gradients and logs over the data group, so every rank takes the same
decisions (validation, plateau, early stopping), and only rank 0 writes:
checkpoints, ``metrics.jsonl``, TensorBoard and the panels, the exports.
Batches reach the device through ``parallel.device_prefetch`` (pinned host
copies on a side stream on a card), with or without a mesh.
"""

from __future__ import annotations

import copy
import gc
import json
import logging
import math
import os
import signal
import sys
import time
import types
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..constants import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    INPUT_IMAGE_KEY,
    OUTPUT_2D_LANDMARKS,
    OUTPUT_LANDMARKS_HEATMAP,
    TARGET_2D_LANDMARKS,
)
from ..core.flame import FlameModel
from ..losses import LossModule
from ..parallel import (
    DATA_AXIS,
    data_group,
    device_prefetch,
    one_device_mesh,
    pad_batch_to_devices,
    put_global_batch,
    set_sync_bn,
)
from ..ops.preprocess import normalize_images
from ..precision import fp32_exact
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


def _tile(value: Any, reps: int, n: int) -> Any:
    """A batch entry repeated ``reps`` times along the batch and cut to
    ``n``: arrays and tensors are concatenated, lists (a loader batch's file
    names) repeated; anything else is kept."""
    if isinstance(value, np.ndarray):
        return np.concatenate([value] * reps, axis=0)[:n]
    if isinstance(value, torch.Tensor):
        return torch.cat([value] * reps, dim=0)[:n]
    if isinstance(value, list):
        return (value * reps)[:n]
    return value


# what an out-of-memory error says, in the JAX package's tuner and in torch's
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory", "OOM")


def _is_oom(error: BaseException) -> bool:
    return isinstance(error, torch.OutOfMemoryError) or any(m in repr(error) for m in _OOM_MARKERS)


_PANEL_ROWS = 8  # images per panel grid


class Trainer:
    """Orchestrates fit / validate / checkpoint / early stop for DAD-3DNet on
    one device, or on this rank's device of a distributed ``mesh``
    (``parallel.make_mesh``; then ``device`` is the mesh's)."""

    def __init__(
        self,
        config: Dict[str, Any],
        train_loader: Optional[Iterable] = None,
        val_loader: Optional[Iterable] = None,
        flame: Optional[FlameModel] = None,
        device: torch.device | str = "cuda",
        mesh=None,
    ):
        self.config = config
        if mesh is not None and len(mesh.local_devices) > 1:
            raise ValueError(f"{mesh}: the Trainer takes one data row per process; start one process per device "
                             "(torchrun ... cli.train distributed=true)")
        self.mesh = mesh if mesh is not None else one_device_mesh(device)
        self.device = self.mesh.local_device
        # under torch.distributed only rank 0 writes files
        self.is_writer = not self.mesh.distributed or torch.distributed.get_rank() == 0
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.flame = flame if flame is not None else FlameModel.load(device=self.device)

        if config.get("debug_nans"):
            from ..utils import enable_nan_debugging

            enable_nan_debugging()

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
            loss_module, self.img_size, self.warmup_steps, heatmap_stride=hm_stride, heatmap_radius=hm_radius,
            mesh=mesh,
        )
        self.eval_step = build_eval_step(
            loss_module, self.img_size, heatmap_stride=hm_stride, heatmap_radius=hm_radius, mesh=mesh
        )

        self.ckpt = CheckpointManager(
            os.path.join(self.experiment_dir, "checkpoints"),
            monitor=self.monitor if self.monitor.startswith("valid") else f"valid/{self.monitor}",
            mode=self.monitor_mode,
            save_top_k=int(config.get("save_top_k", 3)),
            # the device-to-host copy and the file IO overlap the next epoch
            async_save=bool(config.get("async_checkpoint", True)),
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
        # the tuners run in fit, before training; their results land here
        self.auto_lr = bool(config.get("auto_lr", False))
        self.auto_bs = bool(config.get("auto_bs", False))
        self.tuned_lr: Optional[float] = None
        self.tuned_batch_size: Optional[int] = None
        # pred-vs-GT panels every N steps (0: none), drawn on one worker
        # thread with at most 2 in flight; _drain_panels joins them
        self.images_log_freq = int(config.get("images_log_freq", 0))
        self._panel_pool: Optional[ThreadPoolExecutor] = None
        self._panel_futs: List[Future] = []
        self._tb = None if self.is_writer else False  # the SummaryWriter, made on first use; False: none
        self._log_file = open(os.path.join(self.experiment_dir, "metrics.jsonl"), "a") if self.is_writer else None

    # -- logging ----------------------------------------------------------
    def _tb_writer(self):
        """``torch.utils.tensorboard.SummaryWriter(experiment_dir/tb)``, made
        on first use; False where TensorBoard is not installed. TensorBoard
        writes event files through its own stub of TensorFlow's file API when
        its ``notf`` module is present, as in its TensorFlow-free build;
        without it, it imports TensorFlow where that is installed, which
        takes seconds and a GiB and which an event file does not need."""
        if self._tb is None:
            sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self._tb = False
            else:
                self._tb = SummaryWriter(os.path.join(self.experiment_dir, "tb"))
        return self._tb

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if not self.is_writer:
            return
        tb = self._tb_writer()
        if tb:
            for k, v in metrics.items():
                tb.add_scalar(k, v, step)
        self._log_file.write(json.dumps({"step": step, **metrics}) + "\n")
        self._log_file.flush()

    @torch.no_grad()
    def panel_forward(self, state: TrainState, batch: Dict[str, Any]) -> Tuple[torch.Tensor, ...]:
        """The panels' device work on the batch's first 8 rows: the network
        in eval mode, in the eval step's precision (uint8 images through the
        normalize kernel), reduced to the uint8 images, the uint8
        max-over-channels heatmap probability (n, h, w, 1) and the packed
        (n, 2K) pred + GT landmarks. The model is back in its mode after."""
        images = batch[INPUT_IMAGE_KEY]
        n = min(_PANEL_ROWS, int(images.shape[0]))
        img = images[:n]
        was_training = state.model.training
        state.model.eval()
        try:
            with fp32_exact():
                x = normalize_images(img.contiguous()) if img.dtype == torch.uint8 else img
                out = state.model(x)
        finally:
            state.model.train(was_training)
        if img.dtype == torch.uint8:
            img_u8 = img
        else:
            d = img.float()
            norm_mode = self.config.get("normalize", "imagenet")
            if norm_mode == "imagenet":
                d = d * torch.tensor(IMAGENET_STD, device=d.device) + torch.tensor(IMAGENET_MEAN, device=d.device)
            elif norm_mode == "mean":
                d = d * 0.5 + 0.5
            img_u8 = torch.clamp(d * 255.0, 0, 255).to(torch.uint8)
        probs = torch.sigmoid(out[OUTPUT_LANDMARKS_HEATMAP].float()).amax(dim=-1, keepdim=True)
        hm_u8 = torch.round(probs * 255.0).to(torch.uint8)
        pred = out[OUTPUT_2D_LANDMARKS].float().reshape(n, -1)
        gt = batch[TARGET_2D_LANDMARKS][:n].float().reshape(n, -1)
        # the host splits the packed buffer at its midpoint
        if pred.shape[-1] != gt.shape[-1]:
            raise ValueError(f"panel landmark count mismatch: the model predicts {pred.shape[-1] // 2} "
                             f"landmarks but the batch carries {gt.shape[-1] // 2}")
        return img_u8, hm_u8, torch.cat([pred, gt], dim=-1)

    def log_image_panels(self, state: TrainState, batch: Dict[str, Any], step: int) -> None:
        """TensorBoard pred-vs-GT landmark and heatmap-overlay panels on the
        current device batch. The panel forward runs only at log steps; its
        three outputs come back in one copy into pinned memory, and one
        worker thread waits for it and draws."""
        tb = self._tb_writer()
        if not tb:
            return
        from .visualization import heatmap_panel_from_batch, landmarks_panel_from_batch

        img_u8, hm_u8, lmks = self.panel_forward(state, batch)
        shapes = (img_u8.shape, hm_u8.shape, lmks.shape)
        packed = torch.cat([img_u8.reshape(-1), hm_u8.reshape(-1), lmks.reshape(-1).view(torch.uint8)])
        event = None
        if packed.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = packed
        normalize = self.config.get("normalize", "imagenet")
        img_size = self.img_size

        def draw_and_write():
            if event is not None:
                event.synchronize()
            flat = host.numpy()
            cuts = np.cumsum([int(np.prod(shapes[0])), int(np.prod(shapes[1]))])
            img = flat[: cuts[0]].reshape(shapes[0])
            hm = flat[cuts[0] : cuts[1]].reshape(shapes[1])
            packed_lmks = flat[cuts[1] :].view(np.float32).reshape(shapes[2])
            n, k = packed_lmks.shape[0], packed_lmks.shape[1] // 2
            host_batch = {INPUT_IMAGE_KEY: img, TARGET_2D_LANDMARKS: packed_lmks[:, k:].reshape(n, -1, 2)}
            host_out = {OUTPUT_2D_LANDMARKS: packed_lmks[:, :k].reshape(n, -1, 2), OUTPUT_LANDMARKS_HEATMAP: hm}
            tb.add_image("train/landmarks", landmarks_panel_from_batch(host_batch, host_out, img_size,
                                                                       normalize=normalize),
                         step, dataformats="HWC")
            tb.add_image("train/heatmap", heatmap_panel_from_batch(host_batch, host_out, normalize=normalize),
                         step, dataformats="HWC")

        if self._panel_pool is None:
            self._panel_pool = ThreadPoolExecutor(1, thread_name_prefix="tb-panels")
        self._panel_futs = [f for f in self._panel_futs if not f.done()]
        while len(self._panel_futs) >= 2:  # bound the pinned buffers held
            self._panel_futs.pop(0).result()
        self._panel_futs.append(self._panel_pool.submit(draw_and_write))

    def _drain_panels(self) -> None:
        """Join the panel writes in flight; re-raises a worker's error."""
        futs, self._panel_futs = self._panel_futs, []
        for f in futs:
            f.result()

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

    def _on_mesh(self, state: TrainState) -> TrainState:
        """``state`` with its BatchNorms over the mesh's data group (the
        global batch's statistics; nothing changes without one)."""
        set_sync_bn(state.model, data_group(self.mesh))
        return state

    def _batches(self, loader: Iterable):
        """The loader's batches on this process's device (its one data row)."""
        return device_prefetch(loader, self.mesh)

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

    # -- auto-tuners --------------------------------------------------------
    def _fresh_state(self, seed: int = 17) -> TrainState:
        """A throwaway state for the tuners: the train step updates its state
        in place, so they never touch the one fit trains."""
        return self._on_mesh(init_train_state(self.config.get("model", {}), self.opt_cfg,
                                              torch.Generator().manual_seed(seed), self.device,
                                              self.gradient_clip_val))

    def tune_lr(self, num_steps: int = 60, min_lr: float = 1e-6, max_lr: float = 1.0, beta: float = 0.9) -> float:
        """LR-range test: up to ``num_steps`` train steps on a throwaway state
        with the learning rate swept geometrically from ``min_lr`` to
        ``max_lr``, tracking the bias-corrected EMA of the loss; the sweep
        stops at a non-finite loss or once the smoothed loss passes 4x its
        best. Suggests the learning rate at the steepest descent of the
        smoothed curve (the base rate when fewer than 4 steps were finite).
        Never mutates the trainer; ``fit`` applies the suggestion as a
        multiplier of the base rate."""
        if self.train_loader is None:
            raise ValueError("tune_lr requires a train_loader")
        state = self._fresh_state()
        lrs = np.geomspace(min_lr, max_lr, num_steps)
        losses: List[float] = []
        avg, best = 0.0, math.inf

        def batches():
            while True:
                yield from self._batches(self.train_loader)

        for i, batch in zip(range(num_steps), batches()):
            # cancel the step's linear warmup, so that exactly lrs[i] applies
            wu = min(1.0, (i + 1.0) / self.warmup_steps) if self.warmup_steps > 0 else 1.0
            logs = self.train_step(state, self.flame, batch, lrs[i] / (self.base_lr * wu))
            loss = float(logs["loss"])
            if not math.isfinite(loss):
                break
            avg = beta * avg + (1.0 - beta) * loss
            smoothed = avg / (1.0 - beta ** (i + 1))
            if losses and smoothed > 4.0 * best:
                break  # diverged: the sweep has passed the useful range
            best = min(best, smoothed)
            losses.append(smoothed)
        del state
        if len(losses) < 4:
            logger.warning("tune_lr: only %d finite steps, keeping the base lr %.3g", len(losses), self.base_lr)
            return self.base_lr
        k = int(np.argmin(np.gradient(np.asarray(losses))))
        suggested = float(lrs[k])
        logger.info("tune_lr: suggested lr %.3g after %d steps (smoothed loss %.4f)", suggested, len(losses),
                    losses[k])
        return suggested

    def _probe(self, sample: Dict[str, Any], bs0: int, bs: int) -> None:
        """One train step at this process's batch ``bs`` (its first loader
        batch, of ``bs0`` rows, tiled) on a throwaway state; returns once the
        card has run it."""
        reps = -(-bs // bs0)
        (probe,) = put_global_batch({k: _tile(v, reps, bs) for k, v in sample.items()}, self.mesh)
        state = self._fresh_state()
        logs = self.train_step(state, self.flame, probe, 1.0)
        float(logs["loss"])

    def tune_batch_size(self, max_trials: int = 6, max_batch_size: int = 8192) -> int:
        """Batch-size probe: doubles the global batch from the loader's own
        size, padded to a multiple of the mesh's data rows
        (``pad_batch_to_devices``), one train step per probe on a throwaway
        state, until a step runs out of memory or the cap is reached; returns
        the largest global batch that ran (the loader's own when none did).
        Under ``torch.distributed`` each rank probes its share in lockstep,
        and a rank that runs out of memory alone leaves the others waiting
        in a collective until the process group's timeout. Errors other than
        running out of memory propagate."""
        if self.train_loader is None:
            raise ValueError("tune_batch_size requires a train_loader")
        sample = next(iter(self.train_loader))
        local0 = int(next(v for v in sample.values() if isinstance(v, (np.ndarray, torch.Tensor))).shape[0])
        rows = self.mesh.shape[DATA_AXIS] if self.mesh.distributed else 1  # processes sharing a batch
        bs0 = local0 * rows
        good: Optional[int] = None
        bs = bs0
        for _ in range(max_trials):
            out_of_memory = False
            bs = pad_batch_to_devices(bs, self.mesh)
            try:
                self._probe(sample, local0, bs // rows)
                good = bs
                logger.info("tune_batch_size: batch %d fits", bs)
            except Exception as e:  # noqa: BLE001 -- only running out of memory is expected
                if not _is_oom(e):
                    raise
                out_of_memory = True
            if out_of_memory:
                # the error's frames held the probe's tensors; with them gone,
                # give their blocks back before the real fit allocates
                gc.collect()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
                logger.info("tune_batch_size: batch %d runs out of memory, stopping", bs)
                break
            if bs * 2 > max_batch_size:
                break
            bs *= 2
        return good if good is not None else bs0

    def _best_path(self) -> Optional[str]:
        """The best top-k checkpoint's path (rank 0's, which every rank of a
        distributed mesh receives once it is on disk), or None."""
        best = self.ckpt.best if self.is_writer else None
        path = best["path"] if best is not None else None
        if self.mesh.distributed:
            holder = [path]
            torch.distributed.broadcast_object_list(holder, src=0)
            path = holder[0]
        return path

    # -- fit ---------------------------------------------------------------
    def fit(self, state: Optional[TrainState] = None, resume: bool = False) -> TrainState:
        state = self._on_mesh(state if state is not None else self.init_state())
        if resume:
            try:
                self.ckpt.restore_last(state)
                logger.info("resumed from last checkpoint at step %d", state.step)
            except FileNotFoundError:
                logger.info("no checkpoint to resume from; starting fresh")
        lr_mult = 1.0
        if self.auto_bs and self.train_loader is not None:
            self.tuned_batch_size = self.tune_batch_size(
                max_trials=int(self.config.get("auto_bs_max_trials", 6)),
                max_batch_size=int(self.config.get("auto_bs_max", 8192)),
            )
            for loader in (self.train_loader, self.val_loader):
                if loader is not None and hasattr(loader, "set_batch_size"):
                    loader.set_batch_size(self.tuned_batch_size)
            logger.info("auto_bs: using batch size %d", self.tuned_batch_size)
        if self.auto_lr and self.train_loader is not None:
            self.tuned_lr = self.tune_lr(num_steps=int(self.config.get("auto_lr_steps", 60)))
            # a multiplier of the base rate, so that the plateau and the
            # schedule compose with it unchanged
            lr_mult = self.tuned_lr / self.base_lr
            logger.info("auto_lr: lr %.3g (multiplier %.3g of the base %.3g)", self.tuned_lr, lr_mult, self.base_lr)
        # dropout, after the tuners: their steps do not move the fit's stream
        torch.manual_seed(int(self.config.get("seed", 0)) + 1)

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
                    if self.images_log_freq and host_step % self.images_log_freq == 0 and self.is_writer:
                        self.log_image_panels(state, batch, host_step)
                    if val_interval and host_step % val_interval == 0:
                        mid_val = self._validate(state)
                        self.log_metrics(mid_val, host_step)
                        mv = mid_val.get(self.ckpt.monitor, math.nan)
                        if math.isfinite(mv) and (best_seen is None or self.ckpt.is_better(mv, best_seen)):
                            best_seen = mv
                            if self.is_writer:
                                self.ckpt.hold(state, epoch, {self.ckpt.monitor: mv, **mid_val})
                    if preempted["flag"]:
                        break
                if preempted["flag"]:
                    if self.is_writer:
                        self.ckpt.save(state, epoch, {})
                        self.ckpt.flush_held()
                        self.ckpt.flush()
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
                if saved and self.is_writer:
                    self.ckpt.save(state, epoch, {self.ckpt.monitor: monitored, **epoch_metrics})
                elif improved and self.is_writer:
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
                    if not saved and self.is_writer:
                        self.ckpt.save(state, epoch, {})  # refresh last for resume
                    break
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
            # held best epochs reach disk even when fit raises
            if self.is_writer:
                self.ckpt.flush_held()
            try:
                self._drain_panels()
            except Exception:  # noqa: BLE001 -- do not mask an exception of fit's
                logger.exception("image-panel writer failed")

        # export the best checkpoint by the monitored metric, else the final
        # state; the best is loaded into a copy, so fit returns the final one
        self.ckpt.flush()  # the write in flight, before the best is read
        export_state = state
        best_path = self._best_path()
        if best_path is not None:
            export_state = self.ckpt.restore(TrainState(copy.deepcopy(state.model), state.optimizer, state.step,
                                                        state.epoch), best_path)
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
        if not self.is_writer:
            return state
        export_path = self.ckpt.export_inference(export_state)
        logger.info("exported inference checkpoint to %s", export_path)
        if self.config.get("export_aot", False):
            # the deployment artifact beside it, with programs for this device and the CPU
            from ..api.export import SUFFIX, export_predictor

            aot_path = export_path.rsplit(".", 1)[0] + SUFFIX
            export_predictor(export_state.model, self.flame, aot_path, img_size=self.img_size,
                             devices=tuple(dict.fromkeys((self.device.type, "cpu"))))
            logger.info("exported the deployment artifact to %s", aot_path)
        if self._tb:
            self._tb.flush()
        return state
