"""LR schedules, on the host. Mirrors ``dad3dheads_tpu/train/schedulers.py``
with the same numbers: epoch-granular factor schedules (multi_step,
exponential, cosine, cyclic, flat_cosine, as optax computes them), the linear
warmup of the train step, and the host-side ``ReduceLROnPlateau`` and
``EarlyStopping`` state machines.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional


def flat_cosine_schedule(base_lr: float, t_max: int, t_flat: int, eta_min: float = 0.0) -> Callable[[float], float]:
    """Flat at base_lr for t_flat epochs, then cosine anneal to eta_min by
    t_max."""

    def schedule(epoch) -> float:
        e = float(epoch)
        prog = min(max((e - t_flat) / max(t_max - t_flat, 1), 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * prog))
        return base_lr if e <= t_flat else eta_min + (base_lr - eta_min) * cos

    return schedule


def _piecewise_constant(base_lr: float, boundaries: Dict[int, float]) -> Callable[[float], float]:
    """optax.piecewise_constant_schedule: times each scale once step >= its
    boundary."""

    def schedule(step) -> float:
        v = base_lr
        for b in sorted(boundaries):
            if step >= b:
                v *= boundaries[b]
        return v

    return schedule


def _exponential(base_lr: float, transition_steps: int, decay_rate: float) -> Callable[[float], float]:
    """optax.exponential_decay (continuous, from step 0)."""

    def schedule(step) -> float:
        if step <= 0:
            return base_lr
        return base_lr * decay_rate ** (float(step) / transition_steps)

    return schedule


def _cosine(base_lr: float, decay_steps: int, alpha: float) -> Callable[[float], float]:
    """optax.cosine_decay_schedule."""

    def schedule(step) -> float:
        s = min(float(step), decay_steps)
        cos = 0.5 * (1.0 + math.cos(math.pi * s / decay_steps))
        return base_lr * ((1.0 - alpha) * cos + alpha)

    return schedule


def _triangular_cyclic(base_lr: float, max_lr: float, step_size_up: int) -> Callable[[float], float]:
    """torch CyclicLR 'triangular' mode."""

    def schedule(step) -> float:
        s = float(step)
        cycle = math.floor(1 + s / (2 * step_size_up))
        x = abs(s / step_size_up - 2 * cycle + 1)
        return base_lr + (max_lr - base_lr) * max(0.0, 1.0 - x)

    return schedule


def get_schedule(
    config: Optional[Dict[str, Any]], base_lr: float, steps_per_epoch: int = 1
) -> Optional[Callable[[float], float]]:
    """Epoch-granular schedule from a config dict (name + params):
    ``schedule(epoch) -> lr``. None for no schedule and for 'plateau' (the
    host-side :class:`ReduceLROnPlateau`)."""
    if not config:
        return None
    config = dict(config)
    config.pop("warmup_steps", None)
    name = config.pop("name", None)
    if name is None or name == "plateau":
        return None
    if name == "multi_step":
        gamma = config.get("gamma", 0.1)
        return _piecewise_constant(base_lr, {int(m) * steps_per_epoch: gamma for m in config.get("milestones", [])})
    if name == "exponential":
        return _exponential(base_lr, steps_per_epoch, config.get("gamma", 0.95))
    if name == "cosine":
        eta_min = config.get("eta_min", 0.0)
        return _cosine(base_lr, config.get("T_max", 100) * steps_per_epoch, eta_min / max(base_lr, 1e-12))
    if name == "cyclic":
        return _triangular_cyclic(
            config.get("base_lr", base_lr * 0.1), config.get("max_lr", base_lr), config.get("step_size_up", 2000)
        )
    if name == "flat_cosine":
        return flat_cosine_schedule(
            base_lr,
            t_max=config.get("T_max", 100) * steps_per_epoch,
            t_flat=config.get("T_flat", 0) * steps_per_epoch,
            eta_min=config.get("eta_min", 0.0),
        )
    raise KeyError(f"Unsupported scheduler {name!r}")


def warmup_factor(step: int, warmup_steps: int) -> float:
    """Linear warmup multiplier min(1, (step + 1) / warmup_steps)."""
    if warmup_steps <= 0:
        return 1.0
    return min(1.0, (float(step) + 1.0) / warmup_steps)


class ReduceLROnPlateau:
    """Multiplies the LR by ``factor`` after ``patience`` epochs without
    improvement of the monitored metric (torch semantics; the reference's
    defaults patience 8, factor 0.5)."""

    def __init__(
        self,
        mode: str = "min",
        factor: float = 0.5,
        patience: int = 8,
        min_lr: float = 0.0,
        threshold: float = 1e-4,
    ):
        if mode not in ("min", "max"):
            raise ValueError(mode)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.multiplier = 1.0

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best * (1.0 - self.threshold)
        return value > self.best * (1.0 + self.threshold)

    def step(self, value: float, current_lr: float) -> float:
        """Record an epoch metric; returns the new LR multiplier."""
        if self._improved(value):
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                if current_lr * self.factor >= self.min_lr:
                    self.multiplier = self.multiplier * self.factor
                self.bad_epochs = 0
        return self.multiplier


class EarlyStopping:
    """Stop after ``patience`` epochs without improvement."""

    def __init__(self, patience: int = 10, mode: str = "min", min_delta: float = 0.0):
        if mode not in ("min", "max"):
            raise ValueError(mode)
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def step(self, value: float) -> bool:
        """Returns True if training should stop."""
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best - self.min_delta)
            or (self.mode == "max" and value > self.best + self.min_delta)
        )
        if improved:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return self.bad_epochs >= self.patience
