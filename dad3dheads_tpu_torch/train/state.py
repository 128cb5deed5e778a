"""TrainState: everything a training step mutates. Mirrors
``dad3dheads_tpu/train/state.py``: the model (parameters and BN running
statistics), the optimizer (with its state), the global step and the epoch
that drives the loss schedule. PyTorch updates them in place."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..models import DAD3DNet, create_model
from .optimizers import Optimizer, get_optimizer


@dataclasses.dataclass
class TrainState:
    model: DAD3DNet
    optimizer: Optimizer
    step: int = 0  # global optimizer step
    epoch: int = 0  # current epoch

    def state_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "epoch": self.epoch,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step, self.epoch = int(state["step"]), int(state["epoch"])


def init_train_state(
    model_config: Optional[Dict[str, Any]],
    optimizer_config: Optional[Dict[str, Any]],
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cuda",
    gradient_clip_val: float = 0.0,
) -> TrainState:
    """A fresh state: DAD-3DNet with the JAX package's initialisation drawn
    from ``generator`` (a CPU generator: the same weights on every device),
    on ``device``, and its optimizer."""
    model = create_model(model_config, generator).to(device)
    return TrainState(model, get_optimizer(optimizer_config, model.parameters(), gradient_clip_val=gradient_clip_val))
