"""Optimizer factory on ``torch.optim``. Mirrors
``dad3dheads_tpu/train/optimizers.py``: adam, adamw and sgd (with optional
weight decay) and radam, from a config dict with the JAX package's keys and
defaults, with gradient clipping by global norm in front, as the JAX package
chains ``optax.clip_by_global_norm``.

Every update of the JAX train step is scaled by ``warmup_factor(step) *
lr_mult``; for each of these optimizers that equals running that step at the
base learning rate times the factor, which is what :meth:`Optimizer.step`
does.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: every gradient times
    max_norm / norm when norm >= max_norm, untouched otherwise. Returns the
    norm before clipping. No host sync: the choice is a ``where`` on the
    device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if max_norm and max_norm > 0:
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """A ``torch.optim`` optimizer with global-norm clipping in front and a
    per-step learning-rate factor."""

    def __init__(self, optimizer: torch.optim.Optimizer, gradient_clip_val: float = 0.0):
        self.optimizer = optimizer
        self.gradient_clip_val = float(gradient_clip_val or 0.0)
        self.base_lrs = [group["lr"] for group in optimizer.param_groups]

    @property
    def params(self):
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, scale: float = 1.0) -> torch.Tensor:
        """Clip, then update at lr * ``scale``. A parameter the loss did not
        reach gets a zero gradient, as in optax. Returns the global gradient
        norm before clipping (``optax.global_norm(grads)``)."""
        params = self.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in params], self.gradient_clip_val)
        for group, lr in zip(self.optimizer.param_groups, self.base_lrs):
            group["lr"] = lr * float(scale)
        self.optimizer.step()
        return norm

    def state_dict(self) -> Dict[str, Any]:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state)  # step() sets each group's lr from base_lrs


def get_optimizer(
    config: Optional[Dict[str, Any]],
    params: Iterable[torch.nn.Parameter],
    learning_rate: Optional[float] = None,
    gradient_clip_val: float = 0.0,
) -> Optimizer:
    """Build the optimizer from a config dict.

    config keys: name (adam|adamw|sgd|radam), lr, weight_decay, momentum,
    nesterov, eps, betas; ``learning_rate`` overrides config["lr"]. ``lamb``
    has no ``torch.optim`` counterpart and is not ported yet."""
    config = dict(config or {})
    name = config.pop("name", "adam").lower()
    lr = float(learning_rate if learning_rate is not None else config.pop("lr", 1e-4))
    weight_decay = float(config.pop("weight_decay", 0.0))
    eps = float(config.pop("eps", 1e-8))
    betas = tuple(float(b) for b in config.pop("betas", (0.9, 0.999)))
    momentum = float(config.pop("momentum", 0.9))
    nesterov = bool(config.pop("nesterov", False))
    params = list(params)

    if name == "adam":
        # optax chains add_decayed_weights before adam: torch's L2 weight_decay
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)
    elif name == "radam":
        opt = torch.optim.RAdam(params, lr=lr, betas=betas, eps=eps)
    elif name == "lamb":
        raise NotImplementedError(
            "lamb has no torch.optim counterpart and is not ported yet (ROADMAP queue 1, 'The rest of "
            "training')"
        )
    else:
        raise KeyError(f"Unsupported optimizer {name!r}")
    return Optimizer(opt, gradient_clip_val)
