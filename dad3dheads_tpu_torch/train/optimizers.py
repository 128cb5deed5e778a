"""Optimizer factory on ``torch.optim``. Mirrors
``dad3dheads_tpu/train/optimizers.py``: adam, adamw and sgd (with optional
weight decay), radam and lamb, from a config dict with the JAX package's keys
and defaults, with gradient clipping by global norm in front, as the JAX
package chains ``optax.clip_by_global_norm``. ``torch.optim`` has no LAMB:
:class:`Lamb` computes ``optax.lamb``'s chain.

Every update of the JAX train step is scaled by ``warmup_factor(step) *
lr_mult``; for each of these optimizers that equals running that step at the
base learning rate times the factor (the update is linear in the learning
rate), which is what :meth:`Optimizer.step` does.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch


def clip_by_global_norm_(grads, max_norm: float, sharded=None) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: every gradient times
    max_norm / norm when norm >= max_norm, untouched otherwise. Returns the
    norm before clipping. No host sync: the choice is a ``where`` on the
    device. ``sharded``: (indices into ``grads``, process group) of
    gradients split over that group (head tensor parallelism): their squares
    are summed over it, so that every rank clips by the whole gradient's
    norm."""
    norms = torch.stack(torch._foreach_norm(grads))
    if sharded is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        import torch.distributed as dist

        index, group = sharded
        split = torch.zeros(len(grads), dtype=torch.bool, device=norms.device)
        split[list(index)] = True
        squares = norms.square()
        shard_sq = squares[split].sum()
        dist.all_reduce(shard_sq, group=group)
        norm = torch.sqrt(squares[~split].sum() + shard_sq)
    if max_norm and max_norm > 0:
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, scale)
    return norm


class Lamb(torch.optim.Optimizer):
    """LAMB as ``optax.lamb`` chains it: ``scale_by_adam`` (eps added after
    the square root of the bias-corrected second moment, no eps inside it),
    ``add_decayed_weights(weight_decay)`` on every parameter, then
    ``scale_by_trust_ratio``: each parameter's update times ||p|| / ||u||
    (1 where either norm is 0), then -lr. The per-parameter state has
    ``torch.optim.Adam``'s keys (``step``, ``exp_avg``, ``exp_avg_sq``), so
    the JAX train-state bridge (``weights.train_state_from_flax``) fills
    both alike."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, {"lr": lr, "betas": tuple(betas), "eps": eps, "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                state = self.state[p]
                if not state:
                    # a host scalar, as torch.optim.Adam keeps it: reading it costs no sync
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            grads = [p.grad for p in params]
            states = [self.state[p] for p in params]
            mu, nu = [s["exp_avg"] for s in states], [s["exp_avg_sq"] for s in states]
            steps = [s["step"] for s in states]
            torch._foreach_add_(steps, 1.0)
            b1, b2 = group["betas"]
            # optax's update_moment: (1 - b) * g + b * m
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            count = float(steps[0])
            denom = torch._foreach_div(nu, 1.0 - b2**count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(mu, 1.0 - b1**count)
            torch._foreach_div_(updates, denom)
            if group["weight_decay"]:
                torch._foreach_add_(updates, params, alpha=group["weight_decay"])
            p_norm = torch.stack(torch._foreach_norm(params))
            u_norm = torch.stack(torch._foreach_norm(updates))
            ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm), p_norm / u_norm)
            torch._foreach_mul_(updates, list(ratio.unbind()))
            torch._foreach_add_(params, updates, alpha=-group["lr"])
        return loss


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

    @property
    def capturable(self) -> bool:
        """Whether the update runs without the host, so that a CUDA graph can
        hold it: torch's ``capturable`` mode, which keeps the step counters
        on the device (lamb reads its counter on the host; sgd has no such
        mode)."""
        return all(group.get("capturable", False) for group in self.optimizer.param_groups)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, scale: float | torch.Tensor = 1.0, sharded=None) -> torch.Tensor:
        """Clip, then update at lr * ``scale``: a float, or for a capturable
        optimizer a 0-d tensor on the parameters' device, whose value a CUDA
        graph of the step reads at each replay. A parameter the loss did not
        reach gets a zero gradient, as in optax. Returns the global gradient
        norm before clipping (``optax.global_norm(grads)``). ``sharded``:
        (parameters, process group) of parameters split over that group
        (``parallel.sharded_parameters``), whose gradients' squares the
        norm sums over it."""
        params = self.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if sharded is not None:
            if isinstance(self.optimizer, Lamb):
                raise NotImplementedError("lamb's per-parameter trust ratio over sharded head weights is not "
                                          "implemented: train head tensor parallelism with adam, adamw, sgd or radam")
            ids = {id(p) for p in sharded[0]}
            sharded = ([i for i, p in enumerate(params) if id(p) in ids], sharded[1])
        norm = clip_by_global_norm_([p.grad for p in params], self.gradient_clip_val, sharded)
        if not isinstance(scale, torch.Tensor):
            scale = float(scale)
        for group, lr in zip(self.optimizer.param_groups, self.base_lrs):
            group["lr"] = lr * scale
        self.optimizer.step()
        return norm

    def state_dict(self) -> Dict[str, Any]:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        # step() sets each group's lr from base_lrs. Each group keeps its own
        # capturable flag (a state written on the other device carries the
        # other one), by which torch places the loaded step counters.
        groups = [{**g, "capturable": own["capturable"]} if "capturable" in own else g
                  for g, own in zip(state["param_groups"], self.optimizer.param_groups)]
        self.optimizer.load_state_dict({**state, "param_groups": groups})


def get_optimizer(
    config: Optional[Dict[str, Any]],
    params: Iterable[torch.nn.Parameter],
    learning_rate: Optional[float] = None,
    gradient_clip_val: float = 0.0,
) -> Optimizer:
    """Build the optimizer from a config dict.

    config keys: name (adam|adamw|sgd|radam|lamb), lr, weight_decay,
    momentum, nesterov, eps, betas; ``learning_rate`` overrides
    config["lr"]."""
    config = dict(config or {})
    name = config.pop("name", "adam").lower()
    lr = float(learning_rate if learning_rate is not None else config.pop("lr", 1e-4))
    weight_decay = float(config.pop("weight_decay", 0.0))
    eps = float(config.pop("eps", 1e-8))
    betas = tuple(float(b) for b in config.pop("betas", (0.9, 0.999)))
    momentum = float(config.pop("momentum", 0.9))
    nesterov = bool(config.pop("nesterov", False))
    params = list(params)
    # on the card, the updates that have a capturable mode take it, so that a
    # CUDA graph of the train step can hold them (train/step.py)
    capturable = bool(params) and all(p.is_cuda for p in params)

    if name == "adam":
        # optax chains add_decayed_weights before adam: torch's L2 weight_decay
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay, capturable=capturable)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                capturable=capturable)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)
    elif name == "radam":
        opt = torch.optim.RAdam(params, lr=lr, betas=betas, eps=eps, capturable=capturable)
    elif name == "lamb":
        opt = Lamb(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
    else:
        raise KeyError(f"Unsupported optimizer {name!r}")
    return Optimizer(opt, gradient_clip_val)
