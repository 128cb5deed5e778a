"""Checkpoint manager: top-k by a monitored metric, last, resume, export.
Mirrors ``dad3dheads_tpu/train/checkpoint.py``.

``last.pt`` holds the full train state (model, optimizer, step, epoch) for
``fit(resume=True)``; the top-k files hold the model's weights only, named by
epoch and metric, tracked in ``registry.json``. Between checkpoint intervals
an improving epoch is held as an on-device copy (``hold``) and written by
``flush_held``. ``export_inference`` writes the predictor weights in the JAX
package's ``.msgpack`` format, which both packages' ``FaceMeshPredictor``
load. Files hold host tensors, whatever the state's device.

Async mode (``async_save=True``): ``save`` copies the whole state on the
device (the next optimizer step updates weights, BN statistics, moments and
``step`` counters in place), records an event behind the copies, waits for
the previous write and queues the new one on one writer thread, which waits
for the event, copies to pinned host memory on a stream of its own and
writes the files while training goes on. ``flush()`` drains the writer and
re-raises its error; ``best`` and ``restore`` flush, ``best_value`` does not.
"""

from __future__ import annotations

import json
import math
import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch

from ..weights import flax_from_state_dict, save_flax_msgpack


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.=-]", "_", name)


def _map_tensors(fn, tree, memo: Optional[Dict[int, Any]] = None):
    """``fn`` on every tensor of a nest of dicts, lists and tuples, once per
    tensor: one that appears twice (the model's weights in the state and in
    the top-k payload) maps to one result."""
    memo = {} if memo is None else memo
    if isinstance(tree, torch.Tensor):
        if id(tree) not in memo:
            memo[id(tree)] = fn(tree)
        return memo[id(tree)]
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v, memo) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v, memo) for v in tree)
    return tree


def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map_tensors(out.append, tree)
    return out


def _device_snapshot(tree):
    """A deep copy of every tensor, on its own device (queued, no sync)."""
    return _map_tensors(lambda t: t.detach().clone(), tree)


def _to_host(tree, stream=None):
    """Every tensor on the host. With ``stream`` (the writer's), device
    tensors go into pinned memory by non-blocking copies on it, and the
    stream is synchronized before the host tensors are returned."""
    if stream is None:
        return _map_tensors(lambda t: t.detach().cpu(), tree)

    def copy(t):
        if t.device.type == "cpu":
            return t
        host = torch.empty_like(t, device="cpu", pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    with torch.cuda.stream(stream):
        host = _map_tensors(copy, tree)
    stream.synchronize()
    return host


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        monitor: str = "metrics/reproject_nme_2d",
        mode: str = "min",
        save_top_k: int = 3,
        async_save: bool = False,
    ):
        if mode not in ("min", "max"):
            raise ValueError(mode)
        self.directory = directory
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._registry_path = os.path.join(directory, "registry.json")
        self._registry: List[Dict[str, Any]] = []
        if os.path.isfile(self._registry_path):
            with open(self._registry_path) as f:
                self._registry = json.load(f)
        self._held: List[tuple] = []  # (weights snapshot, epoch, metrics, value)
        self._executor: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Future] = None
        self._stream = None  # the writer's copy stream, made on its first device snapshot

    @property
    def last_path(self) -> str:
        return os.path.join(self.directory, "last.pt")

    def is_better(self, a: float, b: float) -> bool:
        """True if ``a`` beats ``b`` under the configured mode."""
        return a < b if self.mode == "min" else a > b

    def best_value(self) -> Optional[float]:
        """The best monitored value without draining the writer (an
        in-flight save can leave it one entry stale)."""
        return self._registry[0]["value"] if self._registry else None

    @property
    def best(self) -> Optional[Dict[str, Any]]:
        self.flush()
        return self._registry[0] if self._registry else None

    def _add_top_k(self, weights: Dict[str, Any], epoch: int, metrics: Dict[str, float]) -> Optional[str]:
        value = float(metrics.get(self.monitor, math.nan))
        if math.isnan(value):
            return None
        path = os.path.join(self.directory, _sanitize(f"epoch={epoch}_{self.monitor}={value:.4f}") + ".pt")
        torch.save({"model": weights}, path)
        self._registry.append({"path": path, "epoch": epoch, "value": value})
        self._registry.sort(key=lambda e: e["value"], reverse=(self.mode == "max"))
        while len(self._registry) > self.save_top_k:
            evicted = self._registry.pop()
            if os.path.isfile(evicted["path"]):
                os.remove(evicted["path"])
            if evicted["path"] == path:
                path = None
        with open(self._registry_path, "w") as f:
            json.dump(self._registry, f, indent=2)
        return path

    def _save_impl(self, payload: Dict[str, Any], epoch: int, metrics: Dict[str, float], ready=None,
                   stream=None) -> Optional[str]:
        """Write ``payload`` ({"model": weights} and, to refresh last,
        "state": the full state dict). ``ready`` is the event behind the
        device copies, which the host copy waits for."""
        if ready is not None:
            ready.synchronize()
        host = _to_host(payload, stream)
        if "state" in host:
            torch.save(host["state"], self.last_path)
        return self._add_top_k(host["model"], epoch, metrics)

    def save(self, state, epoch: int, metrics: Dict[str, float], update_last: bool = True,
             presnapshotted: bool = False) -> Optional[str]:
        """Refresh ``last`` (unless ``update_last`` is false: a held best
        epoch must not clobber the resume state) and add the model's weights
        to the top-k when the monitored metric is present and good enough.
        ``state`` is a ``TrainState``, or with ``presnapshotted`` the weights
        that ``hold`` copied. Synchronous mode returns the new top-k path, or
        None; async mode snapshots on the device, queues the write and
        returns None."""
        if presnapshotted:
            payload = {"model": state}
        elif update_last:
            full = state.state_dict()
            payload = {"state": full, "model": full["model"]}
        else:
            payload = {"model": state.model.state_dict()}
        if not self.async_save:
            return self._save_impl(payload, epoch, dict(metrics))
        if not presnapshotted:
            payload = _device_snapshot(payload)
        ready = stream = None
        device = next((t.device for t in _tensors(payload) if t.device.type == "cuda"), None)
        if device is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            stream = self._stream
        if self._executor is None:
            self._executor = ThreadPoolExecutor(1, thread_name_prefix="checkpoint-writer")
        self.flush()  # at most one write in flight
        self._pending = self._executor.submit(self._save_impl, payload, epoch, dict(metrics), ready, stream)
        return None

    def hold(self, state, epoch: int, metrics: Dict[str, float]) -> None:
        """Keep a between-interval best epoch as an on-device copy of the
        weights, no file IO; at most ``save_top_k`` are kept, best first."""
        value = float(metrics.get(self.monitor, math.nan))
        if math.isnan(value):
            return
        self._held.append((_device_snapshot(state.model.state_dict()), epoch, dict(metrics), value))
        self._held.sort(key=lambda e: e[3], reverse=(self.mode == "max"))
        del self._held[self.save_top_k :]

    def flush_held(self) -> None:
        """Write every held snapshot into the top-k (never touching last)."""
        held, self._held = self._held, []
        for weights, epoch, metrics, _ in held:
            self.save(weights, epoch, metrics, update_last=False, presnapshotted=True)

    def flush(self) -> None:
        """Wait for the write in flight; re-raises the writer's error."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def restore(self, state, path: Optional[str] = None):
        """Load a checkpoint into ``state`` (in place; returned): the best
        top-k entry by default, else ``last``. Weights-only files replace
        the model's weights and keep the optimizer, step and epoch."""
        self.flush()
        if path is None:
            path = self.best["path"] if self.best is not None else self.last_path
        data = torch.load(path, map_location="cpu", weights_only=True)
        if set(data) == {"model"}:
            state.model.load_state_dict(data["model"])
        else:
            state.load_state_dict(data)
        return state

    def restore_last(self, state):
        self.flush()
        if not os.path.isfile(self.last_path):
            raise FileNotFoundError(self.last_path)
        return self.restore(state, self.last_path)

    def export_inference(self, state, path: Optional[str] = None) -> str:
        """Write the variables-only ``.msgpack`` that ``FaceMeshPredictor``
        (the port's and the JAX package's) loads."""
        path = path or os.path.join(self.directory, "dad_3dnet.msgpack")
        return save_flax_msgpack(flax_from_state_dict(state.model.state_dict()), path)
