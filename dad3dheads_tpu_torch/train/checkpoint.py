"""Checkpoint manager: top-k by a monitored metric, last, resume, export.
Mirrors ``dad3dheads_tpu/train/checkpoint.py``.

``last.pt`` holds the full train state (model, optimizer, step, epoch) for
``fit(resume=True)``; the top-k files hold the model's weights only, named by
epoch and metric, tracked in ``registry.json``. Between checkpoint intervals
an improving epoch is held as an on-device copy (``hold``) and written by
``flush_held``. ``export_inference`` writes the predictor weights in the JAX
package's ``.msgpack`` format, which both packages' ``FaceMeshPredictor``
load.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Dict, List, Optional

import torch

from ..weights import flax_from_state_dict, save_flax_msgpack


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.=-]", "_", name)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        monitor: str = "metrics/reproject_nme_2d",
        mode: str = "min",
        save_top_k: int = 3,
    ):
        if mode not in ("min", "max"):
            raise ValueError(mode)
        self.directory = directory
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        os.makedirs(directory, exist_ok=True)
        self._registry_path = os.path.join(directory, "registry.json")
        self._registry: List[Dict[str, Any]] = []
        if os.path.isfile(self._registry_path):
            with open(self._registry_path) as f:
                self._registry = json.load(f)
        self._held: List[tuple] = []  # (weights snapshot, epoch, metrics, value)

    @property
    def last_path(self) -> str:
        return os.path.join(self.directory, "last.pt")

    def is_better(self, a: float, b: float) -> bool:
        """True if ``a`` beats ``b`` under the configured mode."""
        return a < b if self.mode == "min" else a > b

    def best_value(self) -> Optional[float]:
        return self._registry[0]["value"] if self._registry else None

    @property
    def best(self) -> Optional[Dict[str, Any]]:
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

    def save(self, state, epoch: int, metrics: Dict[str, float]) -> Optional[str]:
        """Refresh ``last`` and add the model's weights to the top-k when the
        monitored metric is present and good enough. Returns the new top-k
        path, or None."""
        torch.save(state.state_dict(), self.last_path)
        return self._add_top_k(state.model.state_dict(), epoch, metrics)

    def hold(self, state, epoch: int, metrics: Dict[str, float]) -> None:
        """Keep a between-interval best epoch as an on-device copy of the
        weights, no file IO; at most ``save_top_k`` are kept, best first."""
        value = float(metrics.get(self.monitor, math.nan))
        if math.isnan(value):
            return
        weights = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        self._held.append((weights, epoch, dict(metrics), value))
        self._held.sort(key=lambda e: e[3], reverse=(self.mode == "max"))
        del self._held[self.save_top_k :]

    def flush_held(self) -> None:
        """Write every held snapshot into the top-k (never touching last)."""
        held, self._held = self._held, []
        for weights, epoch, metrics, _ in held:
            self._add_top_k(weights, epoch, metrics)

    def restore(self, state, path: Optional[str] = None):
        """Load a checkpoint into ``state`` (in place; returned): the best
        top-k entry by default, else ``last``. Weights-only files replace
        the model's weights and keep the optimizer, step and epoch."""
        if path is None:
            path = self.best["path"] if self.best is not None else self.last_path
        data = torch.load(path, map_location="cpu", weights_only=True)
        if set(data) == {"model"}:
            state.model.load_state_dict(data["model"])
        else:
            state.load_state_dict(data)
        return state

    def restore_last(self, state):
        if not os.path.isfile(self.last_path):
            raise FileNotFoundError(self.last_path)
        return self.restore(state, self.last_path)

    def export_inference(self, state, path: Optional[str] = None) -> str:
        """Write the variables-only ``.msgpack`` that ``FaceMeshPredictor``
        (the port's and the JAX package's) loads."""
        path = path or os.path.join(self.directory, "dad_3dnet.msgpack")
        return save_flax_msgpack(flax_from_state_dict(state.model.state_dict()), path)
