"""One DAD-3DNet train step in plain PyTorch, fp32: targets, the four losses
over one FLAME decode, the backward, the global-norm clip and Adam.

As DAD-3DHeads trains (``configs/loss/train_loss.yaml``, ``optimizer/adam``,
``train.yaml``):
- the heatmap target splats each present landmark, floored then divided by
  the stride, as a Gaussian of sigma (2r + 1) / 6 cut to the (2r + 1) box and
  below fp32's eps, truncated to uint8 levels, then read as level / 255;
- ``iou``: 1 - the mean over images and landmarks of the soft IoU of
  sigmoid(heatmap) and the target, eps 1e-6;
- ``vertices_3d``: per vertex subset, the mean squared gap of the unit-cube
  normalised meshes (without the global rotation);
- ``reprojection``: per subset, the mean smooth-L1 (beta 1) gap of the
  projected vertices, in pixels;
- ``landmarks_w_visibility``: the mean smooth-L1 gap of the predicted and
  target landmarks (normalised), both masked by the target's presence;
- the total is the weighted sum; the gradient is clipped to a global norm
  (scaled by max / norm where norm >= max);
- Adam (beta 0.9, 0.999, eps 1e-8 after the square root), its learning
  rate times the linear warmup min(1, (step + 1) / warmup).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import flame as flame_ref
from . import network

_SUBSETS = os.path.join(os.path.dirname(__file__), "flame_subsets.npz")
BN_MOMENTUM, BIFPN_MOMENTUM = 0.1, 0.9997


def subsets(device) -> Dict[str, torch.Tensor]:
    """The FLAME vertex subsets the losses weight (a copy of the DAD-3DHeads
    topology's ``head``, ``face_w_ears`` and ``face`` index lists)."""
    with np.load(_SUBSETS) as z:
        return {k: torch.as_tensor(z[k].astype(np.int64), device=device) for k in z.files}


def encode_heatmap(keypoints: torch.Tensor, presence: torch.Tensor, img_size: int, stride: int,
                   radius: int) -> torch.Tensor:
    """(B, K, 2) pixel keypoints, (B, K) presence -> (B, S, S, K) fp32 in [0, 1]."""
    S = img_size // stride
    c = torch.div(torch.floor(keypoints), stride, rounding_mode="floor")
    grid = torch.arange(S, dtype=torch.float32, device=keypoints.device)
    dx = grid[None, None, None, :] - c[..., 0][..., None, None]
    dy = grid[None, None, :, None] - c[..., 1][..., None, None]
    sigma = (2 * radius + 1) / 6.0
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    keep = (dx.abs() <= radius) & (dy.abs() <= radius) & (g >= torch.finfo(torch.float32).eps)
    g = torch.where(keep, g, torch.zeros_like(g)) * presence[..., None, None].float()
    return (torch.floor(g * 255.0) / 255.0).permute(0, 2, 3, 1)


def _smooth_l1(a, b):
    d = (a - b).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()


def _cube(v):
    v = v - v.amin(dim=1, keepdim=True)
    v = v - 0.5 * v.amax(dim=1, keepdim=True)
    return v / v.amax(dim=(1, 2), keepdim=True)


def _criterion(c: dict, name: str) -> None:
    if c.get("criterion", name) != name:
        raise ValueError(f"{c['name']}: the reference computes {name}, not {c['criterion']}")


def losses(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], v0, proj, loss_config: List[dict],
           subset_index: Dict[str, torch.Tensor], heatmap: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{criterion name: weighted loss} for the loss config's criteria."""
    result = {}
    presence = batch["presence"].float()
    for c in loss_config:
        kind, w = c["kind"], float(c.get("weight", 1.0))
        if kind == "iou":
            o, t = torch.sigmoid(out["heatmap"]), heatmap
            inter = (t * o).sum(dim=(1, 2))
            iou = (inter + 1e-6) / ((t * t).sum(dim=(1, 2)) + (o * o).sum(dim=(1, 2)) - inter + 1e-6)
            val = 1.0 - iou.mean()
        elif kind == "vertices_3d":
            _criterion(c, "l2")
            val = sum(float(sw) * ((_cube(v0[:, subset_index[n]]) - _cube(batch["vertices"][:, subset_index[n]])) ** 2).mean()
                      for n, sw in c["subset_weights"].items())
        elif kind == "reprojection":
            _criterion(c, "smooth_l1")
            val = sum(float(sw) * _smooth_l1(proj[:, subset_index[n]], batch["full_landmarks"][:, subset_index[n]])
                      for n, sw in c["subset_weights"].items())
        elif kind == "landmarks_w_visibility":
            _criterion(c, "smooth_l1")
            val = _smooth_l1(out["landmarks"] * presence[..., None], batch["landmarks"] * presence[..., None])
        else:
            raise KeyError(kind)
        result[c["name"]] = val * w
    return result


def forward_loss(P, flame, batch, backbone: str, settings: dict, subset_index, quant=None, matmul=None, stats=None):
    """Train-mode forward and the weighted losses: (total, {name: loss})."""
    img = settings["img_size"]
    heatmap = encode_heatmap(batch["landmarks"].float() * img, batch["presence"], img, settings["heatmap_stride"],
                             settings["heatmap_radius"])
    out = network.forward(P, network.normalize(batch["images"]), backbone, train=True, quant=quant, stats=stats)
    v0, _, proj = flame_ref.decode(flame, out["3dmm"], img, matmul)
    parts = losses(out, batch, v0, proj, settings["loss"], subset_index, heatmap)
    return sum(parts.values()), parts


class Adam:
    """Adam over named fp32 leaves, with a global-norm clip in front."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, clip: float, warmup: int,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.clip, self.warmup = params, lr, clip, warmup
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Clip and update in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        if self.clip > 0 and float(norm) >= self.clip:
            grads = {k: g * (self.clip / norm) for k, g in grads.items()}
        lr = self.lr * (min(1.0, (self.t + 1.0) / self.warmup) if self.warmup > 0 else 1.0)
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            m, v = self.m[k], self.v[k]
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            self.params[k].sub_(lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))
        return grads


def run_steps(P: Dict[str, torch.Tensor], flame, batches: List[dict], backbone: str, settings: dict,
              step_seeds: List[int], quant=None, matmul=None, rows: Optional[slice] = None) -> dict:
    """The first ``len(batches)`` train steps from the weights ``P`` (updated
    in place; every float leaf that is not a BN buffer trains). Before step
    i the global RNG is seeded with ``step_seeds[i]``, as the benchmark seeds
    it before the program's step, so that the heads' dropout draws alike.
    ``rows`` keeps only those rows of each batch (a planted fault).
    Returns {"losses": [total per step], "grad_norms": {leaf: norm of the
    clipped first gradient}, "change_norms": {leaf: norm of the change after
    the last step}, "bn": {BatchNorm: (running mean, running variance) after
    the last step}}: the running statistics follow flax's rule, (1 - m) old
    + m batch, with the batch's biased variance, m 0.1 in the encoder and
    0.9997 in the BiFPN (the published momenta in torch's convention)."""
    names = [k for k, v in P.items() if v.is_floating_point() and not k.endswith(("running_mean", "running_var"))]
    start = {k: P[k].detach().clone() for k in names}
    leaves = {k: P[k].detach().requires_grad_(True) for k in names}
    params = {**P, **leaves}
    opt = Adam({k: leaves[k] for k in names}, settings["lr"], settings["clip"], settings["warmup_steps"])
    index = subsets(next(iter(P.values())).device)
    out = {"losses": []}
    running = {k[: -len(".running_mean")]: (P[k].clone(), P[k[: -len("mean")] + "var"].clone())
               for k in P if k.endswith(".running_mean")}
    for i, batch in enumerate(batches):
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
        torch.manual_seed(step_seeds[i])
        stats = {}
        total, _ = forward_loss(params, flame, batch, backbone, settings, index, quant, matmul, stats)
        for k, (mean, var) in stats.items():
            m = BIFPN_MOMENTUM if k.startswith("bifpn.") else BN_MOMENTUM
            running[k] = ((1.0 - m) * running[k][0] + m * mean, (1.0 - m) * running[k][1] + m * var)
        grads = torch.autograd.grad(total, [leaves[k] for k in names], allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(leaves[k])) for k, g in zip(names, grads)}
        out["losses"].append(float(total.detach()))
        del total
        clipped = opt.step(grads)
        if i == 0:
            out["grad_norms"] = {k: float(g.norm()) for k, g in clipped.items()}
        del grads, clipped
    out["change_norms"] = {k: float((leaves[k].detach() - start[k]).norm()) for k in names}
    out["bn"] = {k: (m.cpu(), v.cpu()) for k, (m, v) in running.items()}
    return out
