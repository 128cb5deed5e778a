"""Everything a run makes from its ``--seed``, on the device, in a few large
calls: the network's weights, the FLAME stand-in, the served images and the
train batches. The same seed gives the same tensors, which both the program
and the reference are handed."""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from .reference import network

NUM_VERTICES, NUM_FACES, NUM_JOINTS, NUM_BETAS = 5023, 9976, 5, 400


class Marks:
    """Seconds of each stage of a set-up, on the host's clock, the device
    synchronised at each mark."""

    def __init__(self):
        self.done, self._t = [], time.perf_counter()

    def __call__(self, label: str) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.done.append((label, now - self._t))
        self._t = now


def sub_seed(seed: int, *tags: int) -> int:
    """An independent 63-bit seed for one use of the run's seed."""
    return int(np.random.SeedSequence([int(seed) % 2**64, *tags]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, *tags: int, device="cuda") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def _truncated_normal(u: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) -> a standard normal truncated at +-2 (inverse CDF)."""
    lo, hi = 0.5 * math.erfc(2.0 / math.sqrt(2.0)), 0.5 * math.erfc(-2.0 / math.sqrt(2.0))
    p = (lo + u.double() * (hi - lo)) * 2.0 - 1.0
    return (math.sqrt(2.0) * torch.erfinv(p)).float().clamp_(-2.0, 2.0)


def weights(model_config: dict, seed: int, device, random_bn: bool) -> Dict[str, torch.Tensor]:
    """DAD-3DNet's tensors, named as its state dict, drawn from ``seed``: the
    JAX package's initialisation (flax's lecun_normal, zero biases, fusion
    weights one, BatchNorm the identity); with ``random_bn`` the BatchNorms
    get statistics and affine parameters away from the identity (mean and
    bias N(0, 0.1), variance and scale U(0.75, 1.25)), as served weights
    have. fp32, on ``device``."""
    lay = network.layout(model_config["backbone"], model_config["num_filters"], model_config["num_classes"])
    g = generator(seed, 1, device=device)
    out: Dict[str, torch.Tensor] = {}
    lecun = [(n, s) for n, s, k in lay if k == "lecun"]
    flat = _truncated_normal(torch.rand(sum(math.prod(s) for _, s in lecun), generator=g, device=device))
    off = 0
    for name, shape in lecun:
        n = math.prod(shape)
        std = math.sqrt(1.0 / math.prod(shape[1:])) / 0.87962566103423978
        out[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    bn = [(n, s) for n, s, k in lay if k == "bn_weight"]
    channels = sum(s[0] for _, s in bn)
    if random_bn:
        uni = torch.rand(2, channels, generator=g, device=device) * 0.5 + 0.75
        nrm = torch.randn(2, channels, generator=g, device=device) * 0.1
    off = 0
    for name, shape in bn:
        p, c = name[: -len(".weight")], shape[0]
        if random_bn:
            out[f"{p}.weight"], out[f"{p}.running_var"] = uni[0, off:off + c], uni[1, off:off + c]
            out[f"{p}.bias"], out[f"{p}.running_mean"] = nrm[0, off:off + c], nrm[1, off:off + c]
        else:
            out[f"{p}.weight"] = torch.ones(c, device=device)
            out[f"{p}.running_var"] = torch.ones(c, device=device)
            out[f"{p}.bias"] = torch.zeros(c, device=device)
            out[f"{p}.running_mean"] = torch.zeros(c, device=device)
        off += c
    for name, shape, kind in lay:
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
    return {name: out[name].contiguous() for name, _, _ in lay}


def flame(seed: int, device) -> Dict[str, torch.Tensor]:
    """A FLAME stand-in with FLAME 2020's shapes (5,023 vertices, 9,976
    faces, 400 blendshapes, 5 joints): a template on a noisy ellipsoid of a
    head's extent, blendshapes N(0, 1e-3), pose correctives N(0, 1e-4), each
    joint regressed evenly from 32 random vertices, skinning weights a
    softmax of N(0, 4) logits. The real FLAME model is licensed."""
    g = generator(seed, 2, device=device)
    V = NUM_VERTICES
    d = torch.randn(V, 3, generator=g, device=device)
    r = 1.0 + 0.05 * torch.randn(V, 1, generator=g, device=device)
    v_template = d / d.norm(dim=1, keepdim=True) * r * torch.tensor([0.08, 0.11, 0.09], device=device)
    pick = torch.rand(NUM_JOINTS, V, generator=g, device=device).topk(32, dim=1).indices
    j_regressor = torch.zeros(NUM_JOINTS, V, device=device).scatter_(1, pick, 1.0 / 32)
    return {
        "v_template": v_template,
        "shapedirs": torch.randn(V, 3, NUM_BETAS, generator=g, device=device) * 1e-3,
        "posedirs": torch.randn((NUM_JOINTS - 1) * 9, V * 3, generator=g, device=device) * 1e-4,
        "j_regressor": j_regressor,
        "lbs_weights": torch.softmax(torch.randn(V, NUM_JOINTS, generator=g, device=device) * 2.0, dim=1),
        "faces": torch.randint(0, V, (NUM_FACES, 3), generator=g, device=device, dtype=torch.int32),
    }


def save_flame(arrays: Dict[str, torch.Tensor], path: str) -> str:
    """Write the stand-in as the ``.npz`` FLAME file that the program loads."""
    np.savez(path, parents=np.asarray([-1, 0, 1, 1, 1], np.int32),
             **{k: v.cpu().numpy() for k, v in arrays.items()})
    return path


def images(seed: int, pool: int, batch: int, size: int, device) -> torch.Tensor:
    """``pool`` batches of uint8 NHWC images, every pixel drawn from the
    seed. Each image has its own exposure, contrast and colour, as photos
    do: a level U(40, 215), a colour cast N(0, 20) a channel, and uniform
    noise of deviation U(10, 70) about them, clipped to 0-255."""
    g = generator(seed, 3, device=device)
    out = torch.empty((pool, batch, size, size, 3), dtype=torch.uint8, device=device)
    for i in range(pool):
        level = 40.0 + 175.0 * torch.rand(batch, 1, 1, 1, generator=g, device=device)
        cast = 20.0 * torch.randn(batch, 1, 1, 3, generator=g, device=device)
        spread = (10.0 + 60.0 * torch.rand(batch, 1, 1, 1, generator=g, device=device)) * math.sqrt(12.0)
        noise = torch.rand((batch, size, size, 3), generator=g, device=device) - 0.5
        out[i] = (level + cast + spread * noise).round_().clamp_(0, 255).to(torch.uint8)
    return out


def train_batches(seed: int, pool: int, batch: int, size: int, flame_arrays: Dict[str, torch.Tensor],
                  device) -> List[Dict[str, torch.Tensor]]:
    """``pool`` train batches whose rows all differ, each row a face as the
    dataset gives one: uint8 images; a target mesh, the stand-in's template
    plus its blendshapes times N(0, 1) coefficients; its vertices projected
    into the image at a face scale of 350-900 pixels a unit (a head 80-200
    pixels wide) about a centre within the middle 30% of each axis; the 68
    landmarks, a seeded choice of those vertices, normalised by the size,
    present where inside the image and for 95% of the rest."""
    g = generator(seed, 4, device=device)
    imgs = images(seed, pool, batch, size, device)
    V = flame_arrays["v_template"].shape[0]
    ids = torch.randperm(V, generator=g, device=device)[:68]
    dirs = flame_arrays["shapedirs"].reshape(V * 3, -1)
    out = []
    for i in range(pool):
        betas = torch.randn(batch, dirs.shape[1], generator=g, device=device)
        vertices = flame_arrays["v_template"][None] + (betas @ dirs.T).reshape(batch, V, 3)
        k = 350.0 + 550.0 * torch.rand(batch, 1, 1, generator=g, device=device)
        centre = size * (0.35 + 0.3 * torch.rand(batch, 1, 2, generator=g, device=device))
        full = centre + k * vertices[..., :2] * torch.tensor([1.0, -1.0], device=device)
        lms = full[:, ids] / size
        inside = ((lms > 0) & (lms < 1)).all(-1)
        out.append({"images": imgs[i], "landmarks": lms,
                    "presence": inside & (torch.rand(batch, 68, generator=g, device=device) < 0.95),
                    "vertices": vertices, "full_landmarks": full})
    return out
