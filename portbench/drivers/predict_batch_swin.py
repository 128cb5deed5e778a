"""Entry driver: bulk serving of the SwinV2 DAD-3DNet through
``FaceMeshPredictor.predict_batch``.

The calls, the traffic's parameters and the numbers are ``predict_batch``'s;
this driver replaces what rests on the encoder: the seeded weights (the
SwinV2 layout of ``reference/swinv2.py``), the model FLOPs (counted on that
reference) and the check (that reference's forward). The configuration's
``swin`` entry gives the encoder's settings to the reference; the program
builds its encoder from the ``model`` entry's ``backbone``."""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import compare, seeded
from ..reference import flame as flame_ref
from ..reference import network, precision, swinv2
from . import predict_batch

ROWS = predict_batch.ROWS
LN_SCALE = ("ln_weight", "postnorm_weight")
LN_SHIFT = ("ln_bias", "postnorm_bias")


def weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The SwinV2 DAD-3DNet's tensors, named as its state dict, drawn from
    ``seed`` in the program's initialisation, but for what makes served
    weights exercise every lane: every LayerNorm's scale U(0.75, 1.25) and
    shift N(0, 0.1) (the zeroed res-post-norms too, which would make each
    block the identity), q and v biases N(0, 0.02), and BatchNorm
    statistics and affine parameters as ``seeded.weights`` gives served CNN
    weights. fp32, on ``device``."""
    m = config["model"]
    lay = swinv2.layout(config["swin"], m["num_filters"], m["num_classes"])
    g = seeded.generator(seed, 1, device=device)
    out: Dict[str, torch.Tensor] = {}
    normal = [(n, s, k) for n, s, k in lay if k in ("trunc02", "lecun")]
    flat = seeded._truncated_normal(torch.rand(sum(math.prod(s) for _, s, _ in normal), generator=g, device=device))
    off = 0
    for name, shape, kind in normal:
        n = math.prod(shape)
        std = 0.02 if kind == "trunc02" else math.sqrt(1.0 / math.prod(shape[1:])) / 0.87962566103423978
        out[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    shapes = {name: shape for name, shape, _ in lay}
    for name, shape, kind in lay:
        if kind == "uniform_fan_in":
            fan_in = math.prod(shapes[name.rsplit(".", 1)[0] + ".weight"][1:])
            out[name] = (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) / math.sqrt(fan_in)
        elif kind in LN_SCALE:
            out[name] = torch.rand(shape, generator=g, device=device) * 0.5 + 0.75
        elif kind in LN_SHIFT:
            out[name] = torch.randn(shape, generator=g, device=device) * 0.1
        elif kind == "qv_bias":
            out[name] = torch.randn(shape, generator=g, device=device) * 0.02
        elif kind == "logit_scale":
            out[name] = torch.full(shape, math.log(10.0), device=device)
        elif kind in ("bn_weight", "bn_var"):
            out[name] = torch.rand(shape, generator=g, device=device) * 0.5 + 0.75
        elif kind in ("bn_bias", "bn_mean"):
            out[name] = torch.randn(shape, generator=g, device=device) * 0.1
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
    return {name: out[name].contiguous() for name, _, _ in lay}


def model_flops(config: dict, batch: int, size: int) -> float:
    """FLOPs of one call (the network's forward and the FLAME decode),
    counted by ``torch.utils.flop_counter`` on the reference on the meta
    device, as ``roofline.model_flops`` counts the CNNs: matrix products,
    the attention's included, and convolutions, 2 a multiply-add."""
    m = config["model"]
    lay = swinv2.layout(config["swin"], m["num_filters"], m["num_classes"])
    P = {n: torch.empty(s, device="meta", dtype=torch.int64 if k == "count" else torch.float32) for n, s, k in lay}
    flame = {"v_template": torch.empty(5023, 3, device="meta"), "shapedirs": torch.empty(5023, 3, 400, device="meta"),
             "posedirs": torch.empty(36, 5023 * 3, device="meta"), "j_regressor": torch.empty(5, 5023, device="meta"),
             "lbs_weights": torch.empty(5023, 5, device="meta")}
    with FlopCounterMode(display=False) as counter:
        out = swinv2.forward(P, torch.empty(batch, size, size, 3, device="meta"), config["swin"])
        flame_ref.decode(flame, out["3dmm"], size)
    return float(counter.get_total_flops())


class Driver(predict_batch.Driver):
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, workdir: str):
        from dad3dheads_tpu_torch.api import FaceMeshPredictor

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, torch.device(device)
        self.batch, self.size = int(traffic["batch"]), int(config["img_size"])
        marks = seeded.Marks()
        flame_path = seeded.save_flame(seeded.flame(seed, self.device), os.path.join(workdir, "flame.npz"))
        self.pool = seeded.images(seed, int(traffic["pool"]), self.batch, self.size, self.device).cpu().numpy()
        marks("inputs and the FLAME file")
        model = {**config["model"], "dtype": traffic["dtype"]}
        self.predictor = FaceMeshPredictor({"img_size": self.size, "model": model}, flame_path=flame_path,
                                           device=self.device)
        marks("FaceMeshPredictor()")
        self.predictor.model.load_state_dict(weights(config, seed, self.device))
        marks("seeded weights")
        for i in range(int(traffic["warm_calls"])):
            self.predictor.predict_batch(self.pool[i % len(self.pool)])
        marks("warm-up calls")
        self.setup_marks = marks.done
        self.samples: List[tuple] = []
        self._rng = np.random.default_rng(seeded.sub_seed(seed, 5))

    def model_flops(self) -> float:
        return model_flops(self.config, self.batch, self.size)

    def check(self) -> Dict[str, float]:
        return compare.worst(reference_readings(self, self.samples))


@torch.no_grad()
def reference_outputs(P, flame, images_u8: torch.Tensor, swin: dict, size: int, quant=None, matmul=None):
    """The SwinV2 reference on one batch, in blocks of rows, in
    ``predict_batch``'s keys (as ``predict_batch.reference_outputs``)."""
    mm3d, points, verts, proj = [], [], [], []
    for lo in range(0, images_u8.shape[0], ROWS):
        out = swinv2.forward(P, network.normalize(images_u8[lo:lo + ROWS]), swin, quant=quant)
        mm3d.append(out["3dmm"])
        points.append(torch.clamp(out["landmarks"] * size, 0, size))
        _, v, p = flame_ref.decode(flame, out["3dmm"], size, matmul)
        verts.append(v)
        proj.append(p)
    cat = lambda ts: torch.cat(ts).cpu().numpy()  # noqa: E731
    return {"3dmm_params": cat(mm3d), "points": cat(points), "3d_vertices": cat(verts), "projected_vertices": cat(proj)}


@torch.no_grad()
def reference_readings(driver: Driver, samples: List[tuple]) -> List[Dict[str, float]]:
    """``samples``: (pool index, outputs in ``predict_batch``'s keys) of the
    program, or of a stand-in for it, against the reference. Frees the
    program first."""
    driver.free()
    dev, size = driver.device, driver.size
    if dev.type == "cuda":
        precision.exact_fp32()
    P = weights(driver.config, driver.seed, dev)
    flame = seeded.flame(driver.seed, dev)
    swin = driver.config["swin"]
    refs = {k: reference_outputs(P, flame, torch.from_numpy(driver.pool[k]).to(dev), swin, size)
            for k in sorted({k for k, _ in samples})}
    readings = []
    for k, out in samples:
        x = torch.from_numpy(np.ascontiguousarray(out["3dmm_params"])).to(dev)
        decoded = [flame_ref.decode(flame, x[lo:lo + ROWS], size)[1:] for lo in range(0, len(x), ROWS)]
        ref = {"3dmm": refs[k]["3dmm_params"], "points": refs[k]["points"]}
        readings.append(compare.serve_numbers(out, ref, {"vertices": torch.cat([v for v, _ in decoded]).cpu().numpy(),
                                                         "projected": torch.cat([p for _, p in decoded]).cpu().numpy()}))
    return readings


@torch.no_grad()
def control(driver: Driver) -> Dict[str, float]:
    """The control's numbers on the driver's sampled calls: the reference put
    in the program's place one precision below the configuration, its
    trunk's convolution and matrix-product operands in fp8 and its FLAME
    decode's products in TF32."""
    dev = driver.device
    P = weights(driver.config, driver.seed, dev)
    flame = seeded.flame(driver.seed, dev)
    samples = [(k, reference_outputs(P, flame, torch.from_numpy(driver.pool[k]).to(dev), driver.config["swin"],
                                     driver.size, quant=precision.fp8, matmul=precision.tf32_matmul))
               for k, _ in driver.samples]
    del P, flame
    return compare.worst(reference_readings(driver, samples))
