"""Entry driver: bulk serving through ``FaceMeshPredictor.predict_batch``.

One caller in a closed loop, back to back: each call hands the predictor a
uint8 batch from host memory (a seeded pool of distinct batches, cycled) and
gets numpy out: landmarks, the 3DMM, the FLAME mesh and its projection. The
traffic file gives ``batch``, ``pool``, ``dtype`` (the trunk's), ``warm_calls``
(calls before the window), ``sample_calls`` (whole calls of the window
compared with the reference, drawn from the seed) and ``trace_calls``."""

from __future__ import annotations

import gc
import os
from typing import Dict, List

import numpy as np
import torch

from .. import compare, roofline, seeded
from ..reference import flame as flame_ref
from ..reference import network, precision

ROWS = 64  # the reference runs in blocks of this many rows


class Driver:
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
        self.predictor.model.load_state_dict(seeded.weights(config["model"], seed, self.device, random_bn=True))
        marks("seeded weights")
        for i in range(int(traffic["warm_calls"])):
            self.predictor.predict_batch(self.pool[i % len(self.pool)])
        marks("warm-up calls")
        self.setup_marks = marks.done
        self.samples: List[tuple] = []  # (pool index, outputs) of the sampled calls
        self._rng = np.random.default_rng(seeded.sub_seed(seed, 5))

    def call(self, i: int) -> None:
        """The window's i-th call; a seeded reservoir keeps ``sample_calls``
        whole calls for the check."""
        k = i % len(self.pool)
        out = self.predictor.predict_batch(self.pool[k])
        keep = int(self.traffic["sample_calls"])
        if len(self.samples) < keep:
            self.samples.append((k, out))
        else:
            j = int(self._rng.integers(0, i + 1))
            if j < keep:
                self.samples[j] = (k, out)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def images(self, calls: int) -> int:
        return calls * self.batch

    def end_to_end(self, call_s: List[float], window_s: float) -> Dict[str, float]:
        return {"images_per_s": len(call_s) * self.batch / window_s,
                "batch_p95_ms": 1e3 * float(np.percentile(np.asarray(call_s), 95))}

    def counters(self) -> Dict[str, int]:
        from dad3dheads_tpu_torch.ops.blendshapes import blend_shapes_fused
        from dad3dheads_tpu_torch.ops.preprocess import normalize_images

        return {"normalize_images": normalize_images.launches, "blend_shapes_fused": blend_shapes_fused.launches}

    def kernel_bounds(self) -> Dict[str, tuple]:
        trunk = roofline.BF16 if self.traffic["dtype"] in ("bfloat16", "bf16") else roofline.FP32
        return roofline.serve_kernels(self.batch, self.size, trunk)

    def model_flops(self) -> float:
        return roofline.model_flops(self.config["model"], self.batch, self.size, train=False)

    def free(self) -> None:
        """Drop the program's state, so the reference runs in the memory it held."""
        self.predictor = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        """The program's sampled calls against the reference: the worst of each
        number over them."""
        return compare.worst(reference_readings(self, self.samples))


@torch.no_grad()
def reference_outputs(P, flame, images_u8: torch.Tensor, backbone: str, size: int, quant=None, matmul=None):
    """The reference on one batch, in blocks of rows, in ``predict_batch``'s
    keys: its 3DMM and landmarks, and its decode of its own 3DMM."""
    mm3d, points, verts, proj = [], [], [], []
    for lo in range(0, images_u8.shape[0], ROWS):
        out = network.forward(P, network.normalize(images_u8[lo:lo + ROWS]), backbone, quant=quant)
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
    program, or of a stand-in for it. Frees the program first."""
    driver.free()
    dev, size = driver.device, driver.size
    if dev.type == "cuda":
        precision.exact_fp32()
    P = seeded.weights(driver.config["model"], driver.seed, dev, random_bn=True)
    flame = seeded.flame(driver.seed, dev)
    backbone = driver.config["model"]["backbone"]
    refs = {k: reference_outputs(P, flame, torch.from_numpy(driver.pool[k]).to(dev), backbone, size)
            for k in sorted({k for k, _ in samples})}
    readings = []
    for k, out in samples:
        x = torch.from_numpy(np.ascontiguousarray(out["3dmm_params"])).to(dev)
        decoded = [flame_ref.decode(flame, x[lo:lo + ROWS], size)[1:] for lo in range(0, len(x), ROWS)]
        ref = {"3dmm": refs[k]["3dmm_params"], "points": refs[k]["points"]}
        readings.append(compare.serve_numbers(out, ref, {"vertices": torch.cat([v for v, _ in decoded]).cpu().numpy(),
                                                         "projected": torch.cat([p for _, p in decoded]).cpu().numpy()}))
    return readings
