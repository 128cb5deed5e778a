"""Entry driver: the DAD-3DNet train step as the trainer builds it
(``train.step.build_train_step``), Adam with a global-norm clip and a linear
warmup, on seeded uint8 batches already on the card, with landmark targets
and no heatmaps (the step normalizes the images and encodes the heatmaps).

Set-up makes one train state and drives it from the seed through its first
three steps, on three batches whose rows all differ, with the window's own
call: those are the steps the reference follows. The same state then runs
the window, cycling the pool. The traffic file gives ``batch``, ``pool``,
``dtype`` (the trunk's), ``optimizer``, ``clip``, ``warmup_steps``,
``metrics`` (the step's metric panel), ``loss`` (the criteria),
``heatmap_stride``, ``heatmap_radius``, ``warm_calls`` (steps after the first
three, before the window) and ``trace_calls``."""

from __future__ import annotations

import gc
import os
from typing import Dict, List

import torch

from .. import compare, roofline, seeded
from ..reference import precision
from ..reference import train as train_ref

CHECK_STEPS = 3
BETA1 = 0.9  # Adam's first moment after one step is (1 - beta1) times the gradient it got


def step_seeds(seed: int) -> List[int]:
    """The global RNG's seed before each checked step (the heads' dropout)."""
    return [seeded.sub_seed(seed, 6, i) for i in range(CHECK_STEPS)]


def port_batch(b: Dict[str, torch.Tensor], size: int) -> Dict[str, torch.Tensor]:
    from dad3dheads_tpu_torch import constants as C

    B = b["images"].shape[0]
    box = torch.tensor([[0.0, 0.0, float(size), float(size)]], device=b["images"].device).expand(B, 4)
    return {C.INPUT_IMAGE_KEY: b["images"], C.TARGET_2D_LANDMARKS: b["landmarks"],
            C.TARGET_2D_LANDMARKS_PRESENCE: b["presence"], C.TARGET_3D_MODEL_VERTICES: b["vertices"],
            C.TARGET_2D_FULL_LANDMARKS: b["full_landmarks"], C.INPUT_BBOX_KEY: box}


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, workdir: str):
        from dad3dheads_tpu_torch.core.flame import FlameModel
        from dad3dheads_tpu_torch.losses import LossModule
        from dad3dheads_tpu_torch.train.state import init_train_state
        from dad3dheads_tpu_torch.train.step import build_train_step

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, torch.device(device)
        self.batch, self.size = int(traffic["batch"]), int(config["img_size"])
        if int(traffic["pool"]) < CHECK_STEPS:
            raise ValueError(f"a train pool of {traffic['pool']} batches: the {CHECK_STEPS} checked steps take distinct ones")
        marks = seeded.Marks()
        flame_arrays = seeded.flame(seed, self.device)
        self.flame = FlameModel.load(seeded.save_flame(flame_arrays, os.path.join(workdir, "flame.npz")),
                                     device=self.device)
        self.batches = seeded.train_batches(seed, int(traffic["pool"]), self.batch, self.size, flame_arrays,
                                            self.device)
        self._feed = [port_batch(b, self.size) for b in self.batches]
        marks("inputs and the FLAME file")
        self.state = init_train_state({**config["model"], "dtype": traffic["dtype"]}, traffic["optimizer"],
                                      torch.Generator().manual_seed(0), self.device, float(traffic["clip"]))
        marks("init_train_state()")
        start = seeded.weights(config["model"], seed, self.device, random_bn=False)
        self.state.model.load_state_dict(start)
        marks("seeded weights")
        self.step = build_train_step(LossModule(traffic["loss"]), self.size, int(traffic["warmup_steps"]),
                                     with_metrics=bool(traffic["metrics"]),
                                     heatmap_stride=int(traffic["heatmap_stride"]),
                                     heatmap_radius=int(traffic["heatmap_radius"]))
        params = dict(self.state.model.named_parameters())
        losses = []
        for i, s in enumerate(step_seeds(seed)):
            torch.manual_seed(s)
            losses.append(self.step(self.state, self.flame, self._feed[i])["loss"])
            if i == 0:  # a parameter the optimizer holds no moment for got no gradient
                opt_state = self.state.optimizer.optimizer.state
                moments = [opt_state[p]["exp_avg"] if "exp_avg" in opt_state.get(p, {}) else torch.zeros_like(p)
                           for p in params.values()]
                grads = [n / (1.0 - BETA1) for n in torch._foreach_norm(moments)]
        changes = torch._foreach_norm(torch._foreach_sub([p.detach() for p in params.values()],
                                                         [start[k] for k in params]))
        buffers = dict(self.state.model.named_buffers())
        self.program = {"losses": [float(x) for x in losses],
                        "grad_norms": {k: float(g) for k, g in zip(params, grads)},
                        "change_norms": {k: float(c) for k, c in zip(params, changes)},
                        "bn": {k[: -len(".running_mean")]: (v.detach().cpu().clone(),
                                                            buffers[k[: -len("mean")] + "var"].detach().cpu().clone())
                               for k, v in buffers.items() if k.endswith(".running_mean")}}
        del start, moments, grads, changes
        marks("the three checked steps")
        for i in range(int(traffic["warm_calls"])):
            self.call(i)
        self.sync()
        marks("warm-up steps")
        self.setup_marks = marks.done

    def call(self, i: int) -> None:
        self.step(self.state, self.flame, self._feed[(CHECK_STEPS + i) % len(self._feed)])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def images(self, calls: int) -> int:
        return calls * self.batch

    def end_to_end(self, call_s: List[float], window_s: float) -> Dict[str, float]:
        return {"train_images_per_s": len(call_s) * self.batch / window_s}

    def counters(self) -> Dict[str, int]:
        from dad3dheads_tpu_torch.ops.blendshapes import blend_shapes_fused, blend_shapes_fused_backward
        from dad3dheads_tpu_torch.ops.preprocess import normalize_images

        return {"normalize_images": normalize_images.launches, "blend_shapes_fused": blend_shapes_fused.launches,
                "blend_shapes_fused_backward": blend_shapes_fused_backward.launches}

    def kernel_bounds(self) -> Dict[str, tuple]:
        return roofline.train_kernels(self.batch, self.size)

    def model_flops(self) -> float:
        return roofline.model_flops(self.config["model"], self.batch, self.size, train=True)

    def free(self) -> None:
        self.state = self.step = self.flame = self._feed = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def settings(self) -> dict:
        t = self.traffic
        return {"img_size": self.size, "heatmap_stride": int(t["heatmap_stride"]),
                "heatmap_radius": int(t["heatmap_radius"]), "loss": t["loss"], "lr": float(t["optimizer"]["lr"]),
                "clip": float(t["clip"]), "warmup_steps": int(t["warmup_steps"])}

    def reference(self, quant=None, matmul=None, rows=None) -> dict:
        """The reference's first three steps from the same weights on the same
        batches (frees the program first)."""
        self.free()
        if self.device.type == "cuda":
            precision.exact_fp32()
        P = seeded.weights(self.config["model"], self.seed, self.device, random_bn=False)
        flame = seeded.flame(self.seed, self.device)
        return train_ref.run_steps(P, flame, self.batches[:CHECK_STEPS], self.config["model"]["backbone"],
                                   self.settings(), step_seeds(self.seed), quant, matmul, rows)

    def check(self) -> Dict[str, float]:
        return compare.train_numbers(self.program, self.reference())
