"""Render a synthetic DAD-3DHeads-format dataset. The port's copy of
``tools/make_synthetic_dataset.py``: random FLAME parameters are decoded,
lit and rendered by the port's rasterizer, and written in the on-disk layout
of the DAD-3DHeads dataset:

  <out>/DAD-3DHeadsDataset/<subset>/{<subset>.json, images/*.png,
                                     annotations/*.json}

The images are rendered from the annotated geometry, so a network trained on
them must learn image -> geometry, and the whole workflow (FlameDataset ->
train -> predict -> generate-gt -> benchmark) runs without the licensed
dataset.

The model-view matrix holds the pose ([R | t / s], R orthonormal, as the
pose metric needs) and the per-sample projection matrix the weak-perspective
scale s and the dataset's y-flip, so ``FlameDataset``'s projection gives
exactly the keypoints the image was rendered with.

The 3DMM vectors come from a ``torch.Generator`` seeded with ``--seed``
(:func:`random_3dmm`), so the images differ from the JAX tool's, which draws
from ``jax.random``; :func:`render_sample`, the rest, is deterministic.
The decode and the render run on ``--device`` (cuda by default, where the
render launches the rasterizer kernel).

  python -m dad3dheads_tpu_torch.cli.make_dataset --out synth_dataset \\
      --subset train --num 64 --img-size 256 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .. import assets
from ..constants import flame_param_offset
from ..core.flame import FlameModel, FlameParams, flame_decode
from ..core.rotation import rot_mat_from_6dof
from ..data.synthetic import random_3dmm
from ..render.lighting import RenderPipeline

BACKGROUND = 32  # the uint8 grey behind the head


@torch.no_grad()
def decode_sample(flame: FlameModel, mm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, float]:
    """Packed 3DMM (1, 413) -> model-space vertices v0 (V, 3), world
    vertices s * R v0 + [tx, ty, 0] (V, 3), R (3, 3) and s = max(scale + 1,
    1e-8), on the vector's device."""
    params = FlameParams.from_3dmm(mm)
    v0 = flame_decode(flame, params, zero_rot=True)
    R = rot_mat_from_6dof(params.rotation)
    scale = torch.clamp(params.scale[:, None] + 1.0, min=1e-8)  # (1, 1, 1)
    t = params.translation.clone()
    t[..., 2] = 0.0
    world = torch.einsum("bxy,bvy->bvx", R, v0) * scale + t[:, None]
    return v0[0], world[0], R[0], float(scale[0, 0, 0])


@torch.no_grad()
def render_sample(
    mm: torch.Tensor,
    flame: FlameModel,
    faces: torch.Tensor,
    pipeline: RenderPipeline,
    img_size: int,
) -> Tuple[np.ndarray, Dict[str, List], List[int]]:
    """One sample from its packed 3DMM (1, 413): the RGB uint8 image, the
    annotation json's contents and the head's [x, y, w, h] box."""
    S = img_size
    v0, world, R, scale = decode_sample(flame, mm)
    # screen space: xy in pixels (y down), z toward the viewer
    screen = torch.stack([(world[:, 0] + 1.0) / 2.0 * S, (world[:, 1] + 1.0) / 2.0 * S, world[:, 2]], dim=-1)
    bg = torch.full((S, S, 3), BACKGROUND, dtype=torch.uint8, device=screen.device)
    img = pipeline(screen, faces, bg).cpu().numpy()

    o_tr = flame_param_offset("translation")
    tx, ty = (float(v) for v in mm[0, o_tr : o_tr + 2].cpu())
    mv = np.eye(4, dtype=np.float32)
    mv[:3, :3] = R.cpu().numpy()
    mv[:3, 3] = [tx / scale, ty / scale, 0.0]
    proj = np.array(
        [[scale * S / 2, 0, 0, S / 2], [0, -scale * S / 2, 0, S / 2], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32
    )
    annotation = {
        "vertices": v0.cpu().numpy().tolist(),
        "model_view_matrix": mv.tolist(),
        "projection_matrix": proj.tolist(),
    }
    xy = screen[:, :2].cpu().numpy()
    xs, ys = xy[:, 0], xy[:, 1]
    x0, y0 = float(max(xs.min(), 0)), float(max(ys.min(), 0))
    x1, y1 = float(min(xs.max(), S - 1)), float(min(ys.max(), S - 1))
    return img, annotation, [int(x0), int(y0), int(x1 - x0), int(y1 - y0)]


def make_dataset(
    out: str,
    subset: str = "train",
    num: int = 64,
    img_size: int = 256,
    seed: int = 0,
    with_attributes: bool = False,
    device: torch.device | str = "cuda",
) -> str:
    """Render ``num`` samples into ``out``; returns the subset's index json."""
    import cv2

    device = torch.device(device)
    flame = FlameModel.load(device=device)
    faces = torch.as_tensor(assets.get_faces().astype(np.int32), device=device)
    pipeline = RenderPipeline()
    base = os.path.join(out, "DAD-3DHeadsDataset", subset)
    os.makedirs(os.path.join(base, "images"), exist_ok=True)
    os.makedirs(os.path.join(base, "annotations"), exist_ok=True)

    gen = torch.Generator(device=device).manual_seed(seed)
    index: List[Dict[str, Any]] = []
    for i in range(num):
        mm = random_3dmm(gen, 1, device)
        img, annotation, bbox = render_sample(mm, flame, faces, pipeline, img_size)
        item_id = f"synth_{subset}_{i:05d}"
        cv2.imwrite(os.path.join(base, "images", item_id + ".png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        with open(os.path.join(base, "annotations", item_id + ".json"), "w") as f:
            json.dump(annotation, f)
        entry: Dict[str, Any] = {
            "item_id": item_id,
            "img_path": f"images/{item_id}.png",
            "annotation_path": f"annotations/{item_id}.json",
            "bbox": bbox,
        }
        if with_attributes:
            entry["attributes"] = {"quality": "good", "gender": "synthetic"}
        index.append(entry)

    path = os.path.join(base, f"{subset}.json")
    with open(path, "w") as f:
        json.dump(index, f)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="synth_dataset")
    ap.add_argument("--subset", default="train")
    ap.add_argument("--num", type=int, default=64)
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--with-attributes", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(make_dataset(args.out, args.subset, args.num, args.img_size, args.seed, args.with_attributes, args.device))


if __name__ == "__main__":
    main()
