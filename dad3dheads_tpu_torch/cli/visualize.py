"""Ground-truth visualizer: a dataset item's FLAME vertices projected onto its
image. Mirrors ``dad3dheads_tpu/cli/visualize.py``: the item's annotation
json's vertices go through its model-view and projection matrices
(perspective divide, y-flip), are drawn as dots and saved as
``<id>_GT_landmarks.png``.

Usage:
  python -m dad3dheads_tpu_torch.cli.visualize --subset val --id 000123 \\
      --base-path dataset --out outputs
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np

from ..api.demo_utils import draw_points, get_output_path


def get_2d_keypoints(data: Dict[str, List], img_height: int) -> np.ndarray:
    vertices = np.asarray(data["vertices"], np.float32)
    mv = np.asarray(data["model_view_matrix"], np.float32)
    proj = np.asarray(data["projection_matrix"], np.float32)

    homo = np.concatenate([vertices, np.ones_like(vertices[:, :1])], -1)
    world = homo @ mv.T
    p = world @ proj.T
    xy = p[:, :2] / p[:, 3:4]
    return np.stack([xy[:, 0], img_height - xy[:, 1]], -1).astype(int)


def visualize(subset: str, id: str, base_path: str = "dataset", outputs_folder: str = "outputs") -> str:
    import cv2

    os.makedirs(outputs_folder, exist_ok=True)
    json_path = os.path.join(base_path, "DAD-3DHeadsDataset", subset, "annotations", id + ".json")
    img_path = json_path.replace("annotations", "images").replace("json", "png")

    img = cv2.cvtColor(cv2.imread(img_path), cv2.COLOR_BGR2RGB)
    with open(json_path) as f:
        mesh_data = json.load(f)

    img = draw_points(img, get_2d_keypoints(mesh_data, img.shape[0]))
    out = get_output_path(img_path, outputs_folder, "GT_landmarks", ".png")
    cv2.imwrite(out, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--subset", required=True, choices=["train", "val", "test"])
    ap.add_argument("--id", required=True)
    ap.add_argument("--base-path", default="dataset")
    ap.add_argument("--out", default="outputs")
    args = ap.parse_args(argv)
    print(visualize(args.subset, args.id, args.base_path, args.out))


if __name__ == "__main__":
    main()
