"""Benchmark submission json from the port's own predictor. Port of
``dad3dheads_tpu/benchmark_harness/submission.py``.

The format is {item_id: {68_landmarks_2d, N_landmarks_3d, 7_landmarks_3d,
rotation_matrix}}. The predicted mesh is written in camera convention (z
negated): Z_n compares the prediction's z order with the negated GT z, and
the 7-landmark Procrustes (reflections allowed) absorbs the flip for Chamfer.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..constants import flame_param_offset
from ..core.landmarks import LandmarkEmbedding, get_68_landmarks
from ..core.rotation import rot_mat_from_6dof
from .evaluate import SEVEN_LMK_INDICES


def predictions_to_submission_entry(
    predictions: Dict[str, np.ndarray], embedding: Optional[LandmarkEmbedding] = None
) -> Dict[str, List]:
    """One predictor result (the ``__call__`` contract) -> one submission
    entry, computed on the CPU."""
    emb = embedding if embedding is not None else LandmarkEmbedding.load()
    verts = np.asarray(predictions["3d_vertices"], np.float32)
    lms3d = get_68_landmarks(torch.from_numpy(verts)[None], emb)[0].numpy()

    # the scored NME is the reprojection's: the 68 2D landmarks are the
    # embedding of the reprojected mesh (linear, so it commutes with the
    # projection), not the heatmap argmax
    proj = np.asarray(predictions["projected_vertices"], np.float32)
    if proj.ndim == 3:
        proj = proj[0]
    proj3 = np.concatenate([proj[:, :2], np.zeros_like(proj[:, :1])], axis=1)
    lms2d = get_68_landmarks(torch.from_numpy(proj3)[None], emb)[0, :, :2].numpy()
    off = flame_param_offset("rotation")
    rot6 = np.asarray(predictions["3dmm_params"], np.float32)[:, off : off + 6]
    R = rot_mat_from_6dof(torch.from_numpy(np.ascontiguousarray(rot6)))[0].numpy()
    # the evaluator compares with the GT model-view turned 180 degrees about
    # x, so the rotation is written in that frame
    R = np.diag([1.0, -1.0, -1.0]).astype(np.float32) @ R
    flip = np.array([1.0, 1.0, -1.0], np.float32)
    return {
        "68_landmarks_2d": lms2d.tolist(),
        "N_landmarks_3d": (verts * flip).tolist(),
        "7_landmarks_3d": (lms3d[SEVEN_LMK_INDICES] * flip).tolist(),
        "rotation_matrix": R.tolist(),
    }


def generate_submission(
    dataset_base: str,
    subset: str = "val",
    output_path: str = "data/submission.json",
    checkpoint_path: Optional[str] = None,
    limit: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> str:
    """Run the predictor over a DAD-3DHeads subset (whole images, in chunks
    of 256 through ``predict_images``) and write a submission."""
    from ..api.predictor import FaceMeshPredictor
    from ..data.io import read_as_rgb

    root = f"{dataset_base}/DAD-3DHeadsDataset/{subset}"
    with open(f"{root}/{subset}.json") as f:
        items = json.load(f)
    if limit:
        items = items[:limit]

    predictor = FaceMeshPredictor.dad_3dnet(checkpoint_path=checkpoint_path, device=device)
    embedding = LandmarkEmbedding.load()
    submission = {}
    chunk = 256
    for lo in range(0, len(items), chunk):
        part = items[lo : lo + chunk]
        images = [read_as_rgb(f"{root}/images/{el['item_id']}.png") for el in part]
        for el, preds in zip(part, predictor.predict_images(images, batch_size=32, num_workers=8)):
            submission[el["item_id"]] = predictions_to_submission_entry(preds, embedding)

    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        json.dump(submission, f)
    return output_path
