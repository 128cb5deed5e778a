"""DAD-3DHeads benchmark evaluator: pose error, reprojection NME, one-sided
Chamfer and Z_n depth-ordinal accuracy, overall and by attribute. Port of
``dad3dheads_tpu/benchmark_harness/evaluate.py``.

  - pose error ||I - R_pred R_gt^T||_F against the GT model-view turned 180
    degrees about x;
  - NME over the 68 projected GT landmarks / sqrt(bbox area) * 100;
  - Chamfer: the GT scaled to a 20 mm inter-eye distance, the prediction
    aligned to it by a 7-landmark Procrustes, then the mean over the GT face
    subset of the squared distance to the nearest aligned vertex;
  - Z_n: for each head-subset vertex and its n nearest GT neighbours, do
    prediction and GT agree on which is nearer the camera?

The small arithmetic (the 68-landmark embedding, Procrustes in float64, the
projection, NME and pose) is host numpy, copied from the JAX package, so
those numbers are bit-equal to its. Chamfer and Z_n run as torch on the
evaluator's ``device`` (cuda by default). Both use the direct difference
``dx*dx + dy*dy + dz*dz``: elementwise operations and an exact min give the
same bits for a sample alone or in a batch, and on the CPU or the card, which
keeps the batched scorer bit-identical to the per-sample oracle
(``DADEvaluator.__call__(batched=False)``). The matmul form |s|^2 + |d|^2 -
2 s.d would cancel catastrophically. Means run on the host in float64.
"""

from __future__ import annotations

import json
import logging
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import assets

logger = logging.getLogger(__name__)

SEVEN_LMK_INDICES = np.array([36, 39, 42, 45, 33, 48, 54])
CHAMFER_ROWS = 512  # GT points per block of the pairwise distances


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------


def procrustes(X: np.ndarray, Y: np.ndarray, scaling: bool = True) -> Dict[str, Any]:
    """Least-squares similarity transform mapping Y onto X (rotation,
    translation, optional scaling; a reflection where it fits best), in
    float64. Returns {'rotation' (applied as y @ R), 'scale', 'translation'}."""
    X, Y = np.asarray(X, np.float64), np.asarray(Y, np.float64)
    muX, muY = X.mean(0), Y.mean(0)
    X0, Y0 = X - muX, Y - muY
    normX = np.sqrt((X0**2).sum())
    normY = np.sqrt((Y0**2).sum())
    X0 /= normX
    Y0 /= normY
    U, s, Vt = np.linalg.svd(X0.T @ Y0, full_matrices=False)
    R = Vt.T @ U.T
    traceTA = s.sum()
    scale = traceTA * normX / normY if scaling else 1.0
    translation = muX - scale * muY @ R
    return {"rotation": R, "scale": scale, "translation": translation}


def procrustes_batched(X: np.ndarray, Y: np.ndarray, scaling: bool = True) -> Dict[str, Any]:
    """``procrustes`` over stacked (N, K, 3) point sets with LAPACK's batched
    SVD, the same arithmetic per item. Returns {'rotation' (N, 3, 3), 'scale'
    (N,), 'translation' (N, 3)}."""
    X, Y = np.asarray(X, np.float64), np.asarray(Y, np.float64)
    muX, muY = X.mean(1), Y.mean(1)
    X0, Y0 = X - muX[:, None], Y - muY[:, None]
    normX = np.sqrt((X0**2).sum(axis=(1, 2)))
    normY = np.sqrt((Y0**2).sum(axis=(1, 2)))
    X0 = X0 / normX[:, None, None]
    Y0 = Y0 / normY[:, None, None]
    U, s, Vt = np.linalg.svd(np.transpose(X0, (0, 2, 1)) @ Y0, full_matrices=False)
    R = np.transpose(Vt, (0, 2, 1)) @ np.transpose(U, (0, 2, 1))
    scale = s.sum(-1) * normX / normY if scaling else np.ones_like(normX)
    translation = muX - scale[:, None] * np.einsum("nk,nkj->nj", muY, R)
    return {"rotation": R, "scale": scale, "translation": translation}


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dx*dx + dy*dy + dz*dz of a (..., N, 1, 3) - b (..., 1, M, 3), in that
    order."""
    d = [a[..., k] - b[..., k] for k in range(3)]
    return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def one_sided_chamfer_mins(src: torch.Tensor, dst: torch.Tensor, rows: int = CHAMFER_ROWS) -> torch.Tensor:
    """Per-src-point min squared distance to dst: src (..., N, 3), dst (...,
    M, 3) -> (..., N). The (..., rows, M) distances of one block of src
    points are live at a time."""
    out = [
        _sq_dist(src[..., lo : lo + rows, None, :], dst[..., None, :, :]).min(dim=-1).values
        for lo in range(0, src.shape[-2], rows)
    ]
    return torch.cat(out, dim=-1)


def zn_accuracy(pred: torch.Tensor, gt: torch.Tensor, top_k: int = 5) -> torch.Tensor:
    """Ordinal depth agreement, pred/gt (..., N, 3) -> (...,) fp32: for
    each point and each of ``top_k`` GT neighbours, do pred and GT agree on
    which is nearer the camera (z order)? The mean over all pairs.

    The reference's indexing is ``argsort(d2, dim=0, stable=True)[:,
    1:top_k+1]`` over the (N, N) squared distances d2: entry [i, j] is the
    i-th nearest point to point j+1 (not point i's own neighbours). A
    column's argsort reads that column alone, so sorting only columns
    1..top_k, the distances of every point to points 1..top_k, gives the
    same indices without the (N, N) matrix."""
    d2 = _sq_dist(gt[..., :, None, :], gt[..., None, 1 : top_k + 1, :])  # (..., N, top_k)
    idx = torch.argsort(d2, dim=-2, stable=True)
    gt_z, pr_z = gt[..., 2], pred[..., 2]

    def nearer(z):
        return z[..., :, None] >= torch.gather(z, -1, idx.flatten(-2)).unflatten(-1, idx.shape[-2:])

    agree = (nearer(gt_z) == nearer(pr_z)).flatten(-2)
    # a count, then one IEEE fp32 division, as a float32 mean of 0s and 1s
    # rounds; by a tensor, since CUDA divides by a scalar as a multiply by
    # its reciprocal, which can part from the CPU in the last bit
    count = agree.sum(dim=-1).to(torch.float32)
    return count / torch.full_like(count, agree.shape[-1])


def _heavy_chunked(
    gt: torch.Tensor,
    scale: torch.Tensor,
    pred: torch.Tensor,
    aligned: torch.Tensor,
    face_idx: torch.Tensor,
    head_idx: torch.Tensor,
    top_k: int,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chamfer per-point minima (N, F) and Z_n (N,) for the whole
    submission, ``chunk`` samples at a time, so that the (chunk, rows, V)
    pairwise distances of one block are the largest live tensor.
    ``aligned`` is the Procrustes-aligned prediction from the host."""
    mins, zn = [], []
    for lo in range(0, gt.shape[0], chunk):
        g = gt[lo : lo + chunk]
        gt_face = (g * scale[lo : lo + chunk, None, None])[:, face_idx]
        mins.append(one_sided_chamfer_mins(gt_face, aligned[lo : lo + chunk]))
        zn.append(zn_accuracy(pred[lo : lo + chunk][:, head_idx], -g[:, head_idx], top_k))
    return torch.cat(mins), torch.cat(zn)


# ---------------------------------------------------------------------------
# annotations
# ---------------------------------------------------------------------------


class HeadAnnotation:
    def __init__(
        self,
        id: str,
        vertices3d: np.ndarray,
        model_view_matrix: np.ndarray,
        projection_matrix: np.ndarray,
        bbox: List[int],
        image_height: int,
        attributes: Optional[Dict[str, Any]] = None,
    ):
        self.id = id
        self.vertices3d = vertices3d
        self.model_view_matrix = model_view_matrix
        self.projection_matrix = projection_matrix
        self.bbox = bbox
        self.image_height = image_height
        self.attributes = attributes
        homo = np.concatenate([vertices3d, np.ones_like(vertices3d[:, :1])], -1)
        self.vertices3d_world_homo = homo @ model_view_matrix.T

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "HeadAnnotation":
        return cls(
            id=config["id"],
            vertices3d=np.asarray(config["vertices"], np.float32),
            model_view_matrix=np.asarray(config["model_view_matrix"], np.float32),
            projection_matrix=np.asarray(config["projection_matrix"], np.float32),
            bbox=config["bbox"],
            image_height=config["image_height"],
            attributes=config.get("attributes"),
        )


class DADEvaluator:
    """Scores a submission json against generated ground truth.

    Submission format: {item_id: {"68_landmarks_2d", "N_landmarks_3d",
    "7_landmarks_3d", "rotation_matrix"}}. ``device``: where Chamfer and Z_n
    run."""

    def __init__(self, ground_truth_path: str, submission_path: str, device: torch.device | str = "cuda"):
        self.gt_path = ground_truth_path
        self.sub_path = submission_path
        self.device = torch.device(device)
        self.head_indices = assets.get_flame_indices("head_indices")
        self.face_indices = assets.get_flame_indices("face")
        emb = assets.load_landmark_embeddings()
        faces = assets.get_faces()
        # the zero-pose embedding, [17 contour | 51 static]
        self._lm_ids = np.concatenate([faces[emb["dynamic_lmk_face_idx"][0]], faces[emb["static_lmk_face_idx"]]])
        self._lm_bary = np.concatenate([emb["dynamic_lmk_b_coords"][0], emb["static_lmk_b_coords"]]).astype(
            np.float32
        )

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    # -- per-sample metrics -----------------------------------------------
    def _lm68_host(self, verts: np.ndarray) -> np.ndarray:
        """(..., V, 3) -> (..., 68, 3) on the host: gathers and a fixed-order
        3-term weighted sum, the same bits alone or batched."""
        tri = np.asarray(verts, np.float32)[..., self._lm_ids, :]  # (..., 68, 3, 3)
        return (tri * self._lm_bary[..., None]).sum(-2)

    def _landmarks68_3d(self, vertices: np.ndarray) -> np.ndarray:
        return self._lm68_host(vertices)

    def gt_landmarks_68_2d(self, a: HeadAnnotation) -> np.ndarray:
        lms = self._landmarks68_3d(a.vertices3d)
        homo = np.concatenate([lms, np.ones_like(lms[:, :1])], -1)
        world = homo @ a.model_view_matrix.T
        p = world @ a.projection_matrix.T
        xy = p[:, :2] / p[:, 3:4]
        return np.stack([xy[:, 0], a.image_height - xy[:, 1]], -1)

    @staticmethod
    def get_gt_rot_mat(a: HeadAnnotation) -> np.ndarray:
        rot_180 = np.diag([1.0, -1.0, -1.0, 1.0])
        return (rot_180 @ a.model_view_matrix)[:3, :3]

    def pose_error(self, a: HeadAnnotation, pred: Dict[str, Any]) -> float:
        R_pred = np.asarray(pred["rotation_matrix"], np.float32)
        R_gt = self.get_gt_rot_mat(a)
        return float(np.linalg.norm(np.eye(3) - R_pred @ R_gt.T, "fro"))

    def nme(self, a: HeadAnnotation, pred: Dict[str, Any]) -> float:
        p68 = np.asarray(pred["68_landmarks_2d"], np.float32)
        g68 = self.gt_landmarks_68_2d(a)
        return float(np.mean(np.linalg.norm(g68 - p68, 2, -1) / np.sqrt(a.bbox[2] * a.bbox[3])) * 100.0)

    def chamfer_mins(self, a: HeadAnnotation, pred: Dict[str, Any]) -> np.ndarray:
        """The per-GT-face-point minima whose float64 mean is the Chamfer."""
        gt_v = a.vertices3d_world_homo[:, :3]
        lms = self._landmarks68_3d(gt_v)
        svn_gt = lms[SEVEN_LMK_INDICES]
        scale = 20.0 / (np.linalg.norm(svn_gt[1] - svn_gt[2]) + 1e-12)
        # one fp32 multiply, the batched path's
        gt_v = gt_v.astype(np.float32) * np.float32(scale)
        svn_gt = self._landmarks68_3d(gt_v)[SEVEN_LMK_INDICES]

        pred_v = np.asarray(pred["N_landmarks_3d"], np.float32).reshape(-1, 3)
        svn_pred = np.asarray(pred["7_landmarks_3d"], np.float32).reshape(-1, 3)
        tf = procrustes(svn_gt, svn_pred)
        aligned = tf["scale"] * pred_v @ tf["rotation"] + tf["translation"]

        gt_face = gt_v[self.face_indices]
        return one_sided_chamfer_mins(self._tensor(gt_face), self._tensor(aligned)).cpu().numpy()

    def chamfer_distance(self, a: HeadAnnotation, pred: Dict[str, Any]) -> float:
        return float(np.asarray(self.chamfer_mins(a, pred), np.float64).mean())

    def zn(self, a: HeadAnnotation, pred: Dict[str, Any], n: int = 5) -> float:
        gt_v = a.vertices3d_world_homo[:, :3]
        pred_v = np.asarray(pred["N_landmarks_3d"], np.float32).reshape(-1, 3)
        gt_head = self._tensor(gt_v[self.head_indices] * -1.0)
        pred_head = self._tensor(pred_v[self.head_indices])
        return float(zn_accuracy(pred_head, gt_head, top_k=n))

    # -- whole-submission scoring -------------------------------------------
    def score_batched(
        self,
        anns: List[HeadAnnotation],
        preds: List[Dict[str, Any]],
        chunk: int = 8,
        top_k: int = 5,
    ) -> Dict[str, np.ndarray]:
        """All four metrics for every (annotation, prediction) pair: the
        submission stacked, Chamfer and Z_n on the device ``chunk`` samples at
        a time, the rest vectorized host numpy. Returns (N,) arrays keyed by
        metric name; raises on a submission that does not stack."""
        N = len(anns)
        gt_model = np.stack([a.vertices3d for a in anns]).astype(np.float32)
        gt_world = np.stack([a.vertices3d_world_homo[:, :3] for a in anns]).astype(np.float32)
        p68 = np.stack([np.asarray(p["68_landmarks_2d"], np.float32) for p in preds])
        pred_v = np.stack([np.asarray(p["N_landmarks_3d"], np.float32).reshape(-1, 3) for p in preds])
        svn_pred = np.stack([np.asarray(p["7_landmarks_3d"], np.float32).reshape(-1, 3) for p in preds])
        # pose, item by item: the Frobenius norm of a stack reduces in
        # another order than the oracle's 2-D norm and can part from it in
        # the last bit (the JAX package's batched pose does)
        pose = np.array([self.pose_error(a, p) for a, p in zip(anns, preds)], np.float64)

        # NME projects the model-space landmarks through mvm/proj; the 20 mm
        # rescale anchors on the world-space ones
        lm68 = self._lm68_host(gt_model)
        lm68_world = self._lm68_host(gt_world)

        # NME: the per-sample arithmetic, looped (a batched f32 matmul would
        # round otherwise than the oracle's)
        nme = np.empty(N, np.float64)
        for i, a in enumerate(anns):
            lms = lm68[i]
            homo = np.concatenate([lms, np.ones_like(lms[:, :1])], -1)
            world = homo @ a.model_view_matrix.T
            pp = world @ a.projection_matrix.T
            xy = pp[:, :2] / pp[:, 3:4]
            g68 = np.stack([xy[:, 0], a.image_height - xy[:, 1]], -1)
            nme[i] = np.mean(np.linalg.norm(g68 - p68[i], 2, -1) / np.sqrt(a.bbox[2] * a.bbox[3])) * 100.0

        # the 20 mm rescale factor, scalar by scalar as the oracle computes it
        svn_gt = lm68_world[:, SEVEN_LMK_INDICES]
        scale = np.array([20.0 / (np.linalg.norm(svn_gt[i, 1] - svn_gt[i, 2]) + 1e-12) for i in range(N)],
                         np.float32)
        svn_scaled = self._lm68_host(gt_world * scale[:, None, None])[:, SEVEN_LMK_INDICES]
        tf = procrustes_batched(svn_scaled, svn_pred)
        aligned = (
            tf["scale"][:, None, None] * (pred_v.astype(np.float64) @ tf["rotation"]) + tf["translation"][:, None, :]
        ).astype(np.float32)

        dev = self.device
        cham_mins, zn = _heavy_chunked(
            self._tensor(gt_world),
            self._tensor(scale),
            self._tensor(pred_v),
            self._tensor(aligned),
            torch.as_tensor(self.face_indices, dtype=torch.int64, device=dev),
            torch.as_tensor(self.head_indices, dtype=torch.int64, device=dev),
            top_k,
            chunk,
        )
        return {
            "pose_error": pose,
            "nme": nme,
            "z5": zn.cpu().numpy().astype(np.float64),
            "chamfer": cham_mins.cpu().numpy().astype(np.float64).mean(axis=1),
        }

    # -- aggregation -------------------------------------------------------
    def load(self) -> Tuple[List[HeadAnnotation], List[Dict[str, Any]]]:
        """The ground truth's annotations that the submission predicts, and
        their predictions, in the ground truth's order."""
        with open(self.sub_path) as f:
            submission = json.load(f)
        with open(self.gt_path) as f:
            ground_truth = [HeadAnnotation.from_config(c) for c in json.load(f)]
        anns, preds = [], []
        for a in ground_truth:
            if a.id not in submission:
                print(f"No prediction with ID: {a.id}.")
                continue
            anns.append(a)
            preds.append(submission[a.id])
        return anns, preds

    def __call__(self, batched: bool = True, chunk: int = 8) -> Tuple[Dict[str, float], Dict[str, Any]]:
        anns, preds = self.load()
        out_names = {"pose_error": "pose_error", "nme": "nme_reprojection", "z5": "z5_accuracy", "chamfer": "chamfer"}
        per_sample: Optional[Dict[str, np.ndarray]] = None
        if batched and anns:
            try:
                per_sample = self.score_batched(anns, preds, chunk=chunk)
            except Exception as e:  # noqa: BLE001 — any failure falls back to the oracle
                # loud: the oracle scores one item at a time. The sizes are a
                # diagnostic only; failing to read them never stops the fallback
                try:
                    sizes = sorted({np.asarray(p["N_landmarks_3d"], np.float32).size // 3 for p in preds})
                except Exception as size_error:  # noqa: BLE001
                    sizes = f"unreadable ({size_error!r})"
                logger.warning(
                    "score_batched could not score the submission (%r); vertex counts present: %s. Falling back "
                    "to the per-sample oracle scorer (%d items, one at a time).", e, sizes, len(anns),
                )
        if per_sample is None:
            metric_funcs = {
                "pose_error": self.pose_error,
                "nme": self.nme,
                "z5": lambda a, p: self.zn(a, p, n=5),
                "chamfer": self.chamfer_distance,
            }
            per_sample = {
                name: np.array([func(a, p) for a, p in zip(anns, preds)]) for name, func in metric_funcs.items()
            }

        metrics = {name: defaultdict(lambda: defaultdict(list)) for name in out_names}
        for i, a in enumerate(anns):
            for attr, value in (a.attributes or {}).items():
                for name in out_names:
                    metrics[name][attr][value].append(float(per_sample[name][i]))
        overall = {
            out: float(np.mean(per_sample[name])) if len(anns) else float("nan") for name, out in out_names.items()
        }
        attribute_result = {
            out: {
                attr: {v: float(np.mean(vals)) for v, vals in values.items()} for attr, values in metrics[name].items()
            }
            for name, out in out_names.items()
        }
        return overall, attribute_result


def print_evaluation_results(overall: Dict[str, float], attributes: Dict[str, Any]) -> None:
    print("=== DAD-3DHeads benchmark ===")
    for k, v in overall.items():
        print(f"  {k:20s} {v:.6f}")
    for metric, attrs in attributes.items():
        for attr, values in attrs.items():
            print(f"  {metric} / {attr}:")
            for value, mean in values.items():
                print(f"    {value:16} {mean:.6f}")


def print_evaluation_summary(overall: Dict[str, float], attributes: Dict[str, Any]) -> None:
    """One-line summary view."""
    print("DAD-3DHeads: " + "  ".join(f"{k}={v:.4f}" for k, v in overall.items()))


def evaluate(submission_path: str, gt_path: str, device: torch.device | str = "cuda") -> Dict[str, float]:
    overall, attrs = DADEvaluator(gt_path, submission_path, device=device)()
    print_evaluation_results(overall, attrs)
    return overall
