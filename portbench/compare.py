"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each read as a gap that a cell's limit bounds.

Serving (``predict_batch``), over every row of the sampled calls:
- ``mm3d_rel``: the widest row gap of the 413-value 3DMM, as a share of the
  reference row's norm (network, heads);
- ``points_px``: the widest gap of a served landmark, in pixels of the
  256-pixel frame (network, regression head, readout);
- ``vertices_rel``: the widest gap of a served mesh vertex against the
  reference's FLAME decode of the program's own 3DMM, as a share of the
  reference's largest coordinate (the FLAME decode and its blendshape
  kernel, the 6D rotation, the readback);
- ``projected_px``: the widest gap of a projected vertex against the same
  decode's weak-perspective projection, in pixels.

Training, over the first three steps:
- ``loss_rel``: the widest gap of a step's total loss, as a share of the
  reference's;
- ``grad_rel``: over the leaves, the widest gap between the norms of the
  program's and the reference's clipped first gradient, as a share of the
  larger of the reference leaf's norm and the median leaf's; ``grad_med``
  the median leaf's gap, measured alike;
- ``change_rel``: the widest gap of the norms of the parameters' change
  after three steps, measured alike, over the leaves whose reference
  gradient is at least a thousandth of the median leaf's (the others move by
  round-off alone under Adam);
- ``stem_bn_rel``: the widest gap over the channels of the first
  BatchNorm's running statistics after three steps, the mean's against the
  reference's deviation and the variance's against its variance (the
  encoder's first stage, before the randomly initialised network amplifies
  round-off); ``bn_med``: the median over the BatchNorms of that gap.

A cell's file of limits names the numbers it compares.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

CHANGE_LEAF_FLOOR = 1e-3


def serve_numbers(program: Dict[str, np.ndarray], reference_net: Dict[str, np.ndarray],
                  reference_decode: Dict[str, np.ndarray]) -> Dict[str, float]:
    """``program``: one call's outputs (``predict_batch``'s keys);
    ``reference_net``: {"3dmm", "points"} of the reference on its images;
    ``reference_decode``: {"vertices", "projected"} of the reference decode
    of the program's 3DMM."""
    p3, r3 = program["3dmm_params"].astype(np.float64), reference_net["3dmm"].astype(np.float64)
    mm3d = np.linalg.norm(p3 - r3, axis=1) / np.maximum(np.linalg.norm(r3, axis=1), 1e-12)
    rv = reference_decode["vertices"]
    return {
        "mm3d_rel": float(mm3d.max()),
        "points_px": float(np.abs(program["points"] - reference_net["points"]).max()),
        "vertices_rel": float(np.abs(program["3d_vertices"] - rv).max() / max(np.abs(rv).max(), 1e-30)),
        "projected_px": float(np.abs(program["projected_vertices"] - reference_decode["projected"]).max()),
    }


def _worst_leaf(program: Dict[str, float], reference: Dict[str, float], names: List[str]) -> float:
    med = float(np.median([reference[k] for k in names]))
    return max(abs(program[k] - reference[k]) / max(reference[k], med, 1e-30) for k in names)


def _bn_gap(program, reference) -> float:
    """The widest gap of a running statistic over the channels of one
    BatchNorm: the mean's against the reference's deviation, the variance's
    against the reference's variance."""
    (pm, pv), (rm, rv) = program, reference
    rv = np.asarray(rv, np.float64)
    return float(max(np.max(np.abs(np.asarray(pm) - np.asarray(rm)) / np.sqrt(rv)),
                     np.max(np.abs(np.asarray(pv) - rv) / rv)))


def train_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """Each side: {"losses": [3 floats], "grad_norms": {leaf: float},
    "change_norms": {leaf: float}, "bn": {BatchNorm: (mean, var)}}."""
    lp, lr = np.asarray(program["losses"], np.float64), np.asarray(reference["losses"], np.float64)
    grads = reference["grad_norms"]
    med = float(np.median(list(grads.values())))
    moving = [k for k in grads if grads[k] >= CHANGE_LEAF_FLOOR * med]
    bn = {k: _bn_gap(program["bn"][k], reference["bn"][k]) for k in reference["bn"]}
    return {
        "loss_rel": float(np.max(np.abs(lp - lr) / np.abs(lr))),
        "grad_rel": _worst_leaf(program["grad_norms"], grads, list(grads)),
        "grad_med": float(np.median([abs(program["grad_norms"][k] - grads[k]) / max(grads[k], med) for k in grads])),
        "change_rel": _worst_leaf(program["change_norms"], reference["change_norms"], moving),
        "stem_bn_rel": bn[next(iter(reference["bn"]))],
        "bn_med": float(np.median(list(bn.values()))),
    }


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def judged(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for every limit; a number that is missing or
    not finite reads None, and fails."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name)
        out[name] = {"value": v if v is not None and np.isfinite(v) else None, "limit": limit}
    return out


def passes(checks: Dict[str, dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
