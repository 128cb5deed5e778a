"""Static asset store: FLAME topology, landmark embeddings, keypoint subsets,
and the FLAME morphable-model arrays. A copy of ``dad3dheads_tpu/assets.py``
reading the port's own copy of the asset files (``dad3dheads_tpu_torch/assets``).

The FLAME model proper (``flame.pkl`` in the reference,
the reference's model_training/model/utils.py:84-89) is a missing LFS blob even
upstream. This module therefore loads, in order of precedence:

  1. an explicit path (``.npz`` or FLAME-2020 ``.pkl``) given by the caller or
     the ``DAD3D_FLAME_PATH`` environment variable — for users with a FLAME
     licence;
  2. a deterministic synthetic stand-in with the exact FLAME shapes
     (5023 vertices, 400 blendshapes, 5 joints) so every pipeline stage runs
     end-to-end and is testable without the proprietary asset.

All arrays are returned as numpy; torch code converts at the device boundary.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import threading
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np

from .constants import KINTREE_PARENTS, NUM_FACES, NUM_JOINTS, NUM_VERTICES

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")
_lock = threading.Lock()


def asset_path(name: str) -> str:
    return os.path.join(_ASSET_DIR, name)


@lru_cache(maxsize=None)
def _load_npz(name: str) -> Dict[str, np.ndarray]:
    with np.load(asset_path(name), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_topology() -> Dict[str, np.ndarray]:
    """Mesh faces + vertex-index subsets (head/face/face_w_ears/eyeballs/edges)."""
    return _load_npz("topology.npz")


def get_faces() -> np.ndarray:
    return load_topology()["faces"]


def get_flame_indices(name: str) -> np.ndarray:
    """Vertex-index subset by name, e.g. 'head', 'face', 'face_w_ears',
    'eyeballs', 'head_edges', 'face_edges', 'faces_wo_ears_remapped',
    plus the top-level 'indices_2d' / 'head_indices'."""
    topo = load_topology()
    if name in topo:
        return topo[name]
    return topo[f"flame_indices/{name}"]


def load_landmark_embeddings() -> Dict[str, np.ndarray]:
    """Barycentric embeddings: static 51 landmarks + dynamic 17-contour table
    (79 yaw bins x 17 landmarks)."""
    return _load_npz("landmark_embeddings.npz")


def load_keypoint_subset(name: str, exclude_cheeks: bool = True) -> np.ndarray:
    """Flattened vertex indices of a 2D keypoint subset ('keypoints_191' or
    'keypoints_445'). The reference excludes the 120 cheek points by default
    (the reference's model_training/utils.py:84)."""
    z = _load_npz("keypoint_subsets.npz")
    key = f"{name}/__flat_no_cheeks__" if exclude_cheeks else f"{name}/__flat__"
    return z[key]


# ---------------------------------------------------------------------------
# FLAME morphable-model arrays
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlameModelArrays:
    """The raw FLAME decoder arrays (numpy, host side).

    Shapes follow FLAME 2020:
      v_template   (V, 3)
      shapedirs    (V, 3, 400)   300 shape + 100 expression blendshapes
      posedirs     (36, V*3)     pose-corrective basis, already transposed to
                                 (pose-feature, flattened-vertex) layout
      j_regressor  (J, V)
      lbs_weights  (V, J)
      parents      (J,)          kinematic-tree parent indices, parents[0] = -1
      faces        (F, 3)
    """

    v_template: np.ndarray
    shapedirs: np.ndarray
    posedirs: np.ndarray
    j_regressor: np.ndarray
    lbs_weights: np.ndarray
    parents: np.ndarray
    faces: np.ndarray
    is_synthetic: bool = False

    def validate(self) -> "FlameModelArrays":
        v, j = NUM_VERTICES, NUM_JOINTS
        assert self.v_template.shape == (v, 3), self.v_template.shape
        assert self.shapedirs.shape == (v, 3, 400), self.shapedirs.shape
        assert self.posedirs.shape == ((j - 1) * 9, v * 3), self.posedirs.shape
        assert self.j_regressor.shape == (j, v), self.j_regressor.shape
        assert self.lbs_weights.shape == (v, j), self.lbs_weights.shape
        assert self.parents.shape == (j,), self.parents.shape
        assert self.faces.shape == (NUM_FACES, 3), self.faces.shape
        return self


def _vertex_adjacency(faces: np.ndarray, num_vertices: int):
    """CSR-ish neighbor averaging operator for Laplacian smoothing."""
    import scipy.sparse as sp  # scipy ships with the baked-in stack

    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2], faces[:, 1], faces[:, 2], faces[:, 0]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0], faces[:, 0], faces[:, 1], faces[:, 2]])
    data = np.ones_like(rows, dtype=np.float32)
    adj = sp.coo_matrix((data, (rows, cols)), shape=(num_vertices, num_vertices)).tocsr()
    adj.data[:] = 1.0
    deg = np.asarray(adj.sum(axis=1)).reshape(-1)
    deg = np.maximum(deg, 1.0)
    return adj, deg


def synthesize_flame_model(seed: int = 0) -> FlameModelArrays:
    """Deterministic synthetic FLAME stand-in.

    The template is a Laplacian-smoothed random embedding of the *real* FLAME
    topology (faces are the genuine DAD-3DHeads asset), so the mesh is a
    smooth, connected surface of the right graph structure; blendshape,
    pose-corrective, regressor, and skinning arrays are small-magnitude
    deterministic noise with the exact FLAME shapes.
    """
    rng = np.random.default_rng(seed)
    faces = get_faces().astype(np.int32)
    v = NUM_VERTICES

    adj, deg = _vertex_adjacency(faces, v)
    pts = rng.normal(size=(v, 3)).astype(np.float32)
    for _ in range(60):  # heat-flow smoothing onto a blob-like surface
        pts = 0.5 * pts + 0.5 * (adj @ pts) / deg[:, None]
        # renormalize scale so smoothing does not collapse to a point
        pts -= pts.mean(axis=0, keepdims=True)
        pts /= max(np.abs(pts).max(), 1e-6)
    pts *= 0.11  # FLAME heads span roughly +-0.11 units

    shapedirs = rng.normal(size=(v, 3, 400)).astype(np.float32) * 1e-3
    posedirs = rng.normal(size=((NUM_JOINTS - 1) * 9, v * 3)).astype(np.float32) * 1e-4

    # Joint anchors: centroid + offsets; regressor = uniform weights over the
    # 32 nearest template vertices to each anchor.
    anchors = np.array(
        [
            [0.0, -0.02, 0.0],  # global/root
            [0.0, -0.06, -0.02],  # neck
            [0.0, -0.04, 0.05],  # jaw
            [-0.03, 0.03, 0.06],  # left eyeball
            [0.03, 0.03, 0.06],  # right eyeball
        ],
        dtype=np.float32,
    )
    j_regressor = np.zeros((NUM_JOINTS, v), dtype=np.float32)
    for j in range(NUM_JOINTS):
        d = np.linalg.norm(pts - anchors[j], axis=1)
        nearest = np.argsort(d)[:32]
        j_regressor[j, nearest] = 1.0 / 32.0

    joints = j_regressor @ pts
    d2 = np.linalg.norm(pts[:, None, :] - joints[None, :, :], axis=-1)
    lbs_weights = np.exp(-d2 / 0.02).astype(np.float32)
    lbs_weights /= lbs_weights.sum(axis=1, keepdims=True)

    return FlameModelArrays(
        v_template=pts.astype(np.float32),
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=j_regressor,
        lbs_weights=lbs_weights,
        parents=np.asarray(KINTREE_PARENTS, dtype=np.int32),
        faces=faces,
        is_synthetic=True,
    ).validate()


class _ChumpyStub:
    """Unpickle target for chumpy classes without chumpy installed.

    Real FLAME 2020 pickles wrap most arrays in ``chumpy.ch.Ch`` objects, so
    a plain ``pickle.load`` raises ModuleNotFoundError before any array
    conversion can run (the reference only loads because its torch
    environment ships chumpy as an smplx dependency). A ``Ch`` pickles via
    its instance ``__dict__``, which carries the underlying ndarray in 'x' —
    this stub absorbs that state and hands the array back."""

    def __init__(self, *args, **kwargs):
        pass

    @property
    def r(self):  # chumpy's evaluated-array accessor, for symmetry
        return self.__dict__.get("x")


class _ChumpyFreeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "chumpy":
            return _ChumpyStub
        return super().find_class(module, name)


def _from_flame_pkl(path: str) -> FlameModelArrays:
    """Load a user-supplied FLAME 2020 pickle (same format the reference
    expects at model_training/model/static/flame.pkl); chumpy-wrapped and
    plain-numpy pickles both load, without a chumpy dependency."""
    with open(path, "rb") as f:
        data = _ChumpyFreeUnpickler(f, encoding="latin1").load()

    def raw(x):
        if isinstance(x, _ChumpyStub):
            return x.__dict__.get("x", x.__dict__)
        return x

    def arr(x):
        return np.asarray(raw(x), dtype=np.float32)

    posedirs = arr(data["posedirs"])  # (V, 3, 36)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # -> (36, V*3)
    j_reg = raw(data["J_regressor"])  # scipy sparse in the real asset
    if hasattr(j_reg, "todense"):
        j_reg = np.asarray(j_reg.todense())
    return FlameModelArrays(
        v_template=arr(data["v_template"]),
        shapedirs=arr(data["shapedirs"]),
        posedirs=posedirs.astype(np.float32),
        j_regressor=np.asarray(j_reg, dtype=np.float32),
        lbs_weights=arr(data["weights"]),
        parents=np.asarray(raw(data["kintree_table"])[0], dtype=np.int64).astype(np.int32),
        faces=np.asarray(raw(data["f"]), dtype=np.int32),
        is_synthetic=False,
    )


def _from_npz(path: str) -> FlameModelArrays:
    with np.load(path) as z:
        return FlameModelArrays(
            v_template=z["v_template"],
            shapedirs=z["shapedirs"],
            posedirs=z["posedirs"],
            j_regressor=z["j_regressor"],
            lbs_weights=z["lbs_weights"],
            parents=z["parents"],
            faces=z["faces"],
            is_synthetic=bool(z.get("is_synthetic", False)),
        )


_MODEL_CACHE: Dict[Tuple[Optional[str], int], FlameModelArrays] = {}


def load_flame_model(path: Optional[str] = None, seed: int = 0) -> FlameModelArrays:
    """Load the FLAME model arrays (see module docstring for precedence)."""
    path = path or os.environ.get("DAD3D_FLAME_PATH") or None
    key = (path, seed)
    with _lock:
        if key in _MODEL_CACHE:
            return _MODEL_CACHE[key]
        if path is not None:
            model = _from_npz(path) if path.endswith(".npz") else _from_flame_pkl(path)
            if model.parents[0] != -1:
                model = dataclasses.replace(
                    model, parents=np.concatenate([[-1], model.parents[1:]]).astype(np.int32)
                )
            model = model.validate()
        else:
            model = synthesize_flame_model(seed)
        _MODEL_CACHE[key] = model
        return model
