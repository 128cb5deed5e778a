"""Framework-wide constants: the FLAME 3DMM parameter layout and the
batch/output dict key schema. A copy of ``dad3dheads_tpu/constants.py``.

The 413-dim 3DMM vector layout mirrors the reference semantics
(the reference's model_training/model/flame.py:17-26 and the slicing order of
``FlameParams.from_3dmm`` at flame.py:40-84): the *slicing* order is
[shape | expression | jaw | rotation | eyeballs | neck | translation | scale],
note jaw precedes rotation even though the constants dict lists rotation first.

The string key schema is the de-facto inter-layer wire format
(the reference's model_training/data/config.py:1-26).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# Default FLAME 3DMM split — 413 total parameters.
FLAME_CONSTS: Dict[str, int] = {
    "shape": 300,
    "expression": 100,
    "rotation": 6,
    "jaw": 3,
    "eyeballs": 0,
    "neck": 0,
    "translation": 3,
    "scale": 1,
}

# Canonical slicing order of the packed 3DMM vector.
FLAME_3DMM_ORDER: Tuple[str, ...] = (
    "shape",
    "expression",
    "jaw",
    "rotation",
    "eyeballs",
    "neck",
    "translation",
    "scale",
)

# FLAME topology facts.
NUM_VERTICES = 5023
NUM_FACES = 9976
NUM_JOINTS = 5  # global, neck, jaw, left eyeball, right eyeball
MAX_SHAPE = 300
MAX_EXPRESSION = 100
ROT_COEFFS = 3
JAW_COEFFS = 3
EYE_COEFFS = 6
NECK_COEFFS = 3
MESH_OFFSET_Z = 0.05

# Kinematic tree: parent of each joint.
KINTREE_PARENTS: Tuple[int, ...] = (-1, 0, 1, 1, 1)

IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)


def flame_param_offset(key: str, consts: Dict[str, int] | None = None) -> int:
    """Start offset of a named group inside the packed 3DMM vector."""
    consts = consts or FLAME_CONSTS
    idx = 0
    for k in FLAME_3DMM_ORDER:
        if k == key:
            return idx
        idx += consts.get(k, 0)
    raise KeyError(key)


def total_3dmm_size(consts: Dict[str, int] | None = None) -> int:
    consts = consts or FLAME_CONSTS
    return sum(consts.get(k, 0) for k in FLAME_3DMM_ORDER)


# ---------------------------------------------------------------------------
# Batch / output dict key schema.
# ---------------------------------------------------------------------------
SAMPLE_INDEX_KEY = "SAMPLE_INDEX_KEY"
IMAGE_FILENAME_KEY = "IMAGE_FILENAME_KEY"

INPUT_IMAGE_KEY = "INPUT_IMAGE_KEY"
TARGET_MASK_KEY = "TARGET_MASK_KEY"

TARGET_3D_MODEL_VERTICES = "TARGET_3D_MODEL_VERTICES"
TARGET_2D_FULL_LANDMARKS = "TARGET_2D_FULL_LANDMARKS"
TARGET_2D_LANDMARKS = "TARGET_2D_LANDMARKS"
OUTPUT_2D_LANDMARKS = "OUTPUT_2D_LANDMARKS"
TARGET_LANDMARKS_HEATMAP = "TARGET_LANDMARKS_HEATMAP"
OUTPUT_LANDMARKS_HEATMAP = "OUTPUT_LANDMARKS_HEATMAP"
TARGET_2D_LANDMARKS_PRESENCE = "TARGET_2D_LANDMARKS_PRESENCE"
OUTPUT_2D_LANDMARKS_PRESENCE = "OUTPUT_2D_LANDMARKS_PRESENCE"
OUTPUT_3DMM_PARAMS = "OUTPUT_3DMM_PARAMS"
INPUT_BBOX_KEY = "INPUT_BBOX_KEY"
INPUT_SIZE_KEY = "INPUT_SIZE_KEY"

TARGET_PROJECTION_MATRIX = "TARGET_PROJECTION_MATRIX"
TARGET_3D_WORLD_VERTICES = "TARGET_3D_WORLD_VERTICES"

# Keys that are never collated into device arrays.
NON_COLLATED_KEYS: List[str] = [SAMPLE_INDEX_KEY, IMAGE_FILENAME_KEY]
