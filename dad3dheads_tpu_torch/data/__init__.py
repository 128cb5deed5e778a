from .bbox import ensure_bbox_boundaries, extend_bbox, random_extended_bbox
from .dataset import DataLoader, FlameDataset, HeatmapCoder, collate
from .io import read_as_rgb

__all__ = [
    "DataLoader",
    "FlameDataset",
    "HeatmapCoder",
    "collate",
    "ensure_bbox_boundaries",
    "extend_bbox",
    "random_extended_bbox",
    "read_as_rgb",
]
