"""FaceMeshPredictor (the live network) and ExportedFaceMeshPredictor (the
deployment artifact), imported on first use: loading an artifact imports no
model code."""

import importlib

_HOMES = {
    "FaceMeshPredictor": "predictor",
    "DEFAULT_CONFIG": "predictor",
    "ExportedFaceMeshPredictor": "export",
    "export_predictor": "export",
}

__all__ = list(_HOMES)


def __getattr__(name):
    if name in _HOMES:
        return getattr(importlib.import_module(f".{_HOMES[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
