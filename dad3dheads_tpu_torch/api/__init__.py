from .predictor import DEFAULT_CONFIG, FaceMeshPredictor

__all__ = ["FaceMeshPredictor", "DEFAULT_CONFIG"]
