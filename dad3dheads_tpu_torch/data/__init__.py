from .io import read_as_rgb

__all__ = ["read_as_rgb"]
