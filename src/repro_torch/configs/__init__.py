"""Architecture registry of the port: one module per assigned arch, plus
shapes.  A copy of the JAX package's ``configs`` (which imports no JAX),
so that the port imports nothing of that package."""

from .base import ARCHS, SHAPES, ModelConfig, ShapeConfig, get_config, reduced

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "reduced"]
