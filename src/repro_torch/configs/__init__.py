"""Config registry: one module per assigned architecture, and the shape sets
(copied from the reference package; pure dataclasses)."""

from .base import ArchConfig, ArchEntry, MoEConfig, RGLRUConfig, SSMConfig, get_arch, list_archs
from .shapes import ALL_SHAPE_IDS, SHAPES, ShapeSpec, get_shape

__all__ = [
    "ArchConfig",
    "ArchEntry",
    "MoEConfig",
    "RGLRUConfig",
    "SSMConfig",
    "get_arch",
    "list_archs",
    "SHAPES",
    "ALL_SHAPE_IDS",
    "ShapeSpec",
    "get_shape",
]
