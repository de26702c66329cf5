"""The port's own copy of ``imagestitching_tpu/core``."""

from . import geometry, layout, oracle
from .layout import ImageSpec, LayoutPlan, Placement, solve

__all__ = ["geometry", "layout", "oracle", "ImageSpec", "LayoutPlan",
           "Placement", "solve"]
