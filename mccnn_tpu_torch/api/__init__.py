"""Hierarchy construction and the spatial-query cache."""

from .builder import SpatialCache
from .hierarchy import (
    GLOBAL_RADIUS,
    HierarchyLevel,
    PointHierarchy,
    build_hierarchy,
    default_level_caps,
)

__all__ = [
    "GLOBAL_RADIUS",
    "HierarchyLevel",
    "PointHierarchy",
    "SpatialCache",
    "build_hierarchy",
    "default_level_caps",
]
