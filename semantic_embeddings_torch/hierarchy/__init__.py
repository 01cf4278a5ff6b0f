"""Class-taxonomy math: LCS / Wu-Palmer similarities as dense matrices (the
port's own copy of the JAX package's numpy-only ``hierarchy``)."""

from .class_hierarchy import ClassHierarchy
from .vectorized import pairwise_matrices, semantic_distance_matrix

__all__ = ["ClassHierarchy", "pairwise_matrices", "semantic_distance_matrix"]
