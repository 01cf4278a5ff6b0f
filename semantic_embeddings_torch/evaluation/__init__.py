"""Retrieval metrics: hierarchical precision / mAHP on the host (the port's
own copy of the JAX package's numpy-only ``evaluation.hierarchical``), and
the all-pairs retrieval evaluation on the device."""

from .hierarchical import HPEvaluator, hierarchical_precision
from .retrieval import (
    evaluate_retrieval_features,
    pairwise_ranking_blocks,
    pairwise_retrieval,
)

__all__ = [
    "HPEvaluator",
    "hierarchical_precision",
    "evaluate_retrieval_features",
    "pairwise_ranking_blocks",
    "pairwise_retrieval",
]
