"""Retrieval metrics on the host: hierarchical precision / mAHP (the port's
own copy of the JAX package's numpy-only ``evaluation.hierarchical``)."""

from .hierarchical import HPEvaluator, hierarchical_precision

__all__ = ["HPEvaluator", "hierarchical_precision"]
