"""Analytic class-embedding solvers and pickle I/O (the port's own copy of the
JAX package's numpy-only ``embeddings``)."""

from .solvers import euclidean_embedding, mds, sim_approx, unitsphere_embedding
from .io import load_embeddings, load_features, save_embeddings, save_features

__all__ = [
    "unitsphere_embedding",
    "sim_approx",
    "euclidean_embedding",
    "mds",
    "save_embeddings",
    "load_embeddings",
    "save_features",
    "load_features",
]
