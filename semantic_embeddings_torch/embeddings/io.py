"""Pickle I/O for class-embedding dumps.

The on-disk format is bit-compatible with the original implementation's
(its ``compute_class_embedding.py:245-250``) and the JAX package's: a pickle of
``{'ind2label': list, 'label2ind': dict, 'embedding': (n, d) float array}``
where ``ind2label`` preserves original label types (int or str) and
``label2ind`` maps each label to its row index.
"""

from __future__ import annotations

import pickle

import numpy as np


def save_embeddings(path, labels, embedding):
    """Writes an embedding dump in the reference pickle format."""
    labels = list(labels)
    with open(path, "wb") as f:
        pickle.dump(
            {
                "ind2label": labels,
                "label2ind": {lbl: i for i, lbl in enumerate(labels)},
                "embedding": np.asarray(embedding),
            },
            f,
        )


def load_embeddings(path):
    """Loads an embedding dump.

    Returns ``(labels, embedding)`` — the class labels in row order and the
    (n, d) embedding matrix.
    """
    with open(path, "rb") as f:
        dump = pickle.load(f)
    return dump["ind2label"], np.asarray(dump["embedding"])


def save_features(path, features):
    """Writes test-image features in the reference format
    (``learn_image_embeddings.py:275``): ``{'feat': {index: vector}}``."""
    with open(path, "wb") as f:
        pickle.dump({"feat": dict(enumerate(np.asarray(features)))}, f)


def load_features(source):
    """Loads a feature dump (path, dict, or array).

    Returns ``(ids, features)`` where ``ids`` is None for plain arrays.
    Accepts the same inputs as the original ``evaluate_retrieval.py``'s
    ``pairwise_retrieval`` (its lines 42-54).
    """
    if isinstance(source, str):
        with open(source, "rb") as f:
            source = pickle.load(f)
    if isinstance(source, dict):
        if "feat" in source:
            source = source["feat"]
        ids = np.array(list(source.keys()))
        feats = np.stack(list(source.values()))
        if feats.ndim > 2:
            raise ValueError(
                f"Feature matrix must be 2-dimensional. Actual shape: {feats.shape}"
            )
        return ids, feats
    return None, np.asarray(source)
