"""Embedding and classification losses (counterpart of the JAX package's
``train/losses.py``).  The cosine loss also has a fused kernel pair in
:mod:`semantic_embeddings_torch.ops.cosine_loss`."""

from __future__ import annotations

import torch

_KERAS_EPS = 1e-7


def squared_distance(y_true, y_pred):
    """Per-sample squared Euclidean distance."""
    return torch.sum(torch.square(y_pred - y_true), dim=-1)


def inv_correlation(y_true, y_pred):
    """1 - <y_true, y_pred> — THE cosine loss, applied after L2
    normalization of the prediction."""
    return 1.0 - torch.sum(y_true * y_pred, dim=-1)


def categorical_crossentropy(y_true, probs):
    """Keras-style CE over probabilities (clipped like the Keras backend)."""
    probs = torch.clamp(probs, _KERAS_EPS, 1.0 - _KERAS_EPS)
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    return -torch.sum(y_true * torch.log(probs), dim=-1)
