"""Training-time metrics (counterpart of the JAX package's
``train/metrics.py``): embedding-space nearest-neighbor accuracy and the
class-balanced accuracy.

A prediction is correct when the nearest class embedding (min Euclidean
distance or max dot product) is the target's.  The target's index is
recovered by nearest-embedding lookup of the target vector itself (exact,
since it is a row of the class matrix); ties resolve by argmax order.
"""

from __future__ import annotations

import numpy as np
import torch


def nn_accuracy(embedding, dot_prod_sim=False, k=1):
    """Per-sample accuracy of nearest-class-embedding classification.

    ``embedding``: (n_classes, d) class embedding matrix (a tensor on the
    device the metric will run on, or an array that is moved there on the
    first call).  ``dot_prod_sim``: use max dot product (assumes normalized
    embeddings) instead of min Euclidean distance.
    """
    table = {}

    def scores(y):
        """Higher = closer, shape (B, n_classes)."""
        emb = table.get(y.device)
        if emb is None:
            emb = torch.as_tensor(np.asarray(embedding, dtype=np.float32)
                                  if not torch.is_tensor(embedding)
                                  else embedding.float(), device=y.device)
            table[y.device] = emb
        sim = y @ emb.T
        if dot_prod_sim:
            return sim
        return 2.0 * sim - torch.sum(torch.square(emb), dim=1)[None, :]

    def metric(y_true, y_pred):
        s_pred = scores(y_pred.float())
        label_idx = torch.argmax(scores(y_true.float()), dim=-1)
        if k <= 1:
            return (torch.argmax(s_pred, dim=-1) == label_idx).float()
        topk = torch.argsort(-s_pred, dim=-1, stable=True)[:, :k]
        return torch.any(topk == label_idx[:, None], dim=-1).float()

    return metric


def balanced_accuracy(y_pred, y_true, num_classes=None):
    """Class-frequency-weighted ("Average") accuracy: the denominator is
    ``len(np.bincount(y_true))`` = max test label + 1, as in the original
    trainer (``num_classes`` is kept for signature compatibility)."""
    y_pred = np.asarray(y_pred)
    y_true = np.asarray(y_true)
    freq = np.bincount(y_true)
    correct = (y_pred == y_true).astype(np.float64)
    return (correct / freq[y_true]).sum() / len(freq)
