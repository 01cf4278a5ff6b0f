"""Baseline-learner models: the label-embedding network and the center-loss
model (counterparts of the JAX package's ``models/learners.py``).

Both put heads on a backbone whose ``top`` emits the embedding: relu, a
BatchNorm named ``embedding_bn`` and a Dense ``prob_head``.  The labels are
a plain call argument, as in the JAX modules.  Given labels (training and
validation) each returns what its loss needs; without labels (inference:
feature extraction, serving, export) each returns ``(embedding, prob)``, as
an :class:`~.heads.EmbeddingModel` with a classification head does.
Module and parameter names follow the Flax tree, so that
:mod:`..convert` maps one onto the other.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import KerasBatchNorm, dense, keras_uniform_, upcast32


class _Heads(nn.Module):
    """Backbone -> relu -> ``embedding_bn`` -> ``prob_head`` logits."""

    def __init__(self, backbone, num_classes, generator=None):
        super().__init__()
        self.backbone = backbone
        self.num_classes = num_classes
        dim = backbone.out_features
        self.embedding_bn = KerasBatchNorm(dim)
        self.prob_head = dense(dim, num_classes, generator)

    def _embed(self, x, taps):
        embedding = self.backbone(x, taps)
        return embedding, self.embedding_bn(torch.relu(embedding))


class LabelEmbedModel(_Heads):
    """Sun et al.'s label-embedding network: two classifier heads over the
    embedding (``out2`` fed through a stop-gradient) and a learned
    (num_classes, num_classes) label-embedding table, ``labelembeddings``,
    initialized to the identity.

    ``forward(x, labels)`` returns ``(embedding, out1, out2, tar)``: the two
    heads' logits and the table's rows of the labels."""

    def __init__(self, backbone, num_classes, generator=None):
        super().__init__(backbone, num_classes, generator)
        dim = backbone.out_features
        self.out2 = dense(dim, num_classes, generator)
        self.labelembeddings = nn.Parameter(torch.eye(num_classes))

    def forward(self, x, labels=None, taps=None):
        embedding, y = self._embed(x, taps)
        out1 = self.prob_head(y)
        prob = torch.softmax(upcast32(out1), dim=-1)
        if taps is not None:
            taps["prob"] = prob
        if labels is None:
            return embedding, prob
        out2 = self.out2(y.detach())
        return embedding, out1, out2, self.labelembeddings[labels]


class CenterLossModel(_Heads):
    """Wen et al.'s softmax + center loss: a softmax head and one centroid
    per class, ``cls_centroids`` (num_classes, embed_dim), learned from
    Keras's U(-0.05, 0.05) or given (``fixed_centroids``, which the learner
    then keeps frozen).

    ``forward(x, labels)`` returns ``(embedding, prob, center_dist)``, the
    last half the squared distance of each embedding to its class's
    centroid."""

    def __init__(self, backbone, num_classes, embed_dim, fixed_centroids=None,
                 generator=None):
        super().__init__(backbone, num_classes, generator)
        if fixed_centroids is not None:
            fixed = np.asarray(fixed_centroids, dtype=np.float32)
            if fixed.shape != (num_classes, embed_dim):
                raise ValueError(
                    f"Fixed centroids shape {fixed.shape} does not match "
                    f"({num_classes}, {embed_dim}); the centroid pickle's "
                    "classes must match the dataset.")
            centroids = torch.from_numpy(fixed.copy())
        else:
            centroids = torch.empty(num_classes, embed_dim)
            keras_uniform_(centroids, generator)
        self.cls_centroids = nn.Parameter(centroids)

    def forward(self, x, labels=None, taps=None):
        embedding, y = self._embed(x, taps)
        prob = torch.softmax(upcast32(self.prob_head(y)), dim=-1)
        if taps is not None:
            taps["prob"] = prob
        if labels is None:
            return embedding, prob
        center_dist = torch.sum(
            torch.square(embedding - self.cls_centroids[labels]), dim=-1) / 2.0
        return embedding, prob, center_dist
