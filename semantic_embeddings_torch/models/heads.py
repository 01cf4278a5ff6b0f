"""Output heads composing a backbone into a trainable model (counterpart of
the JAX package's ``models/heads.py``): an optional output transform (L2
normalization for the cosine loss, softmax for softmax_corr) and an optional
classification head (relu -> BN -> Dense -> softmax ``prob``)."""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..ops.cosine_loss import l2_normalize as l2norm
from .layers import KerasBatchNorm, dense, upcast32

OUTPUTS = ("linear", "l2norm", "softmax")


class EmbeddingModel(nn.Module):
    """Backbone + output transform + optional softmax classification head.

    Returns the transformed embedding, or ``(embedding, prob)`` when a
    classification head is attached (``cls_classes > 0``).  The head reads
    the transformed output; ``cls_input='l2norm'`` reproduces that when
    ``output='linear'`` is used so the fused cosine-loss kernel can consume
    raw embeddings.  :meth:`twin` gives the same modules under another
    output transform (the train and eval models of one run).
    """

    def __init__(self, backbone, output="linear", cls_classes=0,
                 cls_input="output", generator=None):
        super().__init__()
        if output not in OUTPUTS:
            raise ValueError(f"output must be one of {OUTPUTS}, not {output!r}")
        self.backbone = backbone
        self.output = output
        self.cls_classes = cls_classes
        self.cls_input = cls_input
        if cls_classes > 0:
            dim = backbone.out_features
            self.cls_bn = KerasBatchNorm(dim)
            self.cls_top = dense(dim, cls_classes, generator)

    def twin(self, output, cls_input="output"):
        """A model over the same parameters and buffers with another output
        transform (a shallow copy: the submodules are shared, not copied)."""
        other = copy.copy(self)
        other.output = output
        other.cls_input = cls_input
        return other

    def forward(self, x, taps=None):
        """``taps``: a dict that, when given, also receives the backbone's
        taps and the output transform's (``l2norm`` or ``softmax``) and the
        head's ``prob``, the JAX modules' ``sow`` names and values."""
        emb = self.backbone(x, taps)
        if self.output == "l2norm":
            emb = l2norm(upcast32(emb))
        elif self.output == "softmax":
            emb = torch.softmax(upcast32(emb), dim=-1)
        if taps is not None and self.output != "linear":
            taps[self.output] = emb

        if self.cls_classes > 0:
            head_in = l2norm(upcast32(emb)) if self.cls_input == "l2norm" else emb
            y = torch.relu(head_in)
            y = self.cls_bn(y)
            y = self.cls_top(y)
            prob = torch.softmax(upcast32(y), dim=-1)
            if taps is not None:
                taps["prob"] = prob
            return emb, prob
        return emb
