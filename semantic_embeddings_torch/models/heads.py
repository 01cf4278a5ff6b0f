"""Output heads composing a backbone into a trainable model (counterpart of
the JAX package's ``models/heads.py``): an optional output transform (L2
normalization for the cosine loss, softmax for softmax_corr) and an optional
classification head (relu -> BN -> Dense -> softmax ``prob``), on the
output or on a named backbone module's (``cls_base``)."""

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

    ``cls_base`` puts the head on the output of a named backbone module
    instead (the reference's ``get_layer(name).output``), matched as the
    JAX package matches it: the module's full path with ``/`` (``backbone/
    stage2_block3/conv_a``), a unique trailing part of it, or its own name.
    The module is found once, here; its output is caught by a forward hook
    that lives for one call.  No match, more than one, or an output that is
    not (batch, features) raise ``ValueError``.  The head is as wide as that
    output, found by one eval-mode forward of a zero batch of shape
    (1, *``input_shape``), NHWC.
    """

    def __init__(self, backbone, output="linear", cls_classes=0,
                 cls_input="output", generator=None, cls_base=None,
                 input_shape=(32, 32, 3)):
        super().__init__()
        if output not in OUTPUTS:
            raise ValueError(f"output must be one of {OUTPUTS}, not {output!r}")
        self.backbone = backbone
        self.output = output
        self.cls_classes = cls_classes
        self.cls_input = cls_input
        self.cls_base = cls_base if cls_classes > 0 else None
        if cls_classes > 0:
            dim = backbone.out_features
            if self.cls_base is not None:
                self._tap_name = _find_module(backbone, self.cls_base)
                dim = self._tap_width(input_shape)
            self.cls_bn = KerasBatchNorm(dim)
            self.cls_top = dense(dim, cls_classes, generator)

    def _tap_width(self, input_shape):
        was_training = self.backbone.training
        param = next(self.backbone.parameters())
        self.backbone.eval()
        try:
            with torch.no_grad():
                x = torch.zeros((1, *input_shape), dtype=param.dtype, device=param.device)
                _, tapped = self._backbone_tapped(x, None)
        finally:
            self.backbone.train(was_training)
        if tapped.ndim != 2:
            raise ValueError(
                f"cls_base={self.cls_base!r} output has shape {tuple(tapped.shape)}; the "
                "classification head needs a flat (batch, features) tap: name a "
                "dense or pooled module such as 'top'")
        return tapped.shape[-1]

    def _backbone_tapped(self, x, taps):
        """The backbone's output, and the output of the module ``cls_base``
        names in this call."""
        found = []
        handle = self.backbone.get_submodule(self._tap_name).register_forward_hook(
            lambda m, args, out: found.append(out))
        try:
            emb = self.backbone(x, taps)
        finally:
            handle.remove()
        if not found:
            raise ValueError(f"cls_base={self.cls_base!r}: the backbone's forward does "
                             f"not call {self._tap_name!r}")
        return emb, found[-1]

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
        tapped = None
        if self.cls_base is not None:
            emb, tapped = self._backbone_tapped(x, taps)
        else:
            emb = self.backbone(x, taps)
        if self.output == "l2norm":
            emb = l2norm(upcast32(emb))
        elif self.output == "softmax":
            emb = torch.softmax(upcast32(emb), dim=-1)
        if taps is not None and self.output != "linear":
            taps[self.output] = emb

        if self.cls_classes > 0:
            if tapped is not None:
                head_in = tapped
            elif self.cls_input == "l2norm":
                head_in = l2norm(upcast32(emb))
            else:
                head_in = emb
            y = torch.relu(head_in)
            y = self.cls_bn(y)
            y = self.cls_top(y)
            prob = torch.softmax(upcast32(y), dim=-1)
            if taps is not None:
                taps["prob"] = prob
            return emb, prob
        return emb


def _find_module(backbone, want):
    """The dotted name in ``backbone`` of the one module that ``want``
    names: its full path with ``/`` from ``backbone``, or a trailing part."""
    found = []
    for name, _ in backbone.named_modules(prefix="backbone"):
        path = name.replace(".", "/")
        if path == want or path.endswith("/" + want):
            found.append(path)
    if not found:
        raise ValueError(f"cls_base={want!r} matched no module in the backbone")
    if len(found) > 1:
        raise ValueError(f"cls_base={want!r} is ambiguous; candidates: "
                         f"{sorted(found)}: use a full module path")
    return found[0].partition("/")[2].replace("/", ".")
