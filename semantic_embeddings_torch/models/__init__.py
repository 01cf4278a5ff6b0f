"""CNN models and the architecture factory (counterpart of the JAX package's
``models/__init__.py``).

``build_network`` returns a :class:`ModelSpec` whose ``l2_filters`` give the
per-architecture Keras kernel regularization as (module-path regex,
coefficient) pairs, so the trainer adds the exact penalty to the loss.
"""

from __future__ import annotations

import re
import weakref
from dataclasses import dataclass, field

import torch
from torch import nn

from .cifar_resnet import ResidualBlock, SmallResNet
from .heads import EmbeddingModel, l2norm
from .layers import KerasBatchNorm
from .resnet import ResNet

_CIFAR_RESNETS = ["resnet-32", "resnet-110", "resnet-110-fc", "resnet-110-wfc"]
#: architectures ported so far; the JAX package's others come in later work
ARCHITECTURES = _CIFAR_RESNETS + [
    "resnet-50", "resnet-101", "resnet-152",
    "rn18", "rn34", "rn50", "rn101", "rn152", "rn200",
]


@dataclass
class ModelSpec:
    """A constructed backbone plus its training metadata."""

    architecture: str
    module: nn.Module
    #: list of (path-regex, coefficient): L2 penalty ``coef * sum(kernel**2)``
    #: added to the loss for every conv/dense kernel whose module path
    #: matches (first match wins).
    l2_filters: list = field(default_factory=list)
    #: the input resolution the architecture is built for
    input_size: int = 32
    #: model -> (filters, groups) for :meth:`l2_penalty`
    _groups: weakref.WeakKeyDictionary = field(
        default_factory=weakref.WeakKeyDictionary, repr=False, compare=False)

    def l2_penalty(self, model):
        """Keras-style kernel regularization penalty of ``model``.

        Kernels are the ``weight`` of conv and linear layers, never a BN
        ``weight`` or any bias.  The module path is matched in the Flax
        tree's form (``backbone/stage1_block1/conv_a``).  The matching runs
        once per model and filter list; each step then takes one
        multi-tensor norm per coefficient.
        """
        total = 0.0
        for coef, modules in self._l2_groups(model):
            norms = torch._foreach_norm([m.weight for m in modules])
            total = total + coef * torch.sum(torch.square(torch.stack(norms)))
        return total

    def _l2_groups(self, model):
        """(coef, kernel modules) for each filter that matches any."""
        filters = tuple(self.l2_filters)
        cached = self._groups.get(model)
        if cached is None or cached[0] != filters:
            matched = [[] for _ in filters]
            for name, module in model.named_modules():
                if not isinstance(module, (nn.Conv2d, nn.Linear)):
                    continue
                joined = name.replace(".", "/")
                for i, (pattern, _) in enumerate(filters):
                    if re.search(pattern, joined):
                        matched[i].append(module)
                        break
            groups = [(coef, mods) for (_, coef), mods in zip(filters, matched) if mods]
            cached = self._groups[model] = (filters, groups)
        return cached[1]


def build_network(num_outputs, architecture, input_channels=3, generator=None):
    """Constructs an embedding backbone by architecture name.

    resnet-32 and resnet-110 end in global average pooling; the -fc and
    -wfc variants and the ImageNet ResNets add a linear top Dense with
    ``num_outputs`` units.  ``generator``: the ``torch.Generator`` that
    draws the initial weights.
    """
    if architecture in _CIFAR_RESNETS:
        n = 5 if architecture == "resnet-32" else 18
        filters = (32, 64, 128) if architecture == "resnet-110-wfc" else (16, 32, 64)
        module = SmallResNet(
            n=n, filters=filters, classes=num_outputs,
            include_top=architecture.endswith("fc"),
            input_channels=input_channels, generator=generator,
        )
        # l2(2e-4) on every kernel incl. the top dense
        return ModelSpec(architecture, module, [(r".*", 2e-4)])

    if architecture in ARCHITECTURES:  # resnet-50/101/152, rn18 .. rn200
        depth = int(architecture.split("-")[-1].removeprefix("rn"))
        # BN epsilon per reference constructor: resnet-50 is the legacy
        # keras.applications.ResNet50 (Keras-default 1e-3); resnet-101/152
        # come from keras_applications.resnet, whose BNs hardcode 1.001e-5;
        # the rn* constructors keep the default.
        eps = 1.001e-5 if architecture in ("resnet-101", "resnet-152") else 1e-3
        module = ResNet(depth, num_outputs, include_top=True, bn_epsilon=eps,
                        input_channels=input_channels, generator=generator)
        return ModelSpec(architecture, module, [], 224)  # no regularizer in ref

    raise ValueError(
        f"Unknown or not yet ported network architecture: {architecture}")


__all__ = [
    "ARCHITECTURES",
    "ModelSpec",
    "build_network",
    "EmbeddingModel",
    "KerasBatchNorm",
    "ResidualBlock",
    "ResNet",
    "SmallResNet",
    "l2norm",
]
