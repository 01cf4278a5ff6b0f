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
from .densenet import DenseNet, DenseNetFCN, sub_pixel_upscale
from .heads import EmbeddingModel, l2norm
from .layers import KerasBatchNorm
from .learners import CenterLossModel, LabelEmbedModel
from .nasnet import NASNetA
from .plainnet import PlainNet
from .pyramidnet import PyramidNet
from .resnet import ResNet
from .wrn import WideResNet

ARCHITECTURES = [
    "simple",
    "resnet-32",
    "resnet-110",
    "resnet-110-fc",
    "resnet-110-wfc",
    "wrn-28-10",
    "densenet-100-12",
    "densenet-100-24",
    "densenet-bc-190-40",
    "pyramidnet-272-200",
    "pyramidnet-110-270",
    "resnet-50",
    "resnet-101",
    "resnet-152",
    "rn18",
    "rn34",
    "rn50",
    "rn101",
    "rn152",
    "rn200",
    "nasnet-a",
]


_CIFAR_RESNETS = ["resnet-32", "resnet-110", "resnet-110-fc", "resnet-110-wfc"]
_RESNETS = ["resnet-50", "resnet-101", "resnet-152",
            "rn18", "rn34", "rn50", "rn101", "rn152", "rn200"]
_DENSENETS = {
    "densenet-100-12": dict(depth=100, growth_rate=12, bottleneck=False,
                            nb_filter=16, reduction=0.0),
    "densenet-100-24": dict(depth=100, growth_rate=24, bottleneck=False,
                            nb_filter=16, reduction=0.0),
    "densenet-bc-190-40": dict(depth=190, growth_rate=40, bottleneck=True,
                               nb_filter=-1, reduction=0.5),
}
_PYRAMIDNETS = {"pyramidnet-272-200": (272, 200), "pyramidnet-110-270": (110, 270)}


@dataclass
class ModelSpec:
    """A constructed backbone plus its training metadata."""

    architecture: str
    module: nn.Module
    #: list of (path-regex, coefficient): L2 penalty ``coef * sum(kernel**2)``
    #: added to the loss for every conv/dense kernel whose module path
    #: matches (first match wins; a coefficient of 0 exempts the kernels).
    l2_filters: list = field(default_factory=list)
    #: the input resolution the architecture is built for
    input_size: int = 32
    #: model -> (filters, groups) for :meth:`l2_penalty`
    _groups: weakref.WeakKeyDictionary = field(
        default_factory=weakref.WeakKeyDictionary, repr=False, compare=False)

    def l2_penalty(self, model):
        """Keras-style kernel regularization penalty of ``model``.

        Kernels are the ``weight`` of conv (transposed ones too) and linear
        layers, never a BN
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
                if not isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                    continue
                joined = name.replace(".", "/")
                for i, (pattern, _) in enumerate(filters):
                    if re.search(pattern, joined):
                        matched[i].append(module)
                        break
            # a rule of coefficient 0 matches its kernels to exempt them
            groups = [(coef, mods) for (_, coef), mods in zip(filters, matched)
                      if mods and coef]
            cached = self._groups[model] = (filters, groups)
        return cached[1]


def build_network(num_outputs, architecture, classification=False, no_softmax=False,
                  input_channels=3, generator=None, remat=False):
    """Constructs a CNN backbone by architecture name (one of
    :data:`ARCHITECTURES`, or one of them with the suffix ``-selu`` for SELU
    activations where the family has them).

    Embedding backbones end in a linear ``top`` with ``num_outputs`` units
    (resnet-32 and resnet-110 end in global average pooling);
    ``classification`` makes the top a softmax (``no_softmax`` keeps it
    linear) and gives resnet-32/-110 a top.  ``remat`` recomputes the
    residual blocks' activations in the backward pass (the CIFAR and
    ImageNet ResNets).  ``generator``: the ``torch.Generator`` that draws
    the initial weights.
    """
    if architecture.lower().endswith("-selu"):
        activation, architecture = "selu", architecture[:-5]
    else:
        activation = "relu"
    top = "softmax" if classification and not no_softmax else None
    common = dict(input_channels=input_channels, generator=generator)

    if architecture == "simple":
        module = PlainNet(num_outputs, activation=activation, final_activation=top,
                          **common)
        # l2(5e-4) on every conv/dense kernel except the final layer's
        return ModelSpec(architecture, module, [(r"^(?!.*top$)", 5e-4)], 32)

    if architecture in _CIFAR_RESNETS:
        n = 5 if architecture == "resnet-32" else 18
        filters = (32, 64, 128) if architecture == "resnet-110-wfc" else (16, 32, 64)
        if architecture in ("resnet-32", "resnet-110"):
            include_top, top_act = classification, None if no_softmax else "softmax"
        else:
            include_top, top_act = True, top
        module = SmallResNet(
            n=n, filters=filters, classes=num_outputs, include_top=include_top,
            top_activation=top_act, activation=activation, remat=remat, **common)
        # l2(2e-4) on every kernel incl. the top dense
        return ModelSpec(architecture, module, [(r".*", 2e-4)], 32)

    if architecture == "wrn-28-10":
        module = WideResNet(classes=num_outputs, n_blocks=4, width=10,
                            final_activation=top, **common)
        return ModelSpec(architecture, module, [], 32)  # no regularizer in ref

    if architecture in _DENSENETS:
        module = DenseNet(classes=num_outputs, nb_dense_block=3, top_activation=top,
                          **_DENSENETS[architecture], **common)
        # l2(1e-4) on the initial, bottleneck and transition convs, not on
        # the 3x3 growth convs or the top dense
        return ModelSpec(architecture, module, [(r"conv_init|_neck$|_trans$", 1e-4)], 32)

    if architecture in _PYRAMIDNETS:
        depth, alpha = _PYRAMIDNETS[architecture]
        module = PyramidNet(depth=depth, alpha=alpha, bottleneck=depth == 272,
                            classes=num_outputs, top_activation=top,
                            activation=activation, **common)
        return ModelSpec(architecture, module, [(r".*", 2e-4)], 32)

    if architecture in _RESNETS:  # resnet-50/101/152, rn18 .. rn200
        depth = int(architecture.split("-")[-1].removeprefix("rn"))
        # BN epsilon per reference constructor: resnet-50 is the legacy
        # keras.applications.ResNet50 (Keras-default 1e-3); resnet-101/152
        # come from keras_applications.resnet, whose BNs hardcode 1.001e-5;
        # the rn* constructors keep the default.
        eps = 1.001e-5 if architecture in ("resnet-101", "resnet-152") else 1e-3
        module = ResNet(depth, num_outputs, include_top=True, top_activation=top,
                        remat=remat, bn_epsilon=eps, **common)
        return ModelSpec(architecture, module, [], 224)  # no regularizer in ref

    if architecture == "nasnet-a":
        module = NASNetA(classes=num_outputs, include_top=True, top_activation=top,
                         **common)
        return ModelSpec(architecture, module, [], 224)  # no regularizer in ref

    raise ValueError(f"Unknown network architecture: {architecture}")


__all__ = [
    "ARCHITECTURES",
    "ModelSpec",
    "build_network",
    "CenterLossModel",
    "DenseNet",
    "DenseNetFCN",
    "EmbeddingModel",
    "KerasBatchNorm",
    "LabelEmbedModel",
    "NASNetA",
    "PlainNet",
    "PyramidNet",
    "ResidualBlock",
    "ResNet",
    "SmallResNet",
    "WideResNet",
    "l2norm",
    "sub_pixel_upscale",
]
