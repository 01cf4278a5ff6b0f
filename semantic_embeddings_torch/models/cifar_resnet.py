"""CIFAR-style SmallResNet (He et al. §4.2 variant with padded shortcuts).

Counterpart of the JAX package's ``models/cifar_resnet.py``: 3 stages of
``n`` two-conv blocks with BatchNorm, identity shortcuts widened by average
pooling + zero channel padding, global average pooling, and an optional
top Dense named ``top`` (linear, or softmax for classification).  The
activation is relu or SELU (the ``-selu`` architectures); ``remat``
recomputes each block's activations in the backward pass.  Module names
follow the Flax tree (``conv0``, ``bn0``, ``stage{s}_block{b}``,
``conv_a``, ...) so that :mod:`..convert` maps one onto the other by name.
(The JAX module's ``conv_shortcut``, ``use_bn=False`` and max-pooling
variants have no caller and are not ported.)
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from .layers import (
    KerasBatchNorm,
    activation_fn,
    avg_pool,
    channel_pad,
    conv,
    dense,
    global_avg_pool,
    rematerialized,
    top_output,
)


class ResidualBlock(nn.Module):
    """Two 3x3 convs, each followed by BN, with a parameter-free shortcut."""

    def __init__(self, in_features, out_features, stride=1, activation="relu",
                 generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.stride = stride
        self.activation = activation
        # A conv bias feeding BatchNorm is dead (BN subtracts the batch
        # mean), and the JAX package's tree has none: drop it likewise.
        self.conv_a = conv(in_features, out_features, 3, stride, False, generator)
        self.bn_a = KerasBatchNorm(out_features)
        self.conv_b = conv(out_features, out_features, 3, 1, False, generator)
        self.bn_b = KerasBatchNorm(out_features)

    def forward(self, x):
        act = activation_fn(self.activation)
        y = act(self.bn_a(self.conv_a(x)))
        y = self.bn_b(self.conv_b(y))
        shortcut = x
        if self.stride > 1:
            shortcut = avg_pool(shortcut, self.stride)
        if self.in_features < self.out_features:
            diff = self.out_features - self.in_features
            shortcut = channel_pad(shortcut, diff // 2, diff - diff // 2)
        return act(y + shortcut)


class SmallResNet(nn.Module):
    """Takes NHWC images; returns (B, classes) with a top, else the pooled
    (B, filters[-1]) features.  The feature taps carry the JAX module's
    ``sow`` names.  (The top is linear unless ``top_activation`` says
    otherwise; the JAX module's default is softmax.)"""

    def __init__(self, n=9, filters: Sequence[int] = (16, 32, 64), classes=100,
                 include_top=True, top_activation=None, activation="relu",
                 remat=False, input_channels=3, generator=None):
        super().__init__()
        self.include_top = include_top
        self.top_activation = top_activation
        self.activation = activation
        self.remat = remat
        self.conv0 = conv(input_channels, filters[0], 3, 1, False, generator)
        self.bn0 = KerasBatchNorm(filters[0])
        self.blocks = []
        in_f = filters[0]
        for stage, out_f in enumerate(filters):
            stride = 1 if stage == 0 else 2
            for block in range(n):
                name = f"stage{stage + 1}_block{block + 1}"
                self.add_module(name, ResidualBlock(
                    in_f if block == 0 else out_f, out_f,
                    stride if block == 0 else 1, activation, generator))
                self.blocks.append(name)
            in_f = out_f
        self.out_features = classes if include_top else filters[-1]
        if include_top:
            self.top = dense(filters[-1], classes, generator)

    def forward(self, x, taps=None):
        """``taps``: a dict that, when given, also receives the pooled
        features as ``avg_pool`` and the top's output as ``embedding`` (or
        ``prob`` under a softmax top)."""
        x = x.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        x = activation_fn(self.activation)(self.bn0(self.conv0(x)))
        for name in self.blocks:
            block = getattr(self, name)
            x = rematerialized(block, x) if self.remat else block(x)
        x = global_avg_pool(x)
        if taps is not None:
            taps["avg_pool"] = x
        if self.include_top:
            x = top_output(self.top(x), self.top_activation, taps)
        return x
