"""PyramidNet for CIFAR (Han et al.): channel counts that grow linearly.

Counterpart of the JAX package's ``models/pyramidnet.py``: BN-first basic or
bottleneck blocks with glorot-normal bias-free convs, shortcuts through a
2x2 VALID average pool (where the block strides) and a zero channel pad
after the input's channels, the channel count grown by ``alpha / (3n)``
before every block and rounded with Python's ``round`` (half to even, as
the JAX module does), then a final BN + activation + global average pooling
+ a dense ``top``.  Module names follow the Flax tree (``conv0``, ``bn0``,
``stage{s}_block{b}/{bn_in,conv_a,bn_a,...}``, ``bn_final``, ``top``).
"""

from __future__ import annotations

from torch import nn

from .layers import (
    KerasBatchNorm,
    activation_fn,
    avg_pool,
    channel_pad,
    conv,
    dense,
    global_avg_pool,
    top_output,
)


def _conv(cin, cout, kernel, stride, generator):
    return conv(cin, cout, kernel, stride, False, generator, kernel_init="glorot_normal")


class PyramidBlock(nn.Module):
    """Bottleneck: BN, 1x1, BN, act, 3x3 (strided), BN, act, 1x1 (x4), BN.
    Basic: BN, 3x3 (strided), BN, act, 3x3, BN."""

    def __init__(self, in_features, features, stride=1, bottleneck=True,
                 activation="relu", generator=None):
        super().__init__()
        self.stride = stride
        self.bottleneck = bottleneck
        self.activation = activation
        n = features
        self.in_features = in_features
        self.bn_in = KerasBatchNorm(in_features)
        if bottleneck:
            self.conv_a = _conv(in_features, n, 1, 1, generator)
            self.bn_a = KerasBatchNorm(n)
            self.conv_b = _conv(n, n, 3, stride, generator)
            self.bn_b = KerasBatchNorm(n)
            self.conv_c = _conv(n, n * 4, 1, 1, generator)
            self.bn_c = KerasBatchNorm(n * 4)
            self.out_features = n * 4
        else:
            self.conv_a = _conv(in_features, n, 3, stride, generator)
            self.bn_a = KerasBatchNorm(n)
            self.conv_b = _conv(n, n, 3, 1, generator)
            self.bn_b = KerasBatchNorm(n)
            self.out_features = n

    def forward(self, x):
        act = activation_fn(self.activation)
        s = self.bn_a(self.conv_a(self.bn_in(x)))
        s = self.bn_b(self.conv_b(act(s)))
        if self.bottleneck:
            s = self.bn_c(self.conv_c(act(s)))
        shortcut = avg_pool(x, self.stride) if self.stride > 1 else x
        if self.in_features < self.out_features:
            shortcut = channel_pad(shortcut, 0, self.out_features - self.in_features)
        return s + shortcut


class PyramidNet(nn.Module):
    """Takes NHWC images; returns (B, classes) with a top, else the pooled
    features."""

    def __init__(self, depth=272, alpha=200, bottleneck=True, classes=100,
                 include_top=True, top_activation="softmax", activation="relu",
                 input_channels=3, generator=None):
        super().__init__()
        self.include_top = include_top
        self.top_activation = top_activation
        self.activation = activation
        n = (depth - 2) // (9 if bottleneck else 6)
        add_channel = float(alpha) / (3 * n)
        self.conv0 = _conv(input_channels, 16, 3, 1, generator)
        self.bn0 = KerasBatchNorm(16)
        self.blocks = []
        channels, cin = 16.0, 16
        for stage in range(3):
            for block in range(n):
                channels += add_channel
                name = f"stage{stage + 1}_block{block + 1}"
                module = PyramidBlock(
                    cin, round(channels), stride=2 if (stage > 0 and block == 0) else 1,
                    bottleneck=bottleneck, activation=activation, generator=generator)
                self.add_module(name, module)
                self.blocks.append(name)
                cin = module.out_features
        self.bn_final = KerasBatchNorm(cin)
        self.out_features = classes if include_top else cin
        if include_top:
            self.top = dense(cin, classes, generator)

    def forward(self, x, taps=None):
        """``taps``: a dict that, when given, also receives the pooled
        features as ``avg_pool`` and the top's output as ``embedding`` (or
        ``prob`` under a softmax top)."""
        x = x.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        x = self.bn0(self.conv0(x))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = global_avg_pool(activation_fn(self.activation)(self.bn_final(x)))
        if taps is not None:
            taps["avg_pool"] = x
        if self.include_top:
            x = top_output(self.top(x), self.top_activation, taps)
        return x
