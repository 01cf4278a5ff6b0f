"""Wide Residual Network (Zagoruyko & Komodakis), WRN-28-10 for CIFAR.

Counterpart of the JAX package's ``models/wrn.py``: he-normal bias-free
convs; every BatchNorm has momentum 0.1 (the running statistics keep 10% of
their old value), epsilon 1e-5 and its scale drawn from Keras's 'uniform',
U(-0.05, 0.05); per group one expansion block (conv-BN-relu-conv with a 1x1
strided skip conv) and ``n_blocks - 1`` pre-activation blocks, widths
``[16, 32, 64] * width``.  Module names follow the Flax tree (``conv0``,
``g{g}_expand_a``, ``g{g}_b{b}_bn_a``, ``top``, ...).  (The JAX module's
``dropout`` has no caller and is not ported.)
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import KerasBatchNorm, conv, dense, global_avg_pool, keras_uniform_, top_output


class WideResNet(nn.Module):
    """Takes NHWC images; returns (B, classes)."""

    def __init__(self, classes=100, n_blocks=4, width=10, final_activation="softmax", input_channels=3, generator=None):
        super().__init__()
        self.n_blocks = n_blocks
        self.final_activation = final_activation

        def conv_(name, cin, cout, kernel, stride=1):
            self.add_module(name, conv(cin, cout, kernel, stride, False, generator,
                                       kernel_init="he_normal"))

        def bn(name, features):
            self.add_module(name, KerasBatchNorm(
                features, momentum=0.1, epsilon=1e-5, scale_init=keras_uniform_,
                generator=generator))

        conv_("conv0", input_channels, 16, 3)
        bn("bn0", 16)
        cin = 16
        for g, base in enumerate((16, 32, 64)):
            feats = base * width
            stride = 2 if g > 0 else 1
            conv_(f"g{g}_expand_a", cin, feats, 3, stride)
            bn(f"g{g}_expand_bn", feats)
            conv_(f"g{g}_expand_b", feats, feats, 3)
            conv_(f"g{g}_skip", cin, feats, 1, stride)
            for b in range(n_blocks - 1):
                bn(f"g{g}_b{b}_bn_a", feats)
                conv_(f"g{g}_b{b}_conv_a", feats, feats, 3)
                bn(f"g{g}_b{b}_bn_b", feats)
                conv_(f"g{g}_b{b}_conv_b", feats, feats, 3)
            bn(f"g{g}_bn_out", feats)
            cin = feats
        self.top = dense(cin, classes, generator)
        self.out_features = classes

    def forward(self, x, taps=None):
        """``taps``: a dict that, when given, also receives the pooled
        features as ``avg_pool`` and the top's output as ``embedding`` (or
        ``prob`` under a softmax top)."""
        m = self._modules
        x = x.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        x = torch.relu(m["bn0"](m["conv0"](x)))
        for g in range(3):
            y = torch.relu(m[f"g{g}_expand_bn"](m[f"g{g}_expand_a"](x)))
            x = m[f"g{g}_expand_b"](y) + m[f"g{g}_skip"](x)
            for b in range(self.n_blocks - 1):
                y = m[f"g{g}_b{b}_conv_a"](torch.relu(m[f"g{g}_b{b}_bn_a"](x)))
                y = m[f"g{g}_b{b}_conv_b"](torch.relu(m[f"g{g}_b{b}_bn_b"](y)))
                x = x + y
            x = torch.relu(m[f"g{g}_bn_out"](x))
        x = global_avg_pool(x)
        if taps is not None:
            taps["avg_pool"] = x
        return top_output(self.top(x), self.final_activation, taps)
