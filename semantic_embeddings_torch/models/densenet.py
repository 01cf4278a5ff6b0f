"""DenseNet for CIFAR (Huang et al.): 100-12, 100-24 and BC-190-40, and the
fully convolutional DenseNet with its sub-pixel upscaling.

Counterpart of the JAX package's ``models/densenet.py``: BN (epsilon
1.1e-5) -> relu -> [1x1 bottleneck of 4 x growth] -> 3x3 growth conv, each
layer's output concatenated after its input (``[x, y]``), transitions of
``int(nb_filter * compression)`` 1x1 filters and a 2x2 average pool,
he-normal bias-free convs, then a final BN + relu + global average pooling
+ a dense ``top``.  Module names are the Flax names (``conv_init``,
``b{block}_l{i}_{bn,neck,neck_bn,grow}``, ``b{block}_trans{,_bn}``,
``bn_final``, ``top``): the reference's L2 rule picks the initial,
bottleneck and transition convs by them (``conv_init|_neck$|_trans$``).
(The JAX ``DenseNet``'s ``dropout`` and ``subsample_initial_block`` have
no caller and are not ported.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    ConvTranspose2dSame,
    KerasBatchNorm,
    avg_pool,
    conv,
    crop_like,
    dense,
    global_avg_pool,
    max_pool,
    top_output,
    upcast32,
    upsample,
)


def _bn(features):
    return KerasBatchNorm(features, momentum=0.99, epsilon=1.1e-5)


def _conv(cin, cout, kernel, generator):
    return conv(cin, cout, kernel, 1, False, generator, kernel_init="he_normal")


def sub_pixel_upscale(x, scale=2):
    """Sub-pixel (depth-to-space) upscaling of an NCHW ``x``, with the JAX
    package's channel order: input channel ``(i * scale + j) * oc + c`` goes
    to output channel ``c`` at row offset ``i`` and column offset ``j``.
    (``F.pixel_shuffle`` reads channel ``c * scale**2 + i * scale + j``
    instead.)"""
    b, ch, h, w = x.shape
    oc = ch // (scale * scale)
    x = x.reshape(b, scale, scale, oc, h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)  # (b, oc, h, i, w, j)
    return x.reshape(b, oc, h * scale, w * scale)


class DenseNetFCN(nn.Module):
    """Fully convolutional DenseNet (Tiramisu-style encoder/decoder): dense
    blocks down a 2x2 max-pool path with skip connections, upsampling by a
    transposed conv (``deconv``), a conv + :func:`sub_pixel_upscale`
    (``subpixel``) or nearest neighbours (``upsampling``), and a 1x1 conv
    head with a softmax over the classes.  Takes NHWC images whose sides
    divide by 2**nb_dense_block; returns NHWC (B, H, W, classes)."""

    def __init__(self, classes=12, nb_dense_block=5, growth_rate=16,
                 layers_per_block=4, init_conv_filters=48, upsampling_type="deconv",
                 top_activation="softmax", input_channels=3, generator=None):
        super().__init__()
        if upsampling_type not in ("deconv", "subpixel", "upsampling"):
            raise ValueError(f"unknown upsampling_type {upsampling_type!r}")
        self.nb_dense_block = nb_dense_block
        self.layers_per_block = layers_per_block
        self.upsampling_type = upsampling_type
        self.top_activation = top_activation
        g = growth_rate

        def dense_block(prefix, channels):
            for i in range(layers_per_block):
                self.add_module(f"{prefix}_l{i}_bn", _bn(channels))
                self.add_module(f"{prefix}_l{i}_grow", _conv(channels, g, 3, generator))
                channels += g
            return channels

        self.conv_init = _conv(input_channels, init_conv_filters, 3, generator)
        channels, skips = init_conv_filters, []
        for d in range(nb_dense_block):
            channels = dense_block(f"down{d}", channels)
            skips.append(channels)
            self.add_module(f"down{d}_td_bn", _bn(channels))
            self.add_module(f"down{d}_td_conv", _conv(channels, channels, 1, generator))
        dense_block("bottleneck", channels)
        channels = layers_per_block * g
        for d in reversed(range(nb_dense_block)):
            if upsampling_type == "subpixel":
                self.add_module(f"up{d}_sp", _conv(channels, channels * 4, 3, generator))
            elif upsampling_type == "deconv":
                self.add_module(f"up{d}_deconv", ConvTranspose2dSame(
                    channels, channels, 3, 2, generator=generator))
            dense_block(f"up{d}", channels + skips[d])
            channels = layers_per_block * g
        self.head = conv(channels, classes, 1, 1, True, generator, kernel_init="he_normal")

    def _dense_block(self, x, prefix):
        """(x with every new layer's output after it, the new outputs)."""
        m, feats = self._modules, []
        for i in range(self.layers_per_block):
            y = m[f"{prefix}_l{i}_grow"](torch.relu(m[f"{prefix}_l{i}_bn"](x)))
            feats.append(y)
            x = torch.cat([x, y], dim=1)
        return x, torch.cat(feats, dim=1)

    def _upsample(self, x, prefix):
        if self.upsampling_type == "upsampling":
            return upsample(x, lambda z: F.interpolate(z, scale_factor=2, mode="nearest"))
        if self.upsampling_type == "subpixel":
            return upsample(self._modules[f"{prefix}_sp"](torch.relu(x)),
                            lambda z: sub_pixel_upscale(z, 2))
        return self._modules[f"{prefix}_deconv"](torch.relu(x))

    def forward(self, x):
        m = self._modules
        x = self.conv_init(x.permute(0, 3, 1, 2).contiguous())  # NHWC -> NCHW
        skips = []
        for d in range(self.nb_dense_block):
            x, _ = self._dense_block(x, f"down{d}")
            skips.append(x)
            y = torch.relu(m[f"down{d}_td_bn"](x))
            x = max_pool(m[f"down{d}_td_conv"](y), 2)
        _, x = self._dense_block(x, "bottleneck")  # only the new features go up
        for d in reversed(range(self.nb_dense_block)):
            x = self._upsample(x, f"up{d}")
            skip = skips[d]
            # crop to the skip's size where upsampling overshoots odd sizes
            x = crop_like(x, skip)
            _, x = self._dense_block(torch.cat([x, skip], dim=1), f"up{d}")
        x = self.head(x)
        if self.top_activation == "softmax":
            x = torch.softmax(upcast32(x), dim=1)
        return x.permute(0, 2, 3, 1)  # NCHW -> NHWC


class DenseNet(nn.Module):
    """Takes NHWC images; returns (B, classes) with a top, else the pooled
    features."""

    def __init__(self, classes=100, depth=100, growth_rate=12, nb_dense_block=3,
                 bottleneck=False, reduction=0.0, nb_filter=-1, include_top=True,
                 top_activation="softmax", input_channels=3, generator=None):
        super().__init__()
        self.include_top = include_top
        self.top_activation = top_activation
        self.bottleneck = bottleneck
        count = (depth - 4) // 3
        if bottleneck:
            count //= 2
        self.layers_per_block = [count] * nb_dense_block
        nb_filter = nb_filter if nb_filter > 0 else 2 * growth_rate
        compression = 1.0 - reduction

        self.conv_init = _conv(input_channels, nb_filter, 3, generator)
        for block_idx, n_layers in enumerate(self.layers_per_block):
            for i in range(n_layers):
                prefix = f"b{block_idx}_l{i}"
                self.add_module(f"{prefix}_bn", _bn(nb_filter))
                cin = nb_filter
                if bottleneck:
                    self.add_module(f"{prefix}_neck", _conv(cin, 4 * growth_rate, 1, generator))
                    self.add_module(f"{prefix}_neck_bn", _bn(4 * growth_rate))
                    cin = 4 * growth_rate
                self.add_module(f"{prefix}_grow", _conv(cin, growth_rate, 3, generator))
                nb_filter += growth_rate
            if block_idx != nb_dense_block - 1:
                self.add_module(f"b{block_idx}_trans_bn", _bn(nb_filter))
                cin, nb_filter = nb_filter, int(nb_filter * compression)
                self.add_module(f"b{block_idx}_trans", _conv(cin, nb_filter, 1, generator))
        self.bn_final = _bn(nb_filter)
        self.out_features = classes if include_top else nb_filter
        if include_top:
            self.top = dense(nb_filter, classes, generator)

    def forward(self, x, taps=None):
        """``taps``: a dict that, when given, also receives the pooled
        features as ``avg_pool`` and the top's output as ``embedding`` (or
        ``prob`` under a softmax top)."""
        m = self._modules
        x = self.conv_init(x.permute(0, 3, 1, 2).contiguous())  # NHWC -> NCHW
        last = len(self.layers_per_block) - 1
        for block_idx, n_layers in enumerate(self.layers_per_block):
            for i in range(n_layers):
                prefix = f"b{block_idx}_l{i}"
                y = torch.relu(m[f"{prefix}_bn"](x))
                if self.bottleneck:
                    y = torch.relu(m[f"{prefix}_neck_bn"](m[f"{prefix}_neck"](y)))
                y = m[f"{prefix}_grow"](y)
                x = torch.cat([x, y], dim=1)
            if block_idx != last:
                x = torch.relu(m[f"b{block_idx}_trans_bn"](x))
                x = avg_pool(m[f"b{block_idx}_trans"](x), 2)
        x = global_avg_pool(torch.relu(self.bn_final(x)))
        if taps is not None:
            taps["avg_pool"] = x
        if self.include_top:
            x = top_output(self.top(x), self.top_activation, taps)
        return x
