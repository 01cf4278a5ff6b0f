"""Shared building blocks for the model zoo (counterpart of the JAX package's
``models/layers.py``).

Keras-semantic defaults are kept where they affect training parity:
glorot-uniform kernel init with zero biases, BatchNorm momentum 0.99 /
epsilon 1e-3 with a biased running variance, TF "SAME" padding.  The public
model functions take NHWC images; inside, the layers work in NCHW.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def upcast32(x):
    """Upcast-only stability cast: bf16/f16 -> f32, f32 -> f32, f64 -> f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _glorot_uniform_(weight, generator):
    # torch's fan computation for conv (in*kh*kw, out*kh*kw) and linear
    # weights equals Keras's, so xavier_uniform_ is glorot_uniform.
    nn.init.xavier_uniform_(weight, generator=generator)


def _same_padding(size, kernel, stride):
    """TF SAME padding (before, after) along one axis."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` with TF "SAME" padding, computed per call.

    TF SAME puts the odd pixel of padding after, not before: a stride-2 3x3
    conv on an even input pads (0, 1), where ``padding=1`` would pad (1, 1)
    and shift every downsampling stage by one pixel.
    """

    def __init__(self, in_features, features, kernel, stride=1, use_bias=True,
                 generator=None):
        super().__init__(in_features, features, kernel, stride=stride,
                         padding=0, bias=use_bias)
        _glorot_uniform_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        ph = _same_padding(x.shape[2], k, s)
        pw = _same_padding(x.shape[3], k, s)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, self.bias, s, (ph[0], pw[0]))
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, self.bias, s)


def conv(in_features, features, kernel=3, stride=1, use_bias=True,
         generator=None):
    """3x3-style SAME conv with Keras-like defaults."""
    return Conv2dSame(in_features, features, kernel, stride, use_bias, generator)


def dense(in_features, features, generator=None):
    layer = nn.Linear(in_features, features)
    _glorot_uniform_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


class KerasBatchNorm(nn.Module):
    """BatchNorm with Keras defaults (momentum 0.99, eps 1e-3) and Flax's
    running-statistics update.

    Normalization runs through ``F.batch_norm`` (cuDNN on the card) over the
    channel axis 1 of a (N, C, ...) input.  ``F.batch_norm`` would move the
    running variance towards the *unbiased* batch variance; Flax (and Keras)
    move it towards the biased one, so the update is corrected right after.
    """

    def __init__(self, features, momentum=0.99, epsilon=1e-3):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.epsilon)
        m = self.momentum
        old_var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                         self.bias, True, 1.0 - m, self.epsilon)
        # running_var is now m*old + (1-m)*var*n/(n-1); make it
        # m*old + (1-m)*var.  Out of place, then rebound: autograd saved the
        # updated tensor for the backward and checks it was not modified.
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var = torch.sub(
                self.running_var, old_var, alpha=m).mul_((n - 1) / n).add_(
                    old_var, alpha=m)
        return y


def channel_pad(x, before, after):
    """Zero-padding along the channel axis of an NCHW tensor."""
    return F.pad(x, (0, 0, 0, 0, int(before), int(after)))


def avg_pool(x, window, stride=None):
    """VALID average pooling (the only form the CIFAR ResNets use)."""
    return F.avg_pool2d(x, window, stride or window)


def global_avg_pool(x):
    return torch.mean(x, dim=(2, 3))


def global_max_pool(x):
    return torch.amax(x, dim=(2, 3))
