"""Shared building blocks for the model zoo (counterpart of the JAX package's
``models/layers.py``).

Keras-semantic defaults are kept where they affect training parity:
glorot-uniform kernel init with zero biases (he-normal where the JAX
package asks for it), BatchNorm momentum 0.99 / epsilon 1e-3 with a biased
running variance, TF "SAME" padding.  The public model functions take NHWC
images; inside, the layers work in NCHW.
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


def _he_normal_(weight, generator):
    # Flax's he_normal: a normal of variance 2 / fan_in truncated at two
    # standard deviations, its scale corrected for the truncation (the
    # constant is the std of a unit normal truncated to [-2, 2]).
    fan_in = nn.init._calculate_fan_in_and_fan_out(weight)[0]
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


KERNEL_INITS = {"glorot_uniform": _glorot_uniform_, "he_normal": _he_normal_}


def _same_padding(size, kernel, stride):
    """TF SAME padding (before, after) along one axis."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` with TF "SAME" padding, computed per call, or none
    (``padding="VALID"``).

    TF SAME puts the odd pixel of padding after, not before: a stride-2 3x3
    conv on an even input pads (0, 1), where ``padding=1`` would pad (1, 1)
    and shift every downsampling stage by one pixel.
    """

    def __init__(self, in_features, features, kernel, stride=1, use_bias=True,
                 generator=None, padding="SAME", kernel_init="glorot_uniform"):
        super().__init__(in_features, features, kernel, stride=stride,
                         padding=0, bias=use_bias)
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, not {padding!r}")
        self.same = padding == "SAME"
        KERNEL_INITS[kernel_init](self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        if not self.same:
            return F.conv2d(x, self.weight, self.bias, s)
        ph = _same_padding(x.shape[2], k, s)
        pw = _same_padding(x.shape[3], k, s)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, self.bias, s, (ph[0], pw[0]))
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, self.bias, s)


def conv(in_features, features, kernel=3, stride=1, use_bias=True,
         generator=None, padding="SAME", kernel_init="glorot_uniform"):
    """3x3-style SAME conv with Keras-like defaults."""
    return Conv2dSame(in_features, features, kernel, stride, use_bias, generator,
                      padding, kernel_init)


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

    def forward_from_stats(self, y, s, ss):
        """BatchNorm of NCHW ``y`` whose per-channel f32 sums ``s`` = sum(y)
        and ``ss`` = sum(y**2) over (N, H, W) are given (by the fused conv
        of :mod:`..ops.conv3x3`).

        Training uses the batch statistics as Flax's ``nn.BatchNorm`` forms
        them (``use_fast_variance``): mean = s / n and var = max(0, ss / n -
        mean**2), with n = N*H*W; the running statistics move towards that
        mean and that biased var.  Evaluation uses the running statistics
        and leaves ``s`` and ``ss`` unused.  The normalization runs in f32
        (f64 for f64 y) and the result is cast back to y's dtype, as Flax's
        ``BatchNorm(dtype=bf16)`` does.
        """
        if self.training:
            n = y.numel() // y.shape[1]
            mean = s / n
            var = torch.clamp_min(ss / n - mean * mean, 0.0)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        out = (upcast32(y) - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
        return (out + self.bias.view(1, -1, 1, 1)).to(y.dtype)


def channel_pad(x, before, after):
    """Zero-padding along the channel axis of an NCHW tensor."""
    return F.pad(x, (0, 0, 0, 0, int(before), int(after)))


def avg_pool(x, window, stride=None):
    """VALID average pooling (the only form the CIFAR ResNets use)."""
    return F.avg_pool2d(x, window, stride or window)


def max_pool(x, window, stride=None):
    """VALID max pooling."""
    return F.max_pool2d(x, window, stride or window)


def global_avg_pool(x):
    return torch.mean(x, dim=(2, 3))


def global_max_pool(x):
    return torch.amax(x, dim=(2, 3))
