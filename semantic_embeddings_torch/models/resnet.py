"""ImageNet-scale ResNet family (v1 bottleneck and basic blocks).

Counterpart of the JAX package's ``models/resnet.py``: the reference's
``resnet-50/101/152`` and ``rn18/34/50/101/152/200`` as one module: a
ZeroPad(3) + VALID 7x7/2 stem conv, ZeroPad(1) + VALID 3x3/2 max-pool, four
stages of bottleneck (depth >= 50) or basic blocks, global average pooling
and a top Dense named ``top`` (linear, or softmax for classification);
``remat`` recomputes each block's activations in the backward pass, which
runs its ``conv_b`` through the fused op a second time.  Convs are bias-free (each feeds a
BatchNorm) and he-normal initialized.  Module names follow the Flax tree
(``conv0``, ``bn0``, ``stage{s}_block{b}``, ``conv_a``, ``bn_sc``, ...) so
that :mod:`..convert` maps one onto the other by name.

Every block's ``conv_b`` is a 3x3 SAME stride-1 conv that feeds ``bn_b``
directly (a bottleneck's stride sits on its 1x1 ``conv_a``), so the pair
runs through :func:`..ops.conv3x3.conv3x3_bn_stats`: one kernel computes
the conv and the batch statistics ``bn_b`` needs, and the filter gradient
is the second kernel.  A block's ``conv_bn_stats`` names the op it calls;
:func:`use_plain_conv_bn_stats` points it at the plain versions, for the
reference a run through the kernels is held against.

The 1x1 convs (a bottleneck's ``conv_a`` and ``conv_c``, every projection
shortcut ``conv_sc``) run through :func:`..ops.conv1x1.conv1x1`, named by a
block's ``conv_1x1``: in f32 training on the card their weight gradient is
that op's kernel, anywhere else the conv's own call;
:func:`use_plain_conv_bn_stats` points it at its plain version too.

Not ported: the JAX module's ``SpaceToDepthStem`` and ``Conv1x1AsDot``
(TPU matrix-unit levers that ``build_network`` never selects).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv1x1 import conv1x1, plain_conv1x1
from ..ops.conv3x3 import conv3x3_bn_stats, plain_conv3x3_bn_stats
from ..parallel import spatial
from .layers import (
    KerasBatchNorm,
    conv,
    dense,
    global_avg_pool,
    max_pool,
    pad,
    rematerialized,
    top_output,
)

STAGE_BLOCKS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
    200: (3, 24, 36, 3),
}


def _conv(in_features, features, kernel, stride, generator, **kwargs):
    return conv(in_features, features, kernel, stride, use_bias=False,
                generator=generator, kernel_init="he_normal", **kwargs)


class _Block(nn.Module):
    """What the two block kinds share: ``conv_b`` + ``bn_b`` through the
    fused op, and the optional 1x1 projection shortcut; the 1x1 convs run
    through ``conv_1x1``."""

    def __init__(self, in_features, out_features, stride, project, bn_epsilon,
                 generator):
        super().__init__()
        self.conv_bn_stats = conv3x3_bn_stats
        self.conv_1x1 = conv1x1
        if project:
            self.conv_sc = _conv(in_features, out_features, 1, stride, generator)
            self.bn_sc = KerasBatchNorm(out_features, epsilon=bn_epsilon)
        self.project = project

    def conv_bn_b(self, y):
        if spatial.active():
            return self.bn_b.forward_from_stats(*self._rows_conv_bn_b(y))
        return self.bn_b.forward_from_stats(
            *self.conv_bn_stats(y, self.conv_b.weight))

    def _rows_conv_bn_b(self, y):
        """``conv_b`` of a row block under a spatial grid: the op takes the
        rows above and below the block as its halo rows (zero rows at the
        image's edge), and its sums are the block's.  An empty block runs
        the plain conv on zero rows and keeps none of its output.  Both
        ways every fetched row stays in the graph, so that the fetch's
        backward, a collective, runs on every rank."""
        h = spatial.global_height(y)
        top, mid, bottom, _ = spatial.halo(y, h, spatial.conv_needs(h, 3, 1, 1))
        if mid.shape[2] == 0:
            x = torch.cat([top, mid, bottom], dim=2)
            z = F.conv2d(F.pad(x, (1, 1, 0, 3 - x.shape[2])),
                         self.conv_b.weight.to(y.dtype))[:, :, :0]
            zf = z.to(torch.promote_types(z.dtype, torch.float32))
            return z, zf.sum(dim=(0, 2, 3)), (zf * zf).sum(dim=(0, 2, 3))
        return self.conv_bn_stats(mid, self.conv_b.weight, top, bottom)

    def shortcut(self, x):
        return self.bn_sc(self.conv_1x1(self.conv_sc, x)) if self.project else x


class BottleneckBlock(_Block):
    """1x1 (strided) -> 3x3 -> 1x1 (x4 features), each followed by BN."""

    def __init__(self, in_features, features, stride=1, project=False,
                 bn_epsilon=1e-3, generator=None):
        super().__init__(in_features, features * 4, stride, project, bn_epsilon,
                         generator)
        self.conv_a = _conv(in_features, features, 1, stride, generator)
        self.bn_a = KerasBatchNorm(features, epsilon=bn_epsilon)
        self.conv_b = _conv(features, features, 3, 1, generator)
        self.bn_b = KerasBatchNorm(features, epsilon=bn_epsilon)
        self.conv_c = _conv(features, features * 4, 1, 1, generator)
        self.bn_c = KerasBatchNorm(features * 4, epsilon=bn_epsilon)

    def forward(self, x):
        y = torch.relu(self.bn_a(self.conv_1x1(self.conv_a, x)))
        y = torch.relu(self.conv_bn_b(y))
        y = self.bn_c(self.conv_1x1(self.conv_c, y))
        return torch.relu(y + self.shortcut(x))


class BasicBlock(_Block):
    """3x3 (strided) -> 3x3, each followed by BN; only the stride-1 ``conv_b``
    goes through the fused op."""

    def __init__(self, in_features, features, stride=1, project=False,
                 bn_epsilon=1e-3, generator=None):
        super().__init__(in_features, features, stride, project, bn_epsilon,
                         generator)
        self.conv_a = _conv(in_features, features, 3, stride, generator)
        self.bn_a = KerasBatchNorm(features, epsilon=bn_epsilon)
        self.conv_b = _conv(features, features, 3, 1, generator)
        self.bn_b = KerasBatchNorm(features, epsilon=bn_epsilon)

    def forward(self, x):
        y = torch.relu(self.bn_a(self.conv_a(x)))
        y = self.conv_bn_b(y)
        return torch.relu(y + self.shortcut(x))


class ResNet(nn.Module):
    """Takes NHWC images; returns (B, classes) with a top, else the pooled
    features.  ``bn_epsilon`` differs per reference constructor (see
    ``build_network``)."""

    def __init__(self, depth=50, classes=1000, include_top=True, top_activation=None,
                 remat=False, bn_epsilon=1e-3, input_channels=3, generator=None):
        super().__init__()
        bottleneck = depth >= 50
        block_cls = BottleneckBlock if bottleneck else BasicBlock
        self.include_top = include_top
        self.top_activation = top_activation
        self.remat = remat
        self.conv0 = _conv(input_channels, 64, 7, 2, generator, padding="VALID")
        self.bn0 = KerasBatchNorm(64, epsilon=bn_epsilon)
        self.blocks = []
        in_f = 64
        for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
            features = 64 * 2**stage
            for b in range(n_blocks):
                name = f"stage{stage + 1}_block{b + 1}"
                self.add_module(name, block_cls(
                    in_f, features, stride=2 if (b == 0 and stage > 0) else 1,
                    project=b == 0, bn_epsilon=bn_epsilon, generator=generator))
                self.blocks.append(name)
                in_f = features * 4 if bottleneck else features
        self.out_features = classes if include_top else in_f
        if include_top:
            self.top = dense(in_f, classes, generator)

    def forward(self, x, taps=None):
        """``taps``: a dict that, when given, also receives the pooled
        features as ``avg_pool`` and the top's output as ``embedding`` (or
        ``prob`` under a softmax top; the JAX module's ``sow`` names)."""
        x = x.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        # Keras-2.2 stem (keras_applications resnet50): ZeroPadding2D(3) +
        # VALID 7x7/2 conv, then ZeroPadding2D(1) + VALID 3x3/2 max-pool.
        # Zero padding before the max-pool is exact: its input is post-relu.
        x = self.conv0(pad(x, (3, 3, 3, 3)))
        x = torch.relu(self.bn0(x))
        x = max_pool(pad(x, (1, 1, 1, 1)), 3, 2)
        for name in self.blocks:
            block = getattr(self, name)
            x = rematerialized(block, x) if self.remat else block(x)
        x = global_avg_pool(x)
        if taps is not None:
            taps["avg_pool"] = x
        if self.include_top:
            x = top_output(self.top(x), self.top_activation, taps)
        return x


def use_plain_conv_bn_stats(model):
    """Points every block of ``model`` at the plain versions of the fused
    conv + statistics op and its filter gradient, and of the 1x1 convs'
    weight gradient; returns ``model``."""
    for module in model.modules():
        if isinstance(module, _Block):
            module.conv_bn_stats = plain_conv3x3_bn_stats
            module.conv_1x1 = plain_conv1x1
    return model
