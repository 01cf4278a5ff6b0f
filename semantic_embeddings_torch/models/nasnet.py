"""NASNet-A (Zoph et al., CVPR 2018), the "large" ImageNet configuration
(``nasnet-a``: N = 6, 4032 penultimate filters, about 89M parameters).

Counterpart of the JAX package's ``models/nasnet.py``, with its Keras
wiring: a VALID 3x3/2 stem conv, two stem reduction cells, three stages of N
normal cells with a reduction cell between stages, where the first normal
cell after a reduction takes its p input from two normal cells back
(``skip_reduction``: p does not advance through the reduction); separable
units of (relu -> depthwise -> pointwise -> BN) x 2 with the stride in the
first depthwise only; BatchNorm momentum 0.9997, epsilon 1e-3; convs
lecun-normal (Flax's default) and bias-free.

The pools follow Keras exactly.  A reduction cell pads its squeezed input
with zeros by the TF SAME amounts and pools that VALID: the 3x3/2 max pool
sees zeros at the border (not -inf), and the 3x3/2 average divides by the
whole window.  The 3x3/1 average pools inside the cells are SAME pools that
divide by the cells inside the image (``count_include_pad=False``).

Flax decides at trace time whether a cell adjusts its p input (a
factorized reduce where p is larger than h, a 1x1 squeeze where only the
channels differ); here the modules exist from construction, so the same
rule runs on the channel counts and on the reductions so far, and the
forward checks that the input's sizes agree with it (inputs of 32 px or
more: every reduction halves the map).  Module names are the Flax names
(``stem_conv``, ``cell_{id}``, ``adjust/factorize``, ``left1/dw0``, ...).

The forward opens the spans ``nasnet.stem``, ``nasnet.normal_cell`` and
``nasnet.reduction_cell`` (:mod:`..spans`: recorded only inside a profiler
session) around the stem and each cell, and ``depthwise_convs`` counts the
depthwise convs it runs (220 a forward of the large model).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import spans
from .layers import (
    KerasBatchNorm,
    avg_pool,
    conv,
    dense,
    global_avg_pool,
    max_pool,
    pad,
    top_output,
    zero_pad_same,
)


#: depthwise convs the forwards ran since the process started (or since a
#: caller reset it)
depthwise_convs = 0


def _bn(features):
    return KerasBatchNorm(features, momentum=0.9997, epsilon=1e-3)


def _conv(cin, cout, kernel=1, stride=1, generator=None, groups=1, padding="SAME"):
    return conv(cin, cout, kernel, stride, False, generator, padding=padding,
                kernel_init="lecun_normal", groups=groups)


class SepConvBlock(nn.Module):
    """(relu -> depthwise k x k -> pointwise 1x1 -> BN) x 2, the stride in
    the first depthwise (Keras's ``_separable_conv_block``)."""

    def __init__(self, in_features, features, kernel=3, stride=1, generator=None):
        super().__init__()
        self.dw0 = _conv(in_features, in_features, kernel, stride, generator,
                         groups=in_features)
        self.pw0 = _conv(in_features, features, generator=generator)
        self.bn0 = _bn(features)
        self.dw1 = _conv(features, features, kernel, 1, generator, groups=features)
        self.pw1 = _conv(features, features, generator=generator)
        self.bn1 = _bn(features)

    def forward(self, x):
        global depthwise_convs
        depthwise_convs += 2
        x = self.bn0(self.pw0(self.dw0(torch.relu(x))))
        return self.bn1(self.pw1(self.dw1(torch.relu(x))))


class _Squeeze(nn.Module):
    """relu -> 1x1 conv -> BN: the projection to the cell's filters."""

    def __init__(self, in_features, features, generator=None):
        super().__init__()
        self.conv = _conv(in_features, features, generator=generator)
        self.bn = _bn(features)

    def forward(self, x):
        return self.bn(self.conv(torch.relu(x)))


class _FactorizedReduce(nn.Module):
    """Halves a skip input by two stride-2 1x1 convs, the second on the
    input shifted by one pixel (Keras's ZeroPadding2D((0, 1), (0, 1)) +
    Cropping2D((1, 0), (1, 0)): pad bottom and right, drop the first row
    and column), concatenated and normalized."""

    def __init__(self, in_features, features, generator=None):
        super().__init__()
        self.conv_1 = _conv(in_features, features // 2, 1, 2, generator)
        self.conv_2 = _conv(in_features, features - features // 2, 1, 2, generator)
        self.bn = _bn(features)

    def forward(self, x):
        x = torch.relu(x)
        shifted = pad(x, (-1, 1, -1, 1))  # one pixel up and left, zeros in
        return self.bn(torch.cat([self.conv_1(x), self.conv_2(shifted)], dim=1))


class _Adjust(nn.Module):
    """Brings the previous cell's output to the cell's shape: a factorized
    reduce (``factorize``) or a 1x1 squeeze (``squeeze``)."""

    def __init__(self, in_features, features, reduce_spatial, generator=None):
        super().__init__()
        self.reduce_spatial = reduce_spatial
        if reduce_spatial:
            self.factorize = _FactorizedReduce(in_features, features, generator)
        else:
            self.squeeze = _Squeeze(in_features, features, generator)

    def forward(self, p):
        return self.factorize(p) if self.reduce_spatial else self.squeeze(p)


def _adjust_rule(p, h, features):
    """Flax's choice for a cell's p input, from (channels, reductions so far)
    of p and h: "factorize", "squeeze", None (p as it is) or "absent"."""
    if p is None:
        return "absent"
    if p[1] != h[1]:
        return "factorize"
    return "squeeze" if p[0] != features else None


class _Cell(nn.Module):
    """What both cells share: the p adjustment and the 1x1 squeeze of h."""

    def __init__(self, p, h, features, generator):
        super().__init__()
        self.rule = _adjust_rule(p, h, features)
        if self.rule in ("factorize", "squeeze"):
            self.adjust = _Adjust(p[0], features, self.rule == "factorize", generator)
        self.conv_1 = _Squeeze(h[0], features, generator)

    def _inputs(self, h_prev, h):
        """(p, squeezed h), as the JAX cell forms them."""
        # by width: under a spatial grid a rank holds a block of the rows
        got = (h_prev is not None) and (h_prev.shape[3] != h.shape[3])
        if (self.rule == "factorize") != got:
            raise ValueError(
                f"NASNet cell built for {'a' if self.rule == 'factorize' else 'no'} "
                f"spatial reduction of p, given p {None if h_prev is None else tuple(h_prev.shape)} "
                f"and h {tuple(h.shape)}: the input is too small for this model")
        p = self.adjust(h_prev) if hasattr(self, "adjust") else h_prev
        return p, self.conv_1(h)


class NormalCell(_Cell):
    """NASNet-A normal cell (Keras's ``_normal_a_cell`` wiring and concat
    order); 6 x features out."""

    def __init__(self, p, h, features, generator=None):
        super().__init__(p, h, features, generator)
        f = features
        for name, k in (("left1", 5), ("right1", 3), ("left2", 5), ("right2", 3),
                        ("left5", 3)):
            self.add_module(name, SepConvBlock(f, f, k, 1, generator))
        self.out = (6 * f, h[1])

    def forward(self, h_prev, h):
        p, h = self._inputs(h_prev, h)
        if p is None:
            p = h
        x1 = self.left1(h) + self.right1(p)
        x2 = self.left2(p) + self.right2(p)
        x3 = avg_pool(h, 3, 1, padding="SAME", count_include_pad=False) + p
        x4 = avg_pool(p, 3, 1, padding="SAME", count_include_pad=False) * 2.0
        x5 = self.left5(h) + h
        return torch.cat([p, x1, x2, x3, x4, x5], dim=1)


class ReductionCell(_Cell):
    """NASNet-A reduction cell (Keras's ``_reduction_a_cell`` wiring and
    concat order), stride 2; 4 x features out.  Without a previous cell,
    p is the raw (unsqueezed) h, as in Keras's ``_adjust_block``."""

    def __init__(self, p, h, features, generator=None):
        super().__init__(p, h, features, generator)
        f = features
        p_features = h[0] if self.rule == "absent" else (p[0] if self.rule is None else f)
        self.left1 = SepConvBlock(f, f, 5, 2, generator)
        self.right1 = SepConvBlock(p_features, f, 7, 2, generator)
        self.right2 = SepConvBlock(p_features, f, 7, 2, generator)
        self.right3 = SepConvBlock(p_features, f, 5, 2, generator)
        # Keras's quirk: this one's block id is 'reduction_left4' too
        self.left4 = SepConvBlock(f, f, 3, 1, generator)
        self.out = (4 * f, h[1] + 1)

    def forward(self, h_prev, h):
        raw = h
        p, h = self._inputs(h_prev, h)
        if p is None:
            p = raw
        h3 = zero_pad_same(h, 3, 2)
        x1 = self.left1(h) + self.right1(p)
        x2 = max_pool(h3, 3, 2) + self.right2(p)
        x3 = avg_pool(h3, 3, 2) + self.right3(p)
        x4 = avg_pool(x1, 3, 1, padding="SAME", count_include_pad=False) + x2
        x5 = self.left4(x1) + max_pool(h3, 3, 2)
        return torch.cat([x2, x3, x4, x5], dim=1)


class NASNetA(nn.Module):
    """Takes NHWC images; returns (B, classes) with a top, else the pooled
    features.  Cells are named ``cell_{id}`` after Keras's block ids
    (``stem_1``, ``stem_2``, ``0`` .. ``N-1``, ``reduce_N``, ``N+1`` ..
    ``2N``, ``reduce_2N``, ``2N+1`` .. ``3N``)."""

    def __init__(self, classes=1000, num_normal_cells=6, penultimate_filters=4032,
                 stem_filters=96, include_top=True, top_activation=None,
                 input_channels=3, generator=None):
        super().__init__()
        self.include_top = include_top
        self.top_activation = top_activation
        filters = penultimate_filters // 24
        n = num_normal_cells
        self.stem_conv = _conv(input_channels, stem_filters, 3, 2, generator,
                               padding="VALID")
        self.stem_bn = _bn(stem_filters)
        # (channels, reductions so far) of the cells' p and h inputs; the
        # forward replays the same order: (name, advances p)
        self.cells = []
        p, cur = None, (stem_filters, 0)

        def add(name, cls, features, advance):
            nonlocal p, cur
            cell = cls(p, cur, features, generator)
            self.add_module(name, cell)
            self.cells.append((name, advance))
            p, cur = (cur, cell.out) if advance else (p, cell.out)

        add("cell_stem_1", ReductionCell, filters // 4, True)
        add("cell_stem_2", ReductionCell, filters // 2, True)
        for stage in range(3):
            stage_filters = filters * 2**stage
            if stage > 0:
                add(f"cell_reduce_{stage * n}", ReductionCell, stage_filters, False)
            for i in range(n):
                cell_id = stage * n + i + (1 if stage > 0 else 0)
                add(f"cell_{cell_id}", NormalCell, stage_filters, True)
        self.out_features = classes if include_top else cur[0]
        if include_top:
            self.top = dense(cur[0], classes, generator)

    def forward(self, x, taps=None):
        """``taps``: a dict that, when given, also receives the pooled
        features as ``avg_pool`` and the top's output as ``embedding`` (or
        ``prob`` under a softmax top)."""
        with spans.span("nasnet.stem"):
            x = self.stem_conv(x.permute(0, 3, 1, 2).contiguous())  # NHWC -> NCHW
            p, cur = None, self.stem_bn(x)
        for name, advance in self.cells:
            cell = getattr(self, name)
            kind = "reduction" if isinstance(cell, ReductionCell) else "normal"
            with spans.span(f"nasnet.{kind}_cell"):
                out = cell(p, cur)
            p, cur = (cur, out) if advance else (p, out)
        x = global_avg_pool(torch.relu(cur))
        if taps is not None:
            taps["avg_pool"] = x
        if self.include_top:
            x = top_output(self.top(x), self.top_activation, taps)
        return x
