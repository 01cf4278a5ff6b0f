"""Shared building blocks for the model zoo (counterpart of the JAX package's
``models/layers.py``).

Keras-semantic defaults are kept where they affect training parity:
glorot-uniform kernel init with zero biases (the JAX package's other
initializers where it asks for them), BatchNorm momentum 0.99 / epsilon 1e-3
with a biased running variance, TF "SAME" padding.  The public model
functions take NHWC images; inside, the layers work in NCHW.

Under a spatial grid (``--spatial``, :mod:`..parallel.spatial`) every map is
a block of its rows, and the primitives here are what make that work: the
convs, pools, pads and upsamplings fetch the rows their output block reads
from the ranks that hold them, TF SAME padding is split by the map's global
height, the global pools and BatchNorm's sums cross the spatial group, and
a flatten gathers the whole map.  A model that touches rows only through
them runs unchanged.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import parallel
from ..parallel import spatial


def upcast32(x):
    """Upcast-only stability cast: bf16/f16 -> f32, f32 -> f32, f64 -> f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _glorot_uniform_(weight, generator):
    # torch's fan computation for conv (in*kh*kw, out*kh*kw) and linear
    # weights equals Keras's, so xavier_uniform_ is glorot_uniform.
    nn.init.xavier_uniform_(weight, generator=generator)


def _truncated_normal_(weight, generator, scale, mode):
    # Flax's variance_scaling(scale, mode, "truncated_normal"): a normal of
    # variance scale / fan truncated at two standard deviations, its scale
    # corrected for the truncation (the constant is the std of a unit
    # normal truncated to [-2, 2]).  torch's fans of a conv weight (O, I/g,
    # H, W) are Flax's of its kernel (H, W, I/g, O), depthwise ones too.
    fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(weight)
    fan = fan_in if mode == "fan_in" else (fan_in + fan_out) / 2
    std = math.sqrt(scale / fan) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def _he_normal_(weight, generator):
    _truncated_normal_(weight, generator, 2.0, "fan_in")


def _glorot_normal_(weight, generator):
    _truncated_normal_(weight, generator, 1.0, "fan_avg")


def _lecun_normal_(weight, generator):
    # Flax's default kernel init (``nn.Conv``, ``nn.ConvTranspose``)
    _truncated_normal_(weight, generator, 1.0, "fan_in")


def keras_uniform_(tensor, generator):
    """Keras's 'uniform' initializer: U(-0.05, 0.05)."""
    nn.init.uniform_(tensor, -0.05, 0.05, generator=generator)


KERNEL_INITS = {"glorot_uniform": _glorot_uniform_, "he_normal": _he_normal_,
                "glorot_normal": _glorot_normal_, "lecun_normal": _lecun_normal_}


def activation_fn(name):
    """The activation named ``name`` (``relu``, ``selu``, or None for the
    identity)."""
    return {"relu": torch.relu, "selu": torch.selu, None: lambda x: x}[name]


def _same_padding(size, kernel, stride):
    """TF SAME padding (before, after) along one axis."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _height(x):
    """The height of the map whose rows ``x`` holds: its global height under
    a spatial grid (``x`` a block of its rows), else its own."""
    return spatial.global_height(x) if spatial.active() else x.shape[2]


def _same_pads(x, window, stride):
    """TF SAME (left, right, top, bottom) padding of an NCHW ``x`` (of the
    whole map under a spatial grid), in ``F.pad``'s order."""
    return _same_padding(x.shape[3], window, stride) + _same_padding(_height(x), window, stride)


def _window_rows(x, k, stride, top, h_out, fn, fill=0.0):
    """Under a spatial grid: ``fn(rows, lo)`` over the rows of x's map that
    this column's output block reads (``top`` rows of padding on, ``fill``
    outside the image, the first of them ``lo``), VALID in H with the stride
    and ``k`` rows a window; the output a block of ``h_out`` rows."""
    h = spatial.global_height(x)
    x_ext, lo = spatial.rows(x, h, spatial.conv_needs(h_out, k, stride, top), fill)
    n_out = spatial.out_rows(h_out)
    return spatial.record(spatial.valid_rows(lambda z: fn(z, lo), x_ext, n_out, k), h_out)


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` with TF "SAME" padding, computed per call, or none
    (``padding="VALID"``).

    TF SAME puts the odd pixel of padding after, not before: a stride-2 3x3
    conv on an even input pads (0, 1), where ``padding=1`` would pad (1, 1)
    and shift every downsampling stage by one pixel.  ``groups`` as in
    ``nn.Conv2d`` (Flax's ``feature_group_count``; depthwise when it equals
    the input features).
    """

    def __init__(self, in_features, features, kernel, stride=1, use_bias=True,
                 generator=None, padding="SAME", kernel_init="glorot_uniform",
                 groups=1):
        super().__init__(in_features, features, kernel, stride=stride,
                         padding=0, bias=use_bias, groups=groups)
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, not {padding!r}")
        self.same = padding == "SAME"
        KERNEL_INITS[kernel_init](self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        k, s, g = self.kernel_size[0], self.stride[0], self.groups
        if spatial.active():
            return self._rows_forward(x)
        if not self.same:
            return F.conv2d(x, self.weight, self.bias, s, groups=g)
        left, right, top, bottom = pads = _same_pads(x, k, s)
        if left == right and top == bottom:
            return F.conv2d(x, self.weight, self.bias, s, (top, left), groups=g)
        return F.conv2d(F.pad(x, pads), self.weight, self.bias, s, groups=g)

    def _rows_forward(self, x):
        """The conv of a row block under a spatial grid: VALID in H over the
        rows its output block reads, SAME (or VALID) in W."""
        k, s, g = self.kernel_size[0], self.stride[0], self.groups
        h = spatial.global_height(x)
        if self.same:
            left, right, top, _ = _same_pads(x, k, s)
            h_out = -(-h // s)
        else:
            left = right = top = 0
            h_out = (h - k) // s + 1

        def fn(z, lo):
            if left == right:
                return F.conv2d(z, self.weight, self.bias, s, (0, left), groups=g)
            return F.conv2d(F.pad(z, (left, right)), self.weight, self.bias, s, groups=g)

        return _window_rows(x, k, s, top, h_out, fn)


def conv(in_features, features, kernel=3, stride=1, use_bias=True,
         generator=None, padding="SAME", kernel_init="glorot_uniform", groups=1):
    """3x3-style SAME conv with Keras-like defaults."""
    return Conv2dSame(in_features, features, kernel, stride, use_bias, generator,
                      padding, kernel_init, groups)


class ConvTranspose2dSame(nn.ConvTranspose2d):
    """Flax's ``nn.ConvTranspose`` (``transpose_kernel=False``) with SAME
    padding.

    Flax dilates the input by the stride and correlates it with its kernel
    (H, W, I, O) as it is, padded by ``lax``'s transposed-SAME amounts
    (3x3, stride 2: 2 before, 1 after; output = stride * input).
    ``F.conv_transpose2d`` correlates with the kernel flipped in H and W and
    pads k - 1 - padding on both sides (plus ``output_padding`` after).  So
    the weight here, (I, O, H, W), is Flax's kernel flipped in H and W
    (:mod:`..convert` maps it), the padding is k - 1 - Flax's "before", and
    Flax's "after" is reached by cropping (or by ``output_padding``).
    The kernel is drawn as Flax draws it (lecun-normal over fan-in I*H*W).
    """

    def __init__(self, in_features, features, kernel, stride, use_bias=True,
                 generator=None):
        super().__init__(in_features, features, kernel, stride=stride, bias=use_bias)
        pad_len = kernel + stride - 2
        before = kernel - 1 if stride > kernel - 1 else math.ceil(pad_len / 2)
        self.pad_before, self.pad_after = before, pad_len - before
        with torch.no_grad():
            w = torch.empty(features, in_features, kernel, kernel)
            _lecun_normal_(w, generator)
            self.weight.copy_(w.transpose(0, 1))
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        extra = self.pad_after - self.pad_before  # -1 .. s - 1
        if spatial.active():
            return self._rows_forward(x, k, s, extra)
        y = F.conv_transpose2d(x, self.weight, self.bias, s, k - 1 - self.pad_before,
                               max(extra, 0))
        return y[:, :, :y.shape[2] + extra, :y.shape[3] + extra] if extra < 0 else y

    def _rows_forward(self, x, k, s, extra):
        """Under a spatial grid: the input rows that add to this column's
        output block (zeros outside the image), transposed with no H
        padding, and the block's rows cut out of the result."""
        pad = k - 1 - self.pad_before
        h = spatial.global_height(x)
        h_out = (h - 1) * s - 2 * pad + k + extra
        x_ext, lo = spatial.rows(x, h, spatial.transpose_needs(h_out, k, s, pad))
        a, b = spatial.block(h_out)
        if a == b:  # an empty block: one input row through, none of it kept
            x_ext, lo, b = F.pad(x_ext, (0, 0, 0, 1 - x_ext.shape[2])), (a + pad) // s, a
        y = F.conv_transpose2d(x_ext, self.weight, self.bias, s, (0, pad), (0, max(extra, 0)))
        first = a + pad - lo * s  # y's row 0 is output row lo * s - pad
        y = y[:, :, first:first + b - a]
        return spatial.record(y[:, :, :, :y.shape[3] + extra] if extra < 0 else y, h_out)


def dense(in_features, features, generator=None):
    """Linear layer with glorot-uniform kernel and zero bias (Keras)."""
    layer = nn.Linear(in_features, features)
    _glorot_uniform_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputing():
    """Marks the forward run inside as a recompute (of a rematerialized
    block, in the backward pass): every :class:`KerasBatchNorm` in training
    mode normalizes with the batch statistics as before but leaves its
    running statistics where the first forward moved them, so that they
    move once a step.  Per thread: the autograd engine may recompute on a
    thread of its own."""
    before = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = before


def _recomputing():
    return getattr(_RECOMPUTE, "on", False)


def _remat_contexts():
    return contextlib.nullcontext(), recomputing()


def rematerialized(block, x):
    """``block(x)`` with its activations dropped after the forward and
    recomputed in the backward (``torch.utils.checkpoint``, non-reentrant),
    the recompute under :func:`recomputing`: the JAX package's
    ``nn.remat``.  Without autograd it is just ``block(x)``."""
    if not torch.is_grad_enabled():
        return block(x)
    return checkpoint(block, x, use_reentrant=False, context_fn=_remat_contexts)


#: BatchNorm statistics groups a :class:`KerasBatchNorm` that pins none
#: takes: 1 is global-batch (sync) BN, the default; ``--bn_per_replica``
#: sets the data-parallel degree (:func:`set_default_bn_groups`), the
#: reference's per-tower BN.  Read at every forward.
DEFAULT_BN_GROUPS = 1


def set_default_bn_groups(groups: int):
    global DEFAULT_BN_GROUPS
    DEFAULT_BN_GROUPS = max(1, int(groups))


def _channels_view(v, ndim):
    """A per-channel (C,) vector shaped to broadcast over (N, C, ...)."""
    return v.view((1, -1) + (1,) * (ndim - 2))


class KerasBatchNorm(nn.Module):
    """BatchNorm with Keras defaults (momentum 0.99, eps 1e-3) and Flax's
    running-statistics update.

    One process, one group: normalization runs through ``F.batch_norm``
    (cuDNN on the card) over the channel axis 1 of a (N, C, ...) input.
    ``F.batch_norm`` would move the running variance towards the *unbiased*
    batch variance; Flax (and Keras) move it towards the biased one, so the
    update is corrected right after.  ``scale_init(weight, generator)``
    draws the scale (ones by default; the WRN's BNs draw
    :func:`keras_uniform_`).  Under :func:`recomputing` the running
    statistics stay as they are.

    In a process group of more than one rank the statistics are the global
    batch's (sync BN): the local f32 sums of x and x**2 cross the group
    through :func:`..parallel.all_reduce_sum` and
    :meth:`forward_from_stats` normalizes with the global count, as Flax's
    ``nn.BatchNorm`` forms them.  ``groups`` (or :data:`DEFAULT_BN_GROUPS`)
    above 1 gives each of that many batch groups its own statistics
    (:class:`_GroupedBatchNorm`'s arithmetic); over D data shards each
    holds ``groups / D`` of them.  Under a spatial grid the sums of a row
    block cross every rank too (each pixel is on one rank), and a group's
    statistics cross its data shard's spatial columns, which jointly hold
    its images.
    """

    def __init__(self, features, momentum=0.99, epsilon=1e-3, scale_init=None,
                 generator=None, groups=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(features))
        if scale_init is not None:
            with torch.no_grad():
                scale_init(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _groups(self):
        return self.groups if self.groups is not None else DEFAULT_BN_GROUPS

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.epsilon)
        groups, world = self._groups(), parallel.world_size()
        if groups > 1:
            return self._grouped(x, groups)
        if world > 1:
            xf = upcast32(x)
            dims = [0] + list(range(2, x.ndim))
            return self.forward_from_stats(x, xf.sum(dims), (xf * xf).sum(dims))
        m = self.momentum
        if _recomputing():
            # the same call as the first forward's (so autograd saves the
            # same tensors), on copies of the statistics that are dropped
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, 1.0 - m, self.epsilon)
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
        """BatchNorm of (N, C, ...) ``y`` whose per-channel f32 sums ``s`` =
        sum(y) and ``ss`` = sum(y**2) over every axis but 1 are given (by
        the fused conv of :mod:`..ops.conv3x3`).

        Training uses the batch statistics as Flax's ``nn.BatchNorm`` forms
        them (``use_fast_variance``): mean = s / n and var = max(0, ss / n -
        mean**2), with n = N*H*W; the running statistics move towards that
        mean and that biased var.  In a group of W > 1 ranks, s and ss are
        first summed over the group and n is the global count (sync BN): W
        times the local count, or under a spatial grid the data shards'
        images times the whole map's pixels; with BN groups above 1 each
        group takes its own statistics.
        Evaluation uses the running statistics and leaves ``s`` and ``ss``
        unused.  The normalization runs in f32 (f64 for f64 y) and the
        result is cast back to y's dtype, as Flax's ``BatchNorm(dtype=bf16)``
        does.
        """
        if self.training:
            groups, world = self._groups(), parallel.world_size()
            if groups > 1:
                return self._grouped(y, groups, sums=(s, ss))
            n = y.numel() // y.shape[1]
            if world > 1:
                s, ss = parallel.all_reduce_sum(torch.stack([s, ss])).unbind(0)
                n = _global_count(y)
            mean = s / n
            var = torch.clamp_min(ss / n - mean * mean, 0.0)
            m = self.momentum
            if not _recomputing():
                with torch.no_grad():
                    self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                    self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        out = (upcast32(y) - _channels_view(mean, y.ndim)) * _channels_view(mul, y.ndim)
        return (out + _channels_view(self.bias, y.ndim)).to(y.dtype)

    def _grouped(self, x, groups, sums=None):
        """Training BatchNorm with per-group statistics, the JAX package's
        ``_GroupedBatchNorm``: the local batch splits into ``groups / D``
        groups of consecutive rows (D data shards), each normalized by its
        own mean and (two-pass, biased) variance; a single local group takes
        them from ``sums`` where they are given.  Under a spatial grid a
        row block's sums cross its spatial group, whose columns hold the
        group's images.  The running statistics move by the whole global
        batch's moments: the mean of the group means, and by the law of
        total variance the mean of the group variances plus the variance of
        the group means, from one sum over the data shards of the group
        means, their squares and the group variances."""
        shards = parallel.data_size()
        if groups % shards:
            raise ValueError(f"{groups} BatchNorm groups do not divide over {shards} ranks")
        g = groups // shards
        if x.shape[0] % g:
            raise ValueError(f"batch {x.shape[0]} not divisible by bn groups {g}")
        xg = upcast32(x).reshape((g, x.shape[0] // g) + tuple(x.shape[1:]))
        red = [1] + list(range(3, xg.ndim))  # each group's rows and pixels
        bshape = (g, 1, -1) + (1,) * (x.ndim - 2)
        if spatial.active() and x.ndim == 4:  # a row block of each image
            group = spatial.current_grid().spatial_group
            n = x.shape[0] // g * spatial.global_height(x) * x.shape[3]
            if sums is not None and g == 1:
                s, ss = parallel.all_reduce_sum(torch.stack(sums), group=group).unbind(0)
                gmean = (s / n)[None]
                gvar = torch.clamp_min(ss / n - gmean * gmean, 0.0)
            else:
                gmean = parallel.all_reduce_sum(xg.sum(red), group=group) / n
                gvar = parallel.all_reduce_sum(
                    ((xg - gmean.view(bshape)) ** 2).sum(red), group=group) / n
        elif sums is not None and g == 1:
            n = x.numel() // x.shape[1]
            gmean = (sums[0] / n)[None]
            gvar = torch.clamp_min(sums[1] / n - gmean * gmean, 0.0)
        else:
            gmean = xg.mean(red)  # (g, C)
            gvar = ((xg - gmean.view(bshape)) ** 2).mean(red)
        y = (xg - gmean.view(bshape)) / torch.sqrt(gvar.view(bshape) + self.epsilon)
        y = y * self.weight.view(bshape[1:]) + self.bias.view(bshape[1:])
        if not _recomputing():
            with torch.no_grad():
                grid = spatial.current_grid()
                moments = parallel.sum_over_group(torch.stack(
                    [gmean.sum(0), (gmean * gmean).sum(0), gvar.sum(0)]),
                    group=None if grid is None else grid.data_group)
                bmean = moments[0] / groups
                bvar = moments[2] / groups + moments[1] / groups - bmean * bmean
                m = self.momentum
                self.running_mean.mul_(m).add_(bmean, alpha=1.0 - m)
                self.running_var.mul_(m).add_(bvar, alpha=1.0 - m)
        return y.reshape(x.shape).to(x.dtype)


class _GroupedBatchNorm(KerasBatchNorm):
    """A :class:`KerasBatchNorm` that always normalizes by groups, even at
    ``groups=1`` (the JAX package's ``_GroupedBatchNorm``, whose parameter
    and statistics layout is that of a plain BatchNorm)."""

    def __init__(self, features, groups, **kwargs):
        super().__init__(features, groups=groups, **kwargs)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return self._grouped(x, self.groups)


def _global_count(y):
    """Elements of each channel over the whole group: W times the local
    count, or under a spatial grid (y a row block) the data shards' images
    times the whole map's pixels, blocks of any size."""
    if spatial.active() and y.ndim == 4:
        return y.shape[0] * parallel.data_size() * spatial.global_height(y) * y.shape[3]
    return y.numel() // y.shape[1] * parallel.world_size()


def channel_pad(x, before, after):
    """Zero-padding along the channel axis of an NCHW tensor."""
    return F.pad(x, (0, 0, 0, 0, int(before), int(after)))


def avg_pool(x, window, stride=None, padding="VALID", count_include_pad=True):
    """Average pooling as Flax's ``nn.avg_pool``: VALID, or TF SAME, where
    ``count_include_pad=False`` divides each border window by its cells
    inside the image (Keras's SAME AveragePooling2D; NASNet's in-cell 3x3/1
    pools) and ``True`` by the whole window."""
    stride = stride or window
    if spatial.active():
        return _pool_rows(x, window, stride, padding, "avg", count_include_pad)
    if padding == "VALID":
        return F.avg_pool2d(x, window, stride)
    left, right, top, bottom = pads = _same_pads(x, window, stride)
    if left == right and top == bottom:
        return F.avg_pool2d(x, window, stride, (top, left),
                            count_include_pad=count_include_pad)
    total = F.avg_pool2d(F.pad(x, pads), window, stride, divisor_override=1)
    if count_include_pad:
        return total / (window * window)
    ones = F.pad(torch.ones_like(x[:1, :1]), pads)
    return total / F.avg_pool2d(ones, window, stride, divisor_override=1)


def max_pool(x, window, stride=None, padding="VALID"):
    """Max pooling as Flax's ``nn.max_pool``: VALID, or TF SAME (the padding
    never wins: -inf)."""
    stride = stride or window
    if spatial.active():
        return _pool_rows(x, window, stride, padding, "max")
    if padding == "VALID":
        return F.max_pool2d(x, window, stride)
    left, right, top, bottom = pads = _same_pads(x, window, stride)
    if left == right and top == bottom:
        return F.max_pool2d(x, window, stride, (top, left))
    return F.max_pool2d(F.pad(x, pads, value=-math.inf), window, stride)


def _pool_rows(x, window, stride, padding, kind, count_include_pad=True):
    """A pool of a row block under a spatial grid: VALID in H over the rows
    its output block reads (zeros outside the image, -inf for max), W as
    the pool pads it; a SAME average without the padding in its count
    divides by the cells of the whole map inside each window."""
    h = spatial.global_height(x)
    if padding == "VALID":
        left = right = top = 0
        h_out = (h - window) // stride + 1
    else:
        left, right, top, _ = _same_pads(x, window, stride)
        h_out = -(-h // stride)
    fill = -math.inf if kind == "max" else 0.0

    def fn(z, lo):
        width = z.shape[3]
        z = F.pad(z, (left, right), value=fill)
        if kind == "max":
            return F.max_pool2d(z, window, stride)
        total = F.avg_pool2d(z, window, stride, divisor_override=1)
        if padding == "VALID" or count_include_pad:
            return total / (window * window)
        inside = spatial.rows_of_image(lo, lo + z.shape[2], h, z.device).expand(
            1, 1, -1, width)
        count = F.avg_pool2d(F.pad(inside, (left, right)), window, stride, divisor_override=1)
        return total / count.clamp_min(1.0)

    return _window_rows(x, window, stride, top, h_out, fn, fill)


def pad(x, pads, value=0.0):
    """``F.pad(x, pads, value=value)`` of an NCHW map, ``pads`` (left, right,
    top, bottom), a negative amount a crop; under a spatial grid, of the
    whole map whose rows ``x`` holds (the block of the padded map, its rows
    fetched where they lie)."""
    if not spatial.active():
        return F.pad(x, pads, value=value)
    left, right, top, bottom = pads
    h = spatial.global_height(x)
    h_out = h + top + bottom
    x_ext, _ = spatial.rows(x, h, spatial.conv_needs(h_out, 1, 1, top), value)
    return spatial.record(F.pad(x_ext, (left, right), value=value), h_out)


def crop_like(x, ref):
    """``x`` cut to ``ref``'s height and width (from the top left)."""
    return pad(x, (0, ref.shape[3] - x.shape[3], 0, _height(ref) - _height(x)))


def upsample(x, fn, factor=2):
    """``fn(x)``, an upsampling whose output row o reads input row
    ``o // factor`` (nearest neighbours, sub-pixel); under a spatial grid
    of the rows this column's output block reads."""
    if not spatial.active():
        return fn(x)
    h = spatial.global_height(x)
    h_out = h * factor
    x_ext, lo = spatial.rows(x, h, spatial.upsample_needs(h_out, factor))
    a, b = spatial.block(h_out)
    if a == b:  # an empty block: one input row through, none of it kept
        return spatial.record(fn(F.pad(x_ext, (0, 0, 0, 1 - x_ext.shape[2])))[:, :, :0], h_out)
    first = a - lo * factor
    return spatial.record(fn(x_ext)[:, :, first:first + b - a], h_out)


def zero_pad_same(x, window, stride):
    """``x`` zero-padded by the TF SAME amounts of a ``window`` / ``stride``
    pool (Keras's ``ZeroPadding2D(correct_pad)``)."""
    return pad(x, _same_pads(x, window, stride))


def flatten_nhwc(x):
    """(B, C, H, W) -> (B, H*W*C) in the NHWC order a Flax reshape gives, so
    that a dense layer after it takes the JAX package's kernel (under a
    spatial grid, of the whole map, gathered)."""
    if x.ndim == 4 and spatial.active():
        x = spatial.gather_map(x)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1) if x.ndim == 4 else x


def top_output(x, top_activation, taps):
    """The top dense layer's output ``x`` through ``top_activation`` (softmax,
    in f32 or f64, or none), recorded in ``taps`` as ``prob`` or
    ``embedding`` (the JAX models' ``sow`` names)."""
    if top_activation == "softmax":
        x = torch.softmax(upcast32(x), dim=-1)
    if taps is not None:
        taps["prob" if top_activation == "softmax" else "embedding"] = x
    return x


def global_avg_pool(x):
    """The mean over H and W (under a spatial grid of the whole map, in f32,
    the same on every column)."""
    if spatial.active():
        return (spatial.pool_sum(x) / (spatial.global_height(x) * x.shape[3])).to(x.dtype)
    return torch.mean(x, dim=(2, 3))


def global_max_pool(x):
    """The max over H and W (under a spatial grid of the whole map)."""
    if spatial.active():
        return spatial.pool_max(x)
    return torch.amax(x, dim=(2, 3))
