"""The plain reference of NASNet-A (Zoph, Vasudevan, Shlens and Le, CVPR
2018, Table 2; "NASNet-A (6 @ 4032)" is the large ImageNet model) as the
embedding backbone of the semantic-embedding recipes, written from Keras's
``keras_applications.nasnet`` (``NASNet``, ``_separable_conv_block``,
``_adjust_block``, ``_normal_a_cell``, ``_reduction_a_cell``):

- the stem: a VALID 3x3/2 conv of ``stem_filters`` and BatchNorm, no ReLU;
- two stem reduction cells of ``filters // 4`` and ``filters // 2``
  (``filters = penultimate_filters // 24``), then three stages of
  ``num_normal_cells`` normal cells of ``filters * 2**stage``, a reduction
  cell between stages;
- each cell first adjusts its previous-previous input p (``_adjust_block``):
  none where there is none (p is the raw input), a factorized reduction
  where p's map is larger (ReLU, a 1x1 conv of every other pixel and one of
  every other pixel of the input shifted up and left by one with zeros
  coming in, ``filters // 2`` each, concatenated, BatchNorm), a 1x1
  projection (ReLU, conv, BatchNorm) where only the channels differ;
- then squeezes its input to h (ReLU, 1x1 conv, BatchNorm);
- separable blocks are (ReLU, depthwise k x k, pointwise 1x1, BatchNorm)
  twice, the stride in the first depthwise only, SAME padding (Keras's
  ``correct_pad`` + VALID is TF SAME);
- the normal cell concatenates p, sep5(h) + sep3(p), sep5(p) + sep3(p),
  avg3(h) + p, avg3(p) + avg3(p), sep3(h) + h, where avg3 is a SAME 3x3/1
  average that divides by the cells inside the image;
- the reduction cell pads h with zeros by the SAME amounts of a 3x3/2
  window (h3) and concatenates x2 = max3(h3) + sep7/2(p),
  x3 = avg3/2(h3) + sep5/2(p), avg3(x1) + x2 and sep3(x1) + max3(h3), where
  x1 = sep5/2(h) + sep7/2(p); the VALID pools over h3 see its zeros and the
  average divides by 9;
- skip reduction: a reduction cell does not advance p, so the first normal
  cell after it takes p from the cell before the last normal one;
- ReLU, global average pooling and the linear ``top``.

BatchNorm: momentum 0.9997, epsilon 1e-3 (``bn_momentum``, ``bn_epsilon``);
no conv has a bias.

Departures from Keras, all from the recipe or the benchmark: the top is
linear with ``d`` units (the embedding) and the recipe's softmax head sits
on it (:func:`.plain.heads_loss`); the input is NCHW; whether a cell's p is
larger than its input is decided from the count of reductions each has
passed (Keras compares widths: the same for inputs of 32 px or more, where
every reduction halves the map), which lets :func:`shapes` name the
parameters without an image size.  Each depthwise conv runs through this
module's own autograd function (:class:`_Depthwise`), so that the control's
rounding reaches its operands.  Under autograd each cell is recomputed in
the backward, its running statistics moved once: at batch 128 on an H100
the reference then peaks near 13 GiB, against 61 GiB (69 GiB under the
TF32 control) with every activation kept.

Parameter names are those of the program's ``state_dict``: cells
``cell_stem_1``, ``cell_stem_2``, ``cell_0`` .. ``cell_{N-1}``,
``cell_reduce_N``, ``cell_{N+1}`` .. (Keras's block ids); in a cell
``adjust.factorize.conv_1`` / ``conv_2`` / ``bn`` or ``adjust.squeeze.conv``
/ ``bn``, ``conv_1.conv`` / ``bn`` (the squeeze of h), and the separable
blocks by Keras's branch names (``left1``, ``right1``, ...; the reduction
cell's ``sep3(x1)`` is ``left4``, Keras's own id), each with ``dw0``,
``pw0``, ``bn0``, ``dw1``, ``pw1``, ``bn1``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .plain import same_pads

#: (branch, input, kernel) of each cell's separable blocks
NORMAL_BLOCKS = (("left1", "h", 5), ("right1", "p", 3), ("left2", "p", 5), ("right2", "p", 3),
                 ("left5", "h", 3))
REDUCTION_BLOCKS = (("left1", "h", 5), ("right1", "p", 7), ("right2", "p", 7), ("right3", "p", 5),
                    ("left4", "x1", 3))


def cells(config):
    """Keras's cells in order: dicts of ``name``, ``kind`` (``normal`` or
    ``reduction``), ``filters``, the channels of the input ``ip`` and of p
    before (``p_in``) and after (``p``) its adjustment, and the adjustment
    (``absent``, ``factorize``, ``squeeze`` or None)."""
    n, filters = config["num_normal_cells"], config["penultimate_filters"] // 24
    out = []
    # (channels, reductions passed) of the current input and of p
    state = {"x": (config["stem_filters"], 0), "p": None}

    def add(name, kind, f, advance_p=True):
        ip, p = state["x"], state["p"]
        if p is None:
            adjust = "absent"
        elif p[1] != ip[1]:
            adjust = "factorize"
        elif p[0] != f:
            adjust = "squeeze"
        else:
            adjust = None
        p_out = ip[0] if adjust == "absent" else (p[0] if adjust is None else f)
        out.append(dict(name=name, kind=kind, filters=f, ip=ip[0],
                        p_in=None if p is None else p[0], p=p_out, adjust=adjust))
        state["x"] = (6 * f, ip[1]) if kind == "normal" else (4 * f, ip[1] + 1)
        if advance_p:  # a cell returns (x, ip); skip reduction keeps p
            state["p"] = ip

    add("cell_stem_1", "reduction", filters // 4)
    add("cell_stem_2", "reduction", filters // 2)
    for stage in range(3):
        f = filters * 2 ** stage
        if stage:
            add(f"cell_reduce_{stage * n}", "reduction", f, advance_p=False)
        for i in range(n):
            add(f"cell_{stage * n + i + (1 if stage else 0)}", "normal", f)
    return out


def shapes(config, classes, channels=3):
    """name -> (shape, kind) of every parameter and BatchNorm statistic,
    named as the program's ``state_dict`` names them; ``kind`` is ``conv``
    (depthwise kernels too), ``dense``, ``bias``, ``scale``, ``mean`` or
    ``var``."""
    out = {}

    def conv(name, f, c, k=1):
        out[f"{name}.weight"] = ((f, c, k, k), "conv")

    def bn(name, f):
        for key, kind in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            out[f"{name}.{key}"] = ((f,), kind)

    def separable(name, c, f, k):
        conv(f"{name}.dw0", c, 1, k)
        conv(f"{name}.pw0", f, c)
        bn(f"{name}.bn0", f)
        conv(f"{name}.dw1", f, 1, k)
        conv(f"{name}.pw1", f, f)
        bn(f"{name}.bn1", f)

    stem = config["stem_filters"]
    conv("backbone.stem_conv", stem, channels, 3)
    bn("backbone.stem_bn", stem)
    plan = cells(config)
    for cell in plan:
        name, f = f"backbone.{cell['name']}", cell["filters"]
        if cell["adjust"] == "factorize":
            conv(f"{name}.adjust.factorize.conv_1", f // 2, cell["p_in"])
            conv(f"{name}.adjust.factorize.conv_2", f // 2, cell["p_in"])
            bn(f"{name}.adjust.factorize.bn", f)
        elif cell["adjust"] == "squeeze":
            conv(f"{name}.adjust.squeeze.conv", f, cell["p_in"])
            bn(f"{name}.adjust.squeeze.bn", f)
        conv(f"{name}.conv_1.conv", f, cell["ip"])
        bn(f"{name}.conv_1.bn", f)
        blocks = NORMAL_BLOCKS if cell["kind"] == "normal" else REDUCTION_BLOCKS
        for branch, source, k in blocks:
            separable(f"{name}.{branch}", cell["p"] if source == "p" else f, f, k)
    last = plan[-1]
    top_in = last["filters"] * (6 if last["kind"] == "normal" else 4)
    out["backbone.top.weight"] = ((classes, top_in), "dense")
    out["backbone.top.bias"] = ((classes,), "bias")
    bn("cls_bn", classes)
    out["cls_top.weight"] = ((classes, classes), "dense")
    out["cls_top.bias"] = ((classes,), "bias")
    return out


class _Depthwise(torch.autograd.Function):
    """A depthwise conv (one k x k filter a channel, ``F.conv2d`` with
    ``groups`` = channels) of an input already padded, whose operands are
    rounded to a precision forward and backward, as :class:`.plain._Conv`
    rounds a dense conv's."""

    @staticmethod
    def forward(ctx, x, w, stride, fwd, bwd):
        xq, wq = fwd(x), fwd(w)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, bwd)
        return F.conv2d(xq, wq, None, stride, 0, 1, x.shape[1])

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        stride, bwd = ctx.conf
        gq = bwd(g)
        groups = xq.shape[1]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride, 0, 1, groups)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride, 0, 1, groups)
        return dx, dw, None, None, None


def _note(ops, **layer):
    """Records a layer where ``ops`` keeps a list of them (the counter)."""
    layers = getattr(ops, "layers", None)
    if layers is not None:
        layers.append(layer)


def depthwise(ops, name, x, w, stride):
    """A SAME depthwise conv of NCHW ``x`` with (C, 1, k, k) ``w``, recorded
    as a conv of one input channel a filter with ``depthwise`` set."""
    k = w.shape[-1]
    top, bottom = same_pads(x.shape[2], k, stride)
    left, right = same_pads(x.shape[3], k, stride)
    xp = F.pad(x, (left, right, top, bottom))
    y = ops.store(_Depthwise.apply(xp, w, stride, ops.fwd, ops.bwd))
    _note(ops, kind="conv", name=name, n=x.shape[0], c=1, f=w.shape[0], k=k,
          stride=stride, h=y.shape[2], w=y.shape[3], h_in=x.shape[2], w_in=x.shape[3],
          depthwise=True)
    return y


def _avg3_same(ops, x):
    """Keras's SAME 3x3/1 average: each window's sum over the cells inside
    the image, divided by their count."""
    total = F.avg_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 1, divisor_override=1)
    count = F.avg_pool2d(F.pad(torch.ones_like(x[:1, :1]), (1, 1, 1, 1)), 3, 1,
                         divisor_override=1)
    y = total / count
    _note(ops, kind="pool", elements=y.numel() * 9)
    return y


def _avg3_valid_s2(ops, x):
    """A VALID 3x3/2 average dividing by the whole window."""
    y = F.avg_pool2d(x, 3, 2)
    _note(ops, kind="pool", elements=y.numel() * 9)
    return y


def _pad_same_3s2(x):
    """``x`` padded with zeros by the TF SAME amounts of a 3x3/2 window."""
    top, bottom = same_pads(x.shape[2], 3, 2)
    left, right = same_pads(x.shape[3], 3, 2)
    return F.pad(x, (left, right, top, bottom))


def forward(ops, params, stats, x, config):
    """The raw embedding (B, d) of NCHW images ``x``."""
    momentum, eps = config["bn_momentum"], config["bn_epsilon"]

    def bn(name, y, sink):
        return ops.batch_norm(name, y, params, sink, momentum, eps)

    def conv1x1(name, y):
        return ops.conv(name, y, params[f"{name}.weight"])

    def separable(name, y, stride, sink):
        for i in (0, 1):
            y = ops.relu(y)
            y = depthwise(ops, f"{name}.dw{i}", y, params[f"{name}.dw{i}.weight"],
                          stride if i == 0 else 1)
            y = bn(f"{name}.bn{i}", conv1x1(f"{name}.pw{i}", y), sink)
        return y

    def adjust(name, cell, p, sink):
        if cell["adjust"] == "factorize":
            pre = f"{name}.adjust.factorize"
            p = ops.relu(p)
            shifted = F.pad(p, (0, 1, 0, 1))[:, :, 1:, 1:]
            halves = [conv1x1(f"{pre}.conv_1", p[:, :, ::2, ::2]),
                      conv1x1(f"{pre}.conv_2", shifted[:, :, ::2, ::2])]
            return bn(f"{pre}.bn", torch.cat(halves, dim=1), sink)
        if cell["adjust"] == "squeeze":
            pre = f"{name}.adjust.squeeze"
            return bn(f"{pre}.bn", conv1x1(f"{pre}.conv", ops.relu(p)), sink)
        return p

    def run_cell(cell, ip, p, sink):
        name = f"backbone.{cell['name']}"
        grew = p is not None and p.shape[3] != ip.shape[3]
        if grew != (cell["adjust"] == "factorize"):
            raise ValueError(f"{name}: input of {tuple(ip.shape)} too small for the model")
        p = ip if p is None else adjust(name, cell, p, sink)
        h = bn(f"{name}.conv_1.bn", conv1x1(f"{name}.conv_1.conv", ops.relu(ip)), sink)

        def sep(branch, y, stride):
            return separable(f"{name}.{branch}", y, stride, sink)

        if cell["kind"] == "normal":
            x1 = ops.add(sep("left1", h, 1), sep("right1", p, 1))
            x2 = ops.add(sep("left2", p, 1), sep("right2", p, 1))
            x3 = ops.add(_avg3_same(ops, h), p)
            x4 = ops.add(_avg3_same(ops, p), _avg3_same(ops, p))
            x5 = ops.add(sep("left5", h, 1), h)
            return torch.cat([p, x1, x2, x3, x4, x5], dim=1)
        h3 = _pad_same_3s2(h)
        x1 = ops.add(sep("left1", h, 2), sep("right1", p, 2))
        x2 = ops.add(ops.max_pool(h3, 3, 2), sep("right2", p, 2))
        x3 = ops.add(_avg3_valid_s2(ops, h3), sep("right3", p, 2))
        x4 = ops.add(_avg3_same(ops, x1), x2)
        x5 = ops.add(sep("left4", x1, 1), ops.max_pool(h3, 3, 2))
        return torch.cat([x2, x3, x4, x5], dim=1)

    def recomputed(cell, ip, p):
        """The cell under a checkpoint: its recompute moves a copy of the
        statistics, so that they move once."""
        calls = []

        def fn(ip, p):
            sink = stats if not calls else dict(stats)
            calls.append(1)
            return run_cell(cell, ip, p, sink)

        return checkpoint(fn, ip, p, use_reentrant=False)

    recompute = torch.is_grad_enabled() and x.device.type != "meta"
    y = ops.conv("backbone.stem_conv", x, params["backbone.stem_conv.weight"], 2, (0, 0, 0, 0))
    ip, p = bn("backbone.stem_bn", y, stats), None
    for cell in cells(config):
        out = recomputed(cell, ip, p) if recompute else run_cell(cell, ip, p, stats)
        if cell["name"].startswith("cell_reduce"):
            ip = out  # skip reduction: p stays
        else:
            ip, p = out, ip
    y = ops.global_avg_pool(ops.relu(ip))
    return ops.dense("backbone.top", y, params["backbone.top.weight"],
                     params["backbone.top.bias"])
