"""Operations and bytes from shapes, the card's published peaks, and the
arithmetic of a roofline share and of MFU.

The model's operations are counted from its plain reference: the forward
runs once on the meta device through a :class:`Recorder`, which notes the
shape of every layer, and :func:`model_flops` turns those into the
operations of a forward and backward pass, whatever implements each layer
in the program.
"""

from __future__ import annotations

import torch

from .reference import plain

#: Published peaks of one NVIDIA H100 SXM (dense).  f32 products exact to
#: f32 run on the tensor cores as 3xTF32, three TF32 products at 495
#: TFLOP/s each: the fastest the card computes f32-accurate products.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
PEAK_BYTES = 3.35e12  # HBM3, bytes/s

#: operations per element of the elementwise layers, forward and backward
#: (a convention; together they are about 1% of a ResNet step): BatchNorm
#: forms the sums of x and x**2 and normalizes, scales and shifts; its
#: backward forms two sums and combines them
BN_FWD, BN_BWD = 7, 9


class Recorder(plain.Ops):
    """The reference's layers on meta tensors, noting each one's shapes in
    ``layers``: dicts with ``kind`` and the sizes that count."""

    def __init__(self):
        super().__init__("f32")
        self.layers = []

    def conv(self, name, x, w, stride=1, padding="SAME"):
        y = super().conv(name, x, w, stride, padding)
        self.layers.append(dict(kind="conv", name=name, n=x.shape[0], c=w.shape[1],
                                f=w.shape[0], k=w.shape[-1], stride=stride,
                                h=y.shape[2], w=y.shape[3], h_in=x.shape[2],
                                w_in=x.shape[3]))
        return y

    def dense(self, name, x, w, b):
        self.layers.append(dict(kind="dense", name=name, n=x.shape[0], c=w.shape[1],
                                f=w.shape[0]))
        return super().dense(name, x, w, b)

    def batch_norm(self, name, x, params, stats, momentum=0.99, eps=1e-3):
        self.layers.append(dict(kind="bn", name=name, elements=x.numel()))
        return super().batch_norm(name, x, params, stats, momentum, eps)

    def relu(self, x):
        self.layers.append(dict(kind="relu", elements=x.numel()))
        return super().relu(x)

    def max_pool(self, x, window, stride):
        y = super().max_pool(x, window, stride)
        self.layers.append(dict(kind="pool", elements=y.numel() * window * window))
        return y

    def avg_pool(self, x, window):
        y = super().avg_pool(x, window)
        self.layers.append(dict(kind="pool", elements=y.numel() * window * window))
        return y

    def global_avg_pool(self, x):
        self.layers.append(dict(kind="pool", elements=x.numel()))
        return super().global_avg_pool(x)

    def add(self, a, b):
        self.layers.append(dict(kind="add", elements=a.numel()))
        return super().add(a, b)


def record_layers(arch, config, classes, batch, image_size):
    """The layers of one forward of reference module ``arch`` over a batch
    of ``batch`` images, heads included, with their shapes."""
    rec = Recorder()
    meta = torch.device("meta")
    with torch.no_grad():
        shapes = arch.shapes(config, classes)
        params = {n: torch.empty(s, device=meta) for n, (s, _) in shapes.items()}
        stats = {n: params[n] for n, (_, k) in shapes.items() if k in ("mean", "var")}
        x = torch.empty((batch, 3, image_size, image_size), device=meta)
        z = arch.forward(rec, params, stats, x, config)
        targets = torch.empty_like(z)
        labels = torch.zeros(batch, dtype=torch.long, device=meta)
        plain.heads_loss(rec, z, params, stats, targets, labels, config["cls_weight"])
    rec.layers.append(dict(kind="loss", n=batch, d=z.shape[1], classes=classes))
    return rec.layers


def layer_flops(layer, first_conv=False):
    """Operations of one layer's forward and backward.  A conv or dense
    layer of M multiply-adds takes 2M forward, 2M for its weight gradient
    and 2M for its input gradient (none for the first conv, whose input is
    the images)."""
    kind = layer["kind"]
    if kind == "conv":
        macs = layer["n"] * layer["h"] * layer["w"] * layer["f"] * layer["c"] * layer["k"] ** 2
        return 2 * macs * (2 if first_conv else 3)
    if kind == "dense":
        macs = layer["n"] * layer["c"] * layer["f"]
        return 6 * macs + 2 * layer["n"] * layer["f"]
    if kind == "bn":
        return (BN_FWD + BN_BWD) * layer["elements"]
    if kind in ("relu", "pool"):
        return 2 * layer["elements"]
    if kind == "add":
        return layer["elements"]
    if kind == "loss":
        # l2 normalization, the cosine and the softmax cross-entropy
        return layer["n"] * (13 * layer["d"] + 10 * layer["classes"])
    raise ValueError(f"no operation count for a {kind} layer")


def model_flops(layers):
    """Operations of one training step's forward and backward."""
    first = next(i for i, l in enumerate(layers) if l["kind"] == "conv")
    return sum(layer_flops(l, i == first) for i, l in enumerate(layers))


def conv3x3_shapes(layers):
    """The 3x3 stride-1 convs feeding a BatchNorm that the program runs
    through its fused conv + statistics op: a block's ``conv_b``."""
    return [l for l in layers if l["kind"] == "conv" and l["k"] == 3 and l["stride"] == 1
            and l["name"].endswith(".conv_b")]


def conv3x3_bn_stats_work(layer, itemsize):
    """(operations, bytes) of one 3x3 conv with the per-channel sums of y and
    y**2: x, w read once, y written once, the two f32 sums written."""
    n, c, f, h, w = (layer[k] for k in ("n", "c", "f", "h", "w"))
    flops = 2 * n * h * w * f * c * 9 + 3 * n * h * w * f
    nbytes = (n * c * h * w + 9 * c * f + n * f * h * w) * itemsize + 2 * f * 4
    return flops, nbytes


def conv3x3_filter_grad_work(layer, itemsize):
    """(operations, bytes) of one 3x3 filter gradient: x and dy read once in
    x's dtype, the f32 dw written once."""
    n, c, f, h, w = (layer[k] for k in ("n", "c", "f", "h", "w"))
    flops = 2 * n * h * w * f * c * 9
    nbytes = (n * c * h * w + n * f * h * w) * itemsize + 9 * c * f * 4
    return flops, nbytes


def bound_s(flops, nbytes, dtype):
    """The least time the card could take: the larger of the operations over
    the dtype's peak and the bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def roofline_pct(work, seconds, dtype):
    """A kernel's share of its roofline, in %: the bound of ``work``, a list
    of (operations, bytes), over the ``seconds`` it took."""
    return 100.0 * sum(bound_s(f, b, dtype) for f, b in work) / seconds


def mfu_pct(flops_per_step, steps, seconds, dtype, chips):
    """Model FLOP utilization in %: the model's operations over the window
    against the peak of all the cell's chips in the cell's precision."""
    return 100.0 * flops_per_step * steps / seconds / (PEAK_FLOPS[dtype] * chips)
