"""``depthwise_conv_roofline`` (%; layer: ops, the depthwise convs of
``models/nasnet.py``'s separable blocks, which PyTorch sends in f32 NCHW to
ATen's own kernels, ``DepthwiseConv2d.cu``; moves ``train_img_per_s``): the
bound of the step's depthwise work over the device time of those kernels,
on rank 0.  Each of the reference's depthwise layers runs three passes,
each of 2 k^2 operations an output (a multiply-add a tap) and bound by its
bytes: the forward reads x and w and writes y, the input gradient reads dy
and w and writes dx, the weight gradient reads x and dy and writes the f32
dw.  Nothing where no window is whole or a pass's kernels do not launch
exactly as many times a step as the reference has depthwise layers."""

from perfbench import counts, trace

#: the kernels of each pass, by short name (regular expressions)
PASSES = {"forward": r"conv_depthwise2d_forward", "input_grad": r"conv_depthwise2d_backward",
          "weight_grad": r"conv_depthwise2d_grad_weight"}


def depthwise_layers(layers):
    """The reference's depthwise convs (recorded with ``depthwise`` set)."""
    return [l for l in layers if l["kind"] == "conv" and l.get("depthwise")]


def depthwise_work(layer, itemsize):
    """[(operations, bytes)] of the forward, input-gradient and
    weight-gradient passes of one depthwise conv (x counted unpadded)."""
    n, c, k = layer["n"], layer["f"], layer["k"]
    x = n * c * layer["h_in"] * layer["w_in"]
    y = n * c * layer["h"] * layer["w"]
    w = c * k * k
    flops = 2 * k * k * y
    return [(flops, (x + w + y) * itemsize), (flops, (y + w + x) * itemsize),
            (flops, (x + y) * itemsize + w * 4)]


def depthwise_seconds(record):
    """Device seconds a step of the depthwise kernels on rank 0, or None
    unless each pass launched once a step for each depthwise layer."""
    traces = record["traces"]
    if not traces or traces[0]["records_lost"]:
        return None
    layers = depthwise_layers(record["layers"])
    if not layers:
        return None
    total = 0.0
    for pattern in PASSES.values():
        seconds, launches = trace.kernel_seconds(traces[0], (pattern,))
        if launches != len(layers):
            return None
        total += seconds
    return total


def read(record):
    seconds = depthwise_seconds(record)
    if seconds is None:
        return None
    dtype = record["cell"].dtype
    itemsize = 2 if dtype == "bfloat16" else 4
    work = [w for l in depthwise_layers(record["layers"]) for w in depthwise_work(l, itemsize)]
    return counts.roofline_pct(work, seconds, dtype)
