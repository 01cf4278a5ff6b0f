"""``conv1x1_filter_grad_roofline`` (%; layer: ops, ``ops/conv1x1.py``,
``csrc/conv1x1_filter_grad.cu``; moves ``train_img_per_s``): the bound of
the step's 1x1 conv weight gradients over the device time of the kernels
the op launches (its main kernel and its reduction of the split partials),
on rank 0.  The bound is max(operations / peak, bytes / 3.35 TB/s) for each
of the reference's 1x1 conv layers at its shapes: x read once at the pixels
the conv reads (every other row and column at stride 2), dy read once, the
f32 dw written once.  Nothing where no window is whole or the main kernel's
launches a step are not exactly as many as those layers."""

from perfbench import counts, trace

MAIN = ("filter_grad_1x1_tf32_kernel",)
HELPERS = ("reduce_splits_1x1_kernel",)


def conv1x1_shapes(layers):
    """The reference's 1x1 conv layers: a block's ``conv_a``, ``conv_c`` and
    projection shortcut."""
    return [l for l in layers if l["kind"] == "conv" and l["k"] == 1]


def conv1x1_filter_grad_work(layer, itemsize):
    """(operations, bytes) of one 1x1 weight gradient: x at the output's
    pixels and dy read once in x's dtype, the f32 dw written once."""
    n, c, f, h, w = (layer[k] for k in ("n", "c", "f", "h", "w"))
    flops = 2 * n * h * w * f * c
    nbytes = (n * c * h * w + n * f * h * w) * itemsize + c * f * 4
    return flops, nbytes


def read(record):
    traces = record["traces"]
    if not traces or traces[0]["records_lost"]:
        return None
    seconds, launches = trace.op_seconds(traces[0], MAIN, HELPERS)
    layers = conv1x1_shapes(record["layers"])
    if not layers or launches != len(layers):
        return None
    dtype = record["cell"].dtype
    itemsize = 2 if dtype == "bfloat16" else 4
    return counts.roofline_pct([conv1x1_filter_grad_work(l, itemsize) for l in layers],
                               seconds, dtype)
