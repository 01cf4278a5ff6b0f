"""``conv3x3_bn_stats_roofline`` (%; layer: ops, ``ops/conv3x3.py``,
``csrc/conv3x3_bn_stats.cu``; moves ``train_img_per_s``): the bound of the
step's 3x3 conv + BatchNorm statistics work over the device time of the
kernels the op launches, on rank 0.  The bound is max(operations / peak,
bytes / 3.35 TB/s) for each call at its shapes (x, w read once, y and the
two sums written once); the calls are the reference's ``conv_b`` layers,
and the kernel launches a step must match their number."""

from perfbench import counts, trace

MAIN = ("conv3x3_stats_wgmma_kernel", "conv3x3_stats_tf32_kernel")
HELPERS = ("permute_weights_kernel", "reduce_partials_kernel")
OTHERS = ("filter_grad_wgmma_kernel", "filter_grad_tf32_kernel")


def read(record):
    return trace.conv3x3_roofline(record, MAIN, HELPERS, OTHERS, counts.conv3x3_bn_stats_work)
