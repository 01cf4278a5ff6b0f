"""``conv3x3_filter_grad_roofline`` (%; layer: ops, ``ops/conv3x3.py``,
``csrc/conv3x3_filter_grad.cu``; moves ``train_img_per_s``): built as
``conv3x3_bn_stats_roofline``, for the 3x3 filter gradient (x and dy read
once, the f32 dw written once)."""

from perfbench import counts, trace

MAIN = ("filter_grad_wgmma_kernel", "filter_grad_tf32_kernel")
HELPERS = ("reduce_splits_kernel",)
OTHERS = ("conv3x3_stats_wgmma_kernel", "conv3x3_stats_tf32_kernel")


def read(record):
    return trace.conv3x3_roofline(record, MAIN, HELPERS, OTHERS, counts.conv3x3_filter_grad_work)
