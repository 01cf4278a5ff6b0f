"""``depthwise_device_ms`` (ms a step; layer: model, the separable blocks of
``models/nasnet.py``; moves ``train_img_per_s``): the device time a step of
the depthwise kernels that ``depthwise_conv_roofline`` reads (forward,
input and weight gradient), on rank 0, under the same rule: nothing unless
each pass launched once a step for each of the reference's depthwise
layers."""

from perfbench.metrics.depthwise_conv_roofline import depthwise_seconds


def read(record):
    seconds = depthwise_seconds(record)
    return None if seconds is None else 1e3 * seconds
