"""The plain reference of the semantic-embedding recipes' CIFAR network
``resnet-110-wfc`` (cvjena/semantic-embeddings, README.md, the CIFAR-100
recipe): He et al.'s CIFAR ResNet-110 (CVPR 2016, section 4.2: a 3x3
stem, then 3 stages of 18 blocks of two 3x3 convs with BatchNorm, identity
shortcuts, stride 2 at the first block of stages 2 and 3), "wide" with
filters (32, 64, 128) in place of (16, 32, 64), "fc" for the linear ``top``
of ``d`` units after global average pooling.  A shortcut that changes size
average-pools by the stride and pads the channels with zeros (half before,
half after: the paper's option A).  Convs have no bias; BatchNorm is Keras's
(epsilon 1e-3)."""

from __future__ import annotations


def shapes(config, classes, channels=3):
    """name -> (shape, kind), as :func:`.resnet50.shapes` gives them."""
    out = {}

    def conv(name, f, c):
        out[f"backbone.{name}.weight"] = ((f, c, 3, 3), "conv")

    def bn(name, f, prefix="backbone."):
        for key, kind in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            out[f"{prefix}{name}.{key}"] = ((f,), kind)

    filters = config["filters"]
    conv("conv0", filters[0], channels)
    bn("bn0", filters[0])
    c = filters[0]
    for s, f in enumerate(filters):
        for b in range(config["blocks_per_stage"]):
            name = f"stage{s + 1}_block{b + 1}"
            conv(f"{name}.conv_a", f, c)
            bn(f"{name}.bn_a", f)
            conv(f"{name}.conv_b", f, f)
            bn(f"{name}.bn_b", f)
            c = f
    out["backbone.top.weight"] = ((classes, c), "dense")
    out["backbone.top.bias"] = ((classes,), "bias")
    bn("cls_bn", classes, prefix="")
    out["cls_top.weight"] = ((classes, classes), "dense")
    out["cls_top.bias"] = ((classes,), "bias")
    return out


def forward(ops, params, stats, x, config):
    """The raw embedding (B, d) of NCHW images ``x``."""
    eps = config["bn_epsilon"]

    def conv_bn(name, y, stride=1):
        y = ops.conv(f"backbone.{name}", y, params[f"backbone.{name}.weight"], stride)
        bn = name.replace("conv", "bn")
        return ops.batch_norm(f"backbone.{bn}", y, params, stats, eps=eps)

    y = ops.relu(conv_bn("conv0", x))
    c = config["filters"][0]
    for s, f in enumerate(config["filters"]):
        for b in range(config["blocks_per_stage"]):
            name = f"stage{s + 1}_block{b + 1}"
            stride = 2 if (b == 0 and s > 0) else 1
            h = ops.relu(conv_bn(f"{name}.conv_a", y, stride))
            h = conv_bn(f"{name}.conv_b", h)
            short = ops.avg_pool(y, stride) if stride > 1 else y
            if f > c:
                short = ops.pad_channels(short, (f - c) // 2, f - c - (f - c) // 2)
            y = ops.relu(ops.add(h, short))
            c = f
    y = ops.global_avg_pool(y)
    return ops.dense("backbone.top", y, params["backbone.top.weight"],
                     params["backbone.top.bias"])
