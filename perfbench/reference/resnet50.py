"""The plain reference of ResNet-50 (He et al., CVPR 2016, Table 1, the
50-layer column) as the embedding backbone of the semantic-embedding
recipes: Keras 2.2's ``ResNet50`` (a ZeroPadding(3) + VALID 7x7/2 stem
conv, ZeroPadding(1) + VALID 3x3/2 max-pool, bottleneck blocks of 1x1
(strided) -> 3x3 -> 1x1 x4 with a projection shortcut in each stage's first
block, BatchNorm with epsilon 1e-3 after every conv, global average pooling)
and a linear ``top`` of ``d`` units.  Convs have no bias.

Departures from the paper, all from the recipe: the stride sits on the 1x1
``conv_a`` (Keras's layout), the top is linear and l2-normalized (the
embedding), and the softmax head of the recipe sits on it
(:func:`.plain.heads_loss`)."""

from __future__ import annotations

STAGE_BLOCKS = (3, 4, 6, 3)


def shapes(config, classes, channels=3):
    """name -> (shape, kind) of every parameter and BatchNorm statistic,
    named as the program's ``state_dict`` names them; ``kind`` is ``conv``,
    ``dense``, ``bias``, ``scale``, ``mean`` or ``var``."""
    out = {}

    def conv(name, f, c, k):
        out[f"backbone.{name}.weight"] = ((f, c, k, k), "conv")

    def bn(name, f, prefix="backbone."):
        for key, kind in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            out[f"{prefix}{name}.{key}"] = ((f,), kind)

    width = config["stem_features"]
    conv("conv0", width, channels, 7)
    bn("bn0", width)
    c = width
    for s, blocks in enumerate(config["stage_blocks"]):
        f = width * 2 ** s
        for b in range(blocks):
            name = f"stage{s + 1}_block{b + 1}"
            if b == 0:
                conv(f"{name}.conv_sc", f * 4, c, 1)
                bn(f"{name}.bn_sc", f * 4)
            conv(f"{name}.conv_a", f, c, 1)
            bn(f"{name}.bn_a", f)
            conv(f"{name}.conv_b", f, f, 3)
            bn(f"{name}.bn_b", f)
            conv(f"{name}.conv_c", f * 4, f, 1)
            bn(f"{name}.bn_c", f * 4)
            c = f * 4
    out["backbone.top.weight"] = ((classes, c), "dense")
    out["backbone.top.bias"] = ((classes,), "bias")
    bn("cls_bn", classes, prefix="")
    out["cls_top.weight"] = ((classes, classes), "dense")
    out["cls_top.bias"] = ((classes,), "bias")
    return out


def forward(ops, params, stats, x, config):
    """The raw embedding (B, d) of NCHW images ``x``."""
    eps = config["bn_epsilon"]

    def conv_bn(name, y, stride=1, padding="SAME", conv="conv", bn="bn"):
        y = ops.conv(f"backbone.{name}.{conv}", y, params[f"backbone.{name}.{conv}.weight"],
                     stride, padding)
        return ops.batch_norm(f"backbone.{name}.{bn}", y, params, stats, eps=eps)

    y = ops.conv("backbone.conv0", x, params["backbone.conv0.weight"], 2, (3, 3, 3, 3))
    y = ops.relu(ops.batch_norm("backbone.bn0", y, params, stats, eps=eps))
    # zero padding before the max-pool is exact: its input is post-relu
    y = ops.max_pool(ops.pad(y, 1), 3, 2)
    for s, blocks in enumerate(config["stage_blocks"]):
        for b in range(blocks):
            name = f"stage{s + 1}_block{b + 1}"
            stride = 2 if (b == 0 and s > 0) else 1
            h = ops.relu(conv_bn(name, y, stride, conv="conv_a", bn="bn_a"))
            h = ops.relu(conv_bn(name, h, conv="conv_b", bn="bn_b"))
            h = conv_bn(name, h, conv="conv_c", bn="bn_c")
            short = conv_bn(name, y, stride, conv="conv_sc", bn="bn_sc") if b == 0 else y
            y = ops.relu(ops.add(h, short))
    y = ops.global_avg_pool(y)
    return ops.dense("backbone.top", y, params["backbone.top.weight"],
                     params["backbone.top.bias"])
