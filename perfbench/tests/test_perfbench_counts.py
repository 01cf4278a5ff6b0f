"""The operation and byte counters against hand counts, and the arithmetic
of roofline shares and MFU."""

import json
import math

import pytest

from perfbench import counts
from perfbench.reference import resnet50, resnet110wfc

ROOT = counts.__file__.rsplit("/", 1)[0]
R50 = json.load(open(f"{ROOT}/configs/resnet50.json"))
R110 = json.load(open(f"{ROOT}/configs/resnet110wfc.json"))


def _layers(arch, config, classes=1000, batch=2, size=224):
    return counts.record_layers(arch, config, classes, batch, size)


@pytest.mark.parametrize("stage,size", [(1, 56), (2, 28), (3, 14), (4, 7)])
def test_bottleneck_block_by_hand(stage, size):
    """Each stage's second block at 224 px: 1x1 C->F, 3x3 F->F, 1x1 F->4F
    with C = 4F, three BatchNorms, three relus and the residual add."""
    f = 64 * 2 ** (stage - 1)
    pixels = 2 * size * size  # a batch of two
    macs = pixels * (4 * f * f + 9 * f * f + f * 4 * f)
    layers = [l for l in _layers(resnet50, R50)
              if l.get("name", "").startswith(f"backbone.stage{stage}_block2.")]
    convs = [l for l in layers if l["kind"] == "conv"]
    assert [(l["c"], l["f"], l["k"], l["h"]) for l in convs] == [
        (4 * f, f, 1, size), (f, f, 3, size), (f, 4 * f, 1, size)]
    assert sum(counts.layer_flops(l) for l in convs) == 6 * macs
    bns = [l for l in layers if l["kind"] == "bn"]
    assert [l["elements"] for l in bns] == [f * pixels, f * pixels, 4 * f * pixels]


def test_resnet50_forward_is_3_9_gmacs_an_image():
    """ResNet-50 at 224 px with the stride on the 1x1 ``conv_a`` (Keras's
    layout): 3.86 G multiply-adds in its convs and dense layers, He et
    al.'s "3.8 x 10^9 FLOPs" (Table 1, multiply-adds), so a training step
    is about 23.2 GFLOP an image."""
    layers = _layers(resnet50, R50)
    macs = sum(counts.layer_flops(l) for l in layers if l["kind"] in ("conv", "dense")) / 12
    assert 3.8e9 < macs < 3.9e9
    assert 23.0e9 < counts.model_flops(layers) / 2 < 23.6e9


def test_first_conv_takes_no_input_gradient():
    layers = _layers(resnet50, R50)
    stem = layers[0]
    assert stem["name"] == "backbone.conv0" and (stem["k"], stem["h"]) == (7, 112)
    macs = 2 * 112 * 112 * 64 * 3 * 49
    assert counts.layer_flops(stem, first_conv=True) == 4 * macs
    others = sum(counts.layer_flops(l) for l in layers[1:])
    assert counts.model_flops(layers) == 4 * macs + others


def test_resnet110wfc_counts_scale_with_the_batch():
    one = counts.model_flops(_layers(resnet110wfc, R110, 100, 2, 32)) / 2
    hundred = counts.model_flops(_layers(resnet110wfc, R110, 100, 100, 32))
    assert hundred == 100 * one
    # 3 x 36 3x3 convs of 9 * 32 * 32 * 1024 (= 64 * 64 * 256 = 128 * 128 * 64) MACs
    assert 5.9e9 < one < 6.4e9


def test_conv3x3_work_and_its_bound():
    layers = counts.conv3x3_shapes(_layers(resnet50, R50, batch=128))
    assert len(layers) == 16
    stage1 = layers[0]
    flops, nbytes = counts.conv3x3_bn_stats_work(stage1, 4)
    pixels = 128 * 56 * 56
    assert flops == 2 * pixels * 64 * 64 * 9 + 3 * pixels * 64
    assert nbytes == (2 * pixels * 64 + 9 * 64 * 64) * 4 + 2 * 64 * 4
    wflops, wbytes = counts.conv3x3_filter_grad_work(stage1, 2)
    assert wflops == 2 * pixels * 64 * 64 * 9
    assert wbytes == 2 * pixels * 64 * 2 + 9 * 64 * 64 * 4
    # 29.6 GFLOP at 495 / 3 TFLOP/s: 0.179 ms, bound by the operations
    bound = counts.bound_s(flops, nbytes, "float32")
    assert math.isclose(bound, flops / (495e12 / 3))
    assert 0.000179 < bound < 0.000180
    # bf16: the bytes bound the filter gradient's stage 1
    assert counts.bound_s(wflops, wbytes, "bfloat16") == wbytes / counts.PEAK_BYTES


def test_roofline_and_mfu_arithmetic():
    work = [(1.65e11, 0.0)] * 2  # two calls of 1 ms each at the f32 peak
    assert math.isclose(counts.roofline_pct(work, 0.004, "float32"), 50.0)
    # 3.15 TFLOP a step, 7 steps a second on one chip: 13.4% of 165 TFLOP/s
    assert math.isclose(counts.mfu_pct(3.15e12, 7, 1.0, "float32", 1),
                        100 * 3.15e12 * 7 / (495e12 / 3))
    assert math.isclose(counts.mfu_pct(1e12, 1, 1.0, "bfloat16", 4), 100 / 3956)
