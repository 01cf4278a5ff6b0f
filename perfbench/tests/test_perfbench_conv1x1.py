"""``conv1x1_filter_grad_roofline`` on a synthetic trace: the share at 36
launches a step of ResNet-50's 1x1 weight gradients, nothing at any other
count, and the 3x3 ops' readers unmoved by the new kernels in the sequence."""

import json
import math
from types import SimpleNamespace

import pytest

from perfbench import counts, harness
from perfbench.reference import resnet50

R50 = json.load(open(harness.HERE / "configs" / "resnet50.json"))
LAYERS = counts.record_layers(resnet50, R50, 1000, 128, 224)
MAIN_S, REDUCE_S = 200e-6, 5e-6  # a launch of each, seconds
STEPS = 2


def _record(n_1x1, with_1x1=True):
    """Two steps: each 3x3 ``conv_b`` launches its ops (a repack before the
    filter gradient), and ``n_1x1`` 1x1 weight gradients (main kernel and
    reduction) fall among them, one between a repack and its kernel."""
    seq = []
    for _ in range(STEPS):
        ones = [("filter_grad_1x1_tf32_kernel", MAIN_S),
                ("reduce_splits_1x1_kernel", REDUCE_S)] * n_1x1 if with_1x1 else []
        for i in range(16):
            seq += [("conv3x3_stats_tf32_kernel", 300e-6), ("reduce_partials_kernel", 2e-6),
                    ("pad_planes_kernel", 10e-6)]
            seq += ones[:2] if i == 0 else []
            seq += [("filter_grad_tf32_kernel", 320e-6), ("reduce_splits_kernel", 4e-6)]
        seq += ones[2:]
    traces = [{"sequence": seq, "steps": STEPS, "records_lost": 0}]
    return {"traces": traces, "layers": LAYERS, "cell": SimpleNamespace(dtype="float32")}


def test_share_at_36_launches_a_step():
    read = harness.reader("conv1x1_filter_grad_roofline")
    ones = [l for l in LAYERS if l["kind"] == "conv" and l["k"] == 1]
    assert len(ones) == 36 and sum(l["stride"] == 2 for l in ones) == 6
    bound = 0.0
    for l in ones:
        pixels = l["n"] * l["h"] * l["w"]
        flops = 2 * pixels * l["c"] * l["f"]
        nbytes = 4 * pixels * (l["c"] + l["f"]) + 4 * l["c"] * l["f"]
        bound += max(flops / (495e12 / 3), nbytes / 3.35e12)
    assert 3.40e-3 < bound < 3.45e-3  # 3.42 ms a step
    share = read(_record(36))
    assert math.isclose(share, 100 * bound / (36 * (MAIN_S + REDUCE_S)))


@pytest.mark.parametrize("n", [0, 35, 37, 72])
def test_nothing_at_any_other_count(n):
    assert harness.reader("conv1x1_filter_grad_roofline")(_record(n)) is None


def test_nothing_without_a_whole_trace():
    read = harness.reader("conv1x1_filter_grad_roofline")
    record = _record(36)
    record["traces"][0]["records_lost"] = 3
    assert read(record) is None
    assert read(dict(record, traces=None)) is None


@pytest.mark.parametrize("metric", ["conv3x3_filter_grad_roofline",
                                    "conv3x3_bn_stats_roofline"])
def test_3x3_readers_unmoved_by_the_new_kernels(metric):
    read = harness.reader(metric)
    without = read(_record(0, with_1x1=False))
    assert without is not None
    assert read(_record(36)) == without
