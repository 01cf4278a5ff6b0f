"""The benchmark's NASNet-A configuration on the CPU: the plain reference
(``perfbench/reference/nasnet_a.py``) trains as the port's ``NASNetA`` does
(three float64 steps of a small build), names the full-size model's
parameters as its ``state_dict`` does, counts 220 depthwise convs a forward
as the port's counter does, and imports nothing of the port or of JAX; the
depthwise readers read only whole passes; the port's forward opens its
spans inside a profiler session."""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import counts, feed, harness, trace  # noqa: E402
from perfbench.reference import nasnet_a, plain  # noqa: E402
from semantic_embeddings_torch.models import EmbeddingModel, build_network, nasnet  # noqa: E402

CONFIG = json.loads((harness.HERE / "configs" / "nasnet-a-large.json").read_text())
# one normal cell a stage; 96 penultimate filters give the first stem cell 1
SMALL = dict(num_normal_cells=1, penultimate_filters=96, stem_filters=8)
STEPS = 3


def _port_steps(weights, images, labels, table, lrs):
    """The port's train step (the CLI's --fused_loss recipe) on a small
    ``NASNetA`` in float64, fed the prepared images directly."""
    from semantic_embeddings_torch.ops import fused_cosine_loss
    from semantic_embeddings_torch.train import make_train_step, new_train_state

    classes = table.shape[0]
    model = EmbeddingModel(nasnet.NASNetA(classes=classes, **SMALL), output="l2norm",
                           cls_classes=classes, input_shape=(images.shape[1],) * 2 + (3,))
    model = model.double()
    model.load_state_dict(weights)
    state = new_train_state(model)
    step = make_train_step(
        model.twin("linear", cls_input="l2norm"),
        lambda raw, rng, train: (images[raw["idx"]], labels[raw["idx"]]),
        class_embedding=table.numpy(), num_classes=classes, cls_weight=CONFIG["cls_weight"],
        l2_penalty_fn=lambda m: 5e-4 * m.cls_top.weight.square().sum(),
        clipnorm=CONFIG["clipnorm"], momentum=CONFIG["momentum"],
        loss_fn_override=lambda t, z: fused_cosine_loss(z, t))
    batch = images.shape[0] // STEPS
    losses, grads = [], {}
    names = [n for n, _ in model.named_parameters()]
    for k in range(STEPS):
        state, metrics = step(state, {"idx": np.arange(k * batch, (k + 1) * batch)}, lrs[k], None)
        losses.append(float(metrics["loss"]))
        if k == 0:
            grads = {n: v / -lrs[0] for n, v in zip(names, state.velocity)}
    return losses, grads, model.state_dict()


def test_three_steps_agree_with_the_port_in_float64():
    """64 px, batch 4: every stage of the small build has maps of 2 px or
    more, each cell's adjustment runs (factorized and squeezed p), and the
    reference recomputes its cells in the backward."""
    batch, classes, size = 4, 10, 64
    config = dict(CONFIG, **SMALL)
    shapes = nasnet_a.shapes(config, classes)
    weights = {k: v.double() for k, v in
               feed.make_weights(shapes, 2**31 + 7, torch.device("cpu")).items()}
    gen = torch.Generator().manual_seed(3)
    images = torch.randn((STEPS * batch, size, size, 3), generator=gen, dtype=torch.float64)
    labels = torch.randint(0, classes, (STEPS * batch,), generator=gen)
    table = torch.randn((classes, classes), generator=gen, dtype=torch.float64)
    table = (table / table.norm(dim=1, keepdim=True)).float().double()
    lrs = [plain.sgdr_lr(k, 10, 0.5, 12, 2, 1e-3) for k in range(STEPS)]

    losses, grads, after = _port_steps(weights, images, labels, table, lrs)

    params = {n: w.clone().requires_grad_() for n, w in weights.items()
              if shapes[n][1] not in ("mean", "var")}
    stats = {n: w.clone() for n, w in weights.items() if shapes[n][1] in ("mean", "var")}
    velocity = {n: torch.zeros_like(p) for n, p in params.items()}
    ops = plain.Ops("f32")
    for k in range(STEPS):
        rows = slice(k * batch, (k + 1) * batch)
        loss, clipped = plain.train_step(nasnet_a, ops, params, stats, velocity, images[rows],
                                         labels[rows], table, lrs[k], config)
        assert math.isclose(float(loss), losses[k], rel_tol=1e-10)
        if k == 0:
            for n, g in clipped.items():
                torch.testing.assert_close(grads[n], g, rtol=1e-8, atol=1e-12)
    for n, t in {**params, **stats}.items():
        torch.testing.assert_close(after[n], t.detach(), rtol=1e-8, atol=1e-12)


def test_full_size_names_are_the_ports_and_the_count_published():
    """The reference's tree is the port's ``state_dict`` (weights made for
    one load strictly into the other): 88,753,150 parameters with a
    1,000-way top, Keras's trainable count for NASNetLarge."""
    shapes = nasnet_a.shapes(CONFIG, 1000)
    with torch.device("meta"):
        spec = build_network(1000, CONFIG["architecture"])
        model = EmbeddingModel(spec.module, output="l2norm", cls_classes=1000)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(s) for k, (s, _) in shapes.items()}
    backbone = sum(torch.Size(s).numel() for n, (s, k) in shapes.items()
                   if n.startswith("backbone.") and k not in ("mean", "var"))
    assert backbone == CONFIG["parameters"] == 88_753_150


def test_220_depthwise_convs_a_forward_in_the_reference_and_the_port():
    """The reference's recorded layers at 224 px (what the benchmark counts
    operations and depthwise bounds from) and the port's counter over one
    forward on the meta device."""
    layers = counts.record_layers(nasnet_a, CONFIG, 1000, 2, 224)
    depthwise = [l for l in layers if l.get("depthwise")]
    by_kernel = {k: sum(l["k"] == k for l in depthwise) for k in (3, 5, 7)}
    assert by_kernel == {3: 116, 5: 88, 7: 16} == {
        int(k[0]): v for k, v in CONFIG["depthwise_convs"].items()}
    assert all(l["c"] == 1 for l in depthwise)
    macs = sum(l["n"] * l["h"] * l["w"] * l["f"] * l["c"] * l["k"] ** 2
               for l in layers if l["kind"] == "conv")
    macs += sum(l["n"] * l["c"] * l["f"] for l in layers
                if l["kind"] == "dense" and l["name"] == "backbone.top")
    assert macs == 2 * CONFIG["multiply_adds_224"]
    with torch.device("meta"):
        model = build_network(1000, "nasnet-a").module
    before = nasnet.depthwise_convs
    with torch.no_grad():
        model.eval()(torch.empty((1, 224, 224, 3), device="meta"))
    assert nasnet.depthwise_convs - before == 220


def test_the_reference_imports_nothing_of_the_port_or_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench.reference import nasnet_a\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert not tops & {'jax', 'jaxlib', 'flax', 'optax', 'semantic_embeddings_tpu',"
        " 'semantic_embeddings_torch'}, tops\n"
    ) % str(ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def _depthwise_record(launches):
    """A traced record of two steps whose depthwise passes launched
    ``launches`` (forward, input gradient, weight gradient) kernels a step,
    each 50 µs, beside one other kernel, over the reference's layers at
    batch 128."""
    steps, kernels = 2, {"vectorized_elementwise_kernel": {"launches": 900, "seconds": 0.2}}
    names = ("at::native::conv_depthwise2d_forward_kernel",
             "at::native::conv_depthwise2d_backward_kernel",
             "at::native::conv_depthwise2d_grad_weight_kernel")
    for name, n in zip(names, launches):
        kernels[name] = {"launches": n, "seconds": n * 50e-6}
    traces = [{"kernels": kernels, "steps": steps, "records_lost": 0}]
    return {"traces": traces, "layers": LAYERS_128, "cell": SimpleNamespace(dtype="float32")}


LAYERS_128 = counts.record_layers(nasnet_a, CONFIG, 1000, 128, 224)


@pytest.mark.parametrize("launches", [(220, 220, 219), (220, 221, 220), (0, 220, 220),
                                      (440, 440, 440)])
def test_depthwise_readers_read_nothing_at_another_launch_count(launches):
    for metric in ("depthwise_conv_roofline", "depthwise_device_ms"):
        assert harness.reader(metric)(_depthwise_record(launches)) is None


def test_depthwise_readers_at_220_launches_a_pass():
    record = _depthwise_record((220, 220, 220))
    ms = harness.reader("depthwise_device_ms")(record)
    assert ms == pytest.approx(3 * 220 * 50e-3)
    share = harness.reader("depthwise_conv_roofline")(record)
    # every pass is bound by its bytes: x, w and y (or dy, w and dx; x, dy
    # and the f32 dw) at 4 bytes over 3.35 TB/s
    layers = [l for l in LAYERS_128 if l.get("depthwise")]
    nbytes = sum(4 * l["n"] * l["f"] * (l["h"] * l["w"] + l["h_in"] * l["w_in"])
                 + 4 * l["f"] * l["k"] ** 2 for l in layers) * 3
    assert share == pytest.approx(100 * nbytes / counts.PEAK_BYTES / (ms * 1e-3))
    assert trace.kernel_seconds(record["traces"][0], ("conv_depthwise2d",))[1] == 660


def test_the_forward_opens_its_spans_in_a_profiler_session():
    """One span for the stem and one a cell, named by the cell's kind,
    only while a profiler records."""
    from torch.profiler import ProfilerActivity, profile

    from semantic_embeddings_torch import spans

    model = nasnet.NASNetA(classes=10, **SMALL).eval()
    x = torch.zeros((1, 32, 32, 3))
    with torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU]):
            model(x)
        model(x)  # outside a session: nothing recorded
    names = [s.name for s in spans.last_session().spans]
    assert names == ["nasnet.stem"] + [
        f"nasnet.{'reduction' if isinstance(getattr(model, n), nasnet.ReductionCell) else 'normal'}_cell"
        for n, _ in model.cells]
    assert names.count("nasnet.reduction_cell") == 4 and names.count("nasnet.normal_cell") == 3
