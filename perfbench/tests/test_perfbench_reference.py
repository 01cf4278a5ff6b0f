"""The plain reference agrees with the port on the CPU: three training
steps in float64 at a small size (the same weights, batches and learning
rates), and the input pipeline (normalization, the random shift and flip)
in float32."""

import math

import numpy as np
import pytest
import torch

from perfbench import feed, harness
from perfbench.reference import plain

STEPS = 3


def _cell(config, traffic, **sizes):
    """A cell of ``configs/<config>.json`` under ``traffic/<traffic>.json``
    with ``sizes`` changed (it need not be one of BENCHMARK.json's)."""
    import importlib
    import json

    config = json.loads((harness.HERE / "configs" / f"{config}.json").read_text())
    traffic = json.loads((harness.HERE / "traffic" / f"{traffic}.json").read_text())
    reference = importlib.import_module(f"perfbench.reference.{config['reference']}")
    return harness.Cell("test", 1, config, dict(traffic, **sizes), {}, {}, reference)


def _port_steps(cell, weights, images, labels, table, lrs):
    """The port's train step (the CLI's --fused_loss recipe) in float64,
    fed the prepared images directly."""
    from semantic_embeddings_torch.models import EmbeddingModel, build_network
    from semantic_embeddings_torch.ops import fused_cosine_loss
    from semantic_embeddings_torch.train import make_train_step, new_train_state

    classes = table.shape[0]
    with torch.device("meta"):
        spec = build_network(classes, cell.config["architecture"])
        model = EmbeddingModel(spec.module, output="l2norm", cls_classes=classes)
    model = model.to_empty(device="cpu").double()
    model.load_state_dict(weights)
    spec.l2_filters = [(r"^cls_top$", 5e-4)] + list(spec.l2_filters)
    state = new_train_state(model)
    step = make_train_step(
        model.twin("linear", cls_input="l2norm"),
        lambda raw, rng, train: (images[raw["idx"]], labels[raw["idx"]]),
        class_embedding=table.numpy(), num_classes=classes,
        cls_weight=cell.config["cls_weight"], l2_penalty_fn=spec.l2_penalty,
        clipnorm=cell.config["clipnorm"], momentum=cell.config["momentum"],
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


@pytest.mark.parametrize("config,traffic,size", [("resnet50", "i224-f32-b128", 64),
                                                 ("resnet110wfc", "c100-f32-b100", 16)])
def test_three_steps_agree_in_float64(config, traffic, size):
    batch, classes = 4, 10
    cell = _cell(config, traffic, image_size=size, classes=classes, batch=batch,
                 resident_images=STEPS * batch)
    cpu = torch.device("cpu")
    shapes = cell.reference.shapes(cell.config, classes)
    weights = {k: v.double() for k, v in feed.make_weights(shapes, 2**31 + 7, cpu).items()}
    gen = torch.Generator().manual_seed(3)
    images = torch.randn((STEPS * batch, size, size, 3), generator=gen, dtype=torch.float64)
    labels = torch.randint(0, classes, (STEPS * batch,), generator=gen)
    table = torch.randn((classes, classes), generator=gen, dtype=torch.float64)
    # the port holds the class embedding in f32: give both sides f32 values
    table = (table / table.norm(dim=1, keepdim=True)).float().double()
    lrs = [plain.sgdr_lr(k, 10, 0.5, 12, 2, 1e-3) for k in range(STEPS)]

    losses, grads, after = _port_steps(cell, weights, images, labels, table, lrs)

    params = {n: w.clone().requires_grad_() for n, w in weights.items()
              if shapes[n][1] not in ("mean", "var")}
    stats = {n: w.clone() for n, w in weights.items() if shapes[n][1] in ("mean", "var")}
    velocity = {n: torch.zeros_like(p) for n, p in params.items()}
    ops = plain.Ops("f32")
    for k in range(STEPS):
        rows = slice(k * batch, (k + 1) * batch)
        loss, clipped = plain.train_step(cell.reference, ops, params, stats, velocity,
                                         images[rows], labels[rows], table, lrs[k], cell.config)
        assert math.isclose(float(loss), losses[k], rel_tol=1e-10)
        if k == 0:
            for n, g in clipped.items():
                torch.testing.assert_close(grads[n], g, rtol=1e-8, atol=1e-12)
    for n, t in {**params, **stats}.items():
        torch.testing.assert_close(after[n], t.detach(), rtol=1e-8, atol=1e-12)


def test_pipeline_agrees_with_the_ports():
    """The dataset's statistics, and the shift and flip drawn from one
    generator seed, as the port's ``make_prepare`` computes them."""
    from semantic_embeddings_torch.data.cifar import InMemoryDataset

    cell = _cell("resnet110wfc", "c100-f32-b100", resident_images=64)
    tr, cpu = cell.traffic, torch.device("cpu")
    data = feed.make_data(tr, 2**31 + 11, cpu)
    x, y = data["images"].numpy(), data["labels"].numpy()
    aug = tr["augment"]
    ds = InMemoryDataset(x, y, x[:1], y[:1], width_shift=aug["width_shift"],
                         height_shift=aug["height_shift"], zoom=aug["zoom"], hflip=aug["hflip"])
    prepare = ds.make_prepare(cpu)
    idx = np.arange(8, 40, dtype=np.int32)
    got, labels = prepare({"idx": idx}, feed.augment_generator(5, cpu), True)
    mean, std = plain.channel_moments(data["images"])
    torch.testing.assert_close(mean, torch.as_tensor(ds.mean), rtol=1e-6, atol=0)
    torch.testing.assert_close(std, torch.as_tensor(ds.std), rtol=1e-6, atol=0)
    want = plain.shift_flip(data["images"][torch.as_tensor(idx).long()].float(),
                            feed.augment_generator(5, cpu), aug["height_shift"],
                            aug["width_shift"], aug["hflip"])
    torch.testing.assert_close(got, (want - mean) / std, rtol=1e-5, atol=1e-4)
    assert torch.equal(labels, data["labels"][torch.as_tensor(idx).long()])
