"""The system under test: the port's training step, built as its CLI's
``--fused_loss`` recipe builds it (``cli/learn_image_embeddings.py``) and
driven as ``train.trainer.fit`` drives it: the batch's indices and the
learning rate from the host, the images gathered, augmented and normalized
on the card by the dataset's ``prepare``, the metric sums kept on the card,
no read inside a step.

The benchmark hands the program its inputs (weights, images, labels, class
embedding, batches, the augmentation's generator) and takes from it only
the step's outputs, its state and its kernel launch counters.
"""

from __future__ import annotations

import gc

import torch

from . import feed


class Port:
    """One rank's train step of ``semantic_embeddings_torch`` over the
    resident data ``data`` (see :func:`.feed.make_data`), starting from
    ``weights``."""

    def __init__(self, cell, weights, data, device, seed, marks=None):
        import time

        from semantic_embeddings_torch import parallel
        from semantic_embeddings_torch.cli import common
        from semantic_embeddings_torch.data.cifar import InMemoryDataset
        from semantic_embeddings_torch.models import EmbeddingModel, build_network
        from semantic_embeddings_torch.ops import fused_cosine_loss, l2_normalize
        from semantic_embeddings_torch.train import (
            get_lr_schedule, make_train_step, new_train_state)
        from semantic_embeddings_torch.train.metrics import nn_accuracy
        from semantic_embeddings_torch.train.optimizer import effective_lr

        def mark(name):
            if marks is not None:
                marks.append((name, time.time()))

        mark("program imports")
        cfg, tr = cell.config, cell.traffic
        self.parallel, self.device = parallel, device
        common.set_float32_precision()
        classes, size = tr["classes"], tr["image_size"]
        # built on the device (its own initial draws there, then replaced):
        # no host-side draws, and none of the meta device's lazy imports
        with torch.device(device):
            spec = build_network(classes, cfg["architecture"])
            model = EmbeddingModel(spec.module, output="l2norm", cls_classes=classes,
                                   input_shape=(size, size, 3))
        model.load_state_dict(weights, strict=True)
        # the CLI's L2 rule for the softmax head, ahead of the backbone's
        spec.l2_filters = [(r"^cls_top$", 5e-4)] + list(spec.l2_filters)
        self.model, self.state = model, new_train_state(model)
        parallel.broadcast_state(model, self.state.velocity)
        mark("model")

        images = data["images"].cpu().numpy()
        labels = data["labels"].cpu().numpy()
        aug = tr["augment"] or {}
        dataset = InMemoryDataset(images, labels, images[:1], labels[:1],
                                  width_shift=aug.get("width_shift", 0.0),
                                  height_shift=aug.get("height_shift", 0.0),
                                  zoom=aug.get("zoom", 0.0), hflip=aug.get("hflip", False))
        del images
        prepare = dataset.make_prepare(device, augment_train=bool(tr["augment"]))
        mark("dataset")
        table = data["table"].cpu().numpy()
        metric = nn_accuracy(table, dot_prod_sim=True)
        self.step_fn = make_train_step(
            model.twin("linear", cls_input="l2norm"), prepare, loss_name="inv_corr",
            class_embedding=table, num_classes=classes, cls_weight=cfg["cls_weight"],
            l2_penalty_fn=spec.l2_penalty, momentum=cfg["momentum"], nesterov=False,
            clipnorm=cfg["clipnorm"],
            autocast_dtype=torch.bfloat16 if tr["dtype"] == "bfloat16" else None,
            loss_fn_override=lambda tgt, z: fused_cosine_loss(z, tgt),
            metric_fn={"emb": lambda tgt, z: metric(tgt, l2_normalize(z))})
        self.schedule, _ = get_lr_schedule(
            "SGDR", tr["steps_per_epoch"] * tr["batch"], tr["batch"],
            {"sgdr_max_lr": tr["sgdr"]["max_lr"], "sgdr_base_len": tr["sgdr"]["base_len"],
             "sgdr_mul": tr["sgdr"]["mul"]})
        self.effective_lr = effective_lr
        self.steps_per_epoch, self.decay = tr["steps_per_epoch"], tr["decay"]
        self.rng = feed.augment_generator(seed, device)
        self.sums = None
        mark("train step")

    def lr(self, k):
        """The learning rate of global step ``k`` (from 0), as ``fit`` forms
        it: the schedule's by epoch, then the time decay."""
        epoch = k // self.steps_per_epoch
        return self.effective_lr(self.schedule.lr(epoch, k), self.decay, k)

    def step(self, k, idx):
        """Global step ``k`` on the global batch of indices ``idx``: this
        rank's rows of it, as ``fit`` shards them.  Returns the metrics."""
        raw = self.parallel.shard_batch({"idx": idx})
        self.state, metrics = self.step_fn(self.state, raw, self.lr(k), self.rng)
        if self.sums is None:
            self.sums = dict(metrics)
        else:
            self.sums = {key: self.sums[key] + v for key, v in metrics.items()}
        return metrics

    def global_loss(self, metrics):
        """The step's loss over the global batch: the ranks' mean."""
        return float(self.parallel.sum_over_group(metrics["loss"]) / self.parallel.world_size())

    def first_steps(self, batches, weights, checked):
        """Steps 1 to ``checked`` (the run's first), with what the check
        compares: each step's loss, each parameter's first gradient as the
        optimizer took it (from its velocity after one step, ``-lr g``) and
        each parameter's and statistic's change after the last of them."""
        names = [n for n, _ in self.model.named_parameters()]
        losses, grads = [], {}
        for k in range(checked):
            metrics = self.step(k, batches.batch(k))
            losses.append(self.global_loss(metrics))
            if k == 0:
                norms = torch._foreach_norm(self.state.velocity)
                grads = {n: float(v) / self.lr(0) for n, v in zip(names, norms)}
        with torch.no_grad():
            change = {n: float(torch.linalg.vector_norm(t.float() - weights[n]))
                      for n, t in self.model.state_dict().items()}
        return {"losses": losses, "grads": grads, "change": change}

    def free(self):
        """Drops the program's state and returns its memory to the card."""
        self.model = self.state = self.step_fn = self.sums = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def launch_counters():
    """The program's kernel launches so far, by op."""
    from semantic_embeddings_torch.ops import conv3x3, cosine_loss

    return {"conv3x3_bn_stats": conv3x3.launches_conv_bn_stats,
            "conv3x3_filter_grad": conv3x3.launches_filter_grad,
            "cosine_loss_fwd": cosine_loss.launches_fwd,
            "cosine_loss_bwd": cosine_loss.launches_bwd}

