"""Train and eval steps of the baseline learners: the label-embedding
network and the center loss (counterpart of the JAX package's
``train/special.py``).  Both use the Keras-exact SGD update of
:func:`.trainer.finish_step`.

In a process group each rank holds its rows of the global batch; the
label-embedding loss's batch-coupled counts are summed over the group, so
that every step computes what the JAX package's sharded step does.

``l2_penalty_fn(model)``: the Keras kernel penalty.  The reference's
backbones carry their per-architecture regularizers and the learners' added
heads carry none, so the learners pass a penalty scoped to the backbone.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .. import parallel
from . import losses as L
from .state import TrainState
from .trainer import finish_step, trainable_indices, valid_mask


def make_labelembed_train_step(
    model,
    prepare: Callable,
    *,
    tau=2.0,
    alpha=0.9,
    beta=0.5,
    momentum=0.9,
    nesterov=False,
    clipnorm=10.0,
    trainable_fn=None,
    l2_penalty_fn=None,
):
    """The label-embedding network's train step
    ``step(state, raw_batch, lr, rng)``: :func:`.losses.labelembed_loss`,
    averaged over the batch, plus the L2 penalty."""
    trained = trainable_indices(model, trainable_fn)

    def step(state: TrainState, raw_batch, lr, rng):
        images, labels = prepare(raw_batch, rng, True)
        model.train()
        _, out1, out2, tar = model(images, labels)
        total = L.labelembed_loss(out1, out2, tar, labels, tau=tau, alpha=alpha,
                                  beta=beta, batch_sum=parallel.sum_over_group).mean()
        if l2_penalty_fn is not None:
            total = total + l2_penalty_fn(model)
        metrics = {"loss": total.detach(),
                   "acc": (torch.argmax(out1, -1) == labels).float().mean()}
        finish_step(state, total, trained, lr, momentum=momentum, nesterov=nesterov,
                    clipnorm=clipnorm)
        return state, metrics

    return step


def make_labelembed_eval_step(model, prepare, *, tau=2.0, alpha=0.9, beta=0.5,
                              l2_penalty_fn=None):
    """Validation of the label-embedding network: the loss summed over the
    batch's valid rows (its batch-coupled term counts those rows only),
    the correct predictions of the first head, and its predictions."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(state: TrainState, raw_batch, rng):
        images, labels = prepare(raw_batch, rng, False)
        mask = valid_mask(raw_batch, images.shape[0], device)
        model.eval()
        _, out1, out2, tar = model(images, labels)
        per_sample = L.labelembed_loss(out1, out2, tar, labels, tau=tau, alpha=alpha,
                                       beta=beta, valid=mask,
                                       batch_sum=parallel.sum_over_group)
        out = {
            "emb_loss": (per_sample * mask).sum(),
            "cls_correct": ((torch.argmax(out1, -1) == labels).float() * mask).sum(),
            "pred": torch.argmax(out1, -1),
            "count": mask.sum(),
        }
        # Keras folds the L2 kernel penalty into val_loss
        if l2_penalty_fn is not None:
            out["total_loss"] = out["emb_loss"] + l2_penalty_fn(model) * mask.sum()
        return out

    return step


def make_center_loss_train_step(
    model,
    prepare: Callable,
    *,
    num_classes,
    center_loss_weight=0.1,
    momentum=0.9,
    nesterov=False,
    clipnorm=10.0,
    trainable_fn=None,
    l2_penalty_fn=None,
):
    """The center-loss learner's train step: Keras cross-entropy of the
    softmax head plus ``center_loss_weight`` times the mean center loss,
    plus the L2 penalty."""
    trained = trainable_indices(model, trainable_fn)

    def step(state: TrainState, raw_batch, lr, rng):
        images, labels = prepare(raw_batch, rng, True)
        onehot = F.one_hot(labels, num_classes).float()
        model.train()
        _, prob, center_dist = model(images, labels)
        ce = L.categorical_crossentropy(onehot, prob).mean()
        cl = center_dist.mean()
        total = ce + center_loss_weight * cl
        if l2_penalty_fn is not None:
            total = total + l2_penalty_fn(model)
        metrics = {"loss": total.detach(), "ce": ce.detach(), "center_loss": cl.detach(),
                   "acc": (torch.argmax(prob, -1) == labels).float().mean()}
        finish_step(state, total, trained, lr, momentum=momentum, nesterov=nesterov,
                    clipnorm=clipnorm)
        return state, metrics

    return step


def make_center_loss_eval_step(model, prepare, *, num_classes, center_loss_weight=0.1,
                               l2_penalty_fn=None):
    """Validation of the center-loss learner: the combined loss summed over
    the batch's valid rows, the correct predictions, and the predictions."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(state: TrainState, raw_batch, rng):
        images, labels = prepare(raw_batch, rng, False)
        mask = valid_mask(raw_batch, images.shape[0], device)
        onehot = F.one_hot(labels, num_classes).float()
        model.eval()
        _, prob, center_dist = model(images, labels)
        ce = L.categorical_crossentropy(onehot, prob)
        out = {
            "emb_loss": ((ce + center_loss_weight * center_dist) * mask).sum(),
            "cls_correct": ((torch.argmax(prob, -1) == labels).float() * mask).sum(),
            "pred": torch.argmax(prob, -1),
            "count": mask.sum(),
        }
        if l2_penalty_fn is not None:
            out["total_loss"] = out["emb_loss"] + l2_penalty_fn(model) * mask.sum()
        return out

    return step
