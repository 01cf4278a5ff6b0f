"""The training engine: step builders and the epoch-driving fit loop
(counterpart of the JAX package's ``train/trainer.py``).

One train step runs on the device from end to end: the dataset's
``prepare`` gathers, augments and normalizes the batch, then the forward
pass, the loss (with the Keras L2 kernel penalty), the backward pass and the
Keras-exact SGD update follow.  Only the batch's indices and the scalar
learning rate come from the host.  Metrics stay on the device and are
fetched once per epoch, so no step waits for the host.

Under a spatial grid (``--spatial``, :mod:`..parallel.spatial`) every step
cuts its prepared images to this rank's rows right after ``prepare``
(:func:`..parallel.constrain_spatial`), as the JAX steps constrain them.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .. import parallel
from ..data.cifar import to_device
from . import losses as L
from .optimizer import adagrad_update, effective_lr, sgd_update
from .state import TrainState, save_checkpoint

EMB_LOSSES = {
    "mse": L.squared_distance,
    "inv_corr": L.inv_correlation,
    "unnorm_corr": L.inv_correlation,
    "softmax_corr": L.inv_correlation,
}

#: output transform the EmbeddingModel applies for each loss
LOSS_OUTPUT = {
    "mse": "linear",
    "inv_corr": "l2norm",
    "unnorm_corr": "linear",
    "softmax_corr": "softmax",
}


def maybe_autocast(device, dtype):
    """``torch.autocast`` to ``dtype`` on ``device``, or nothing for None."""
    if dtype is None:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=dtype)


def _device_of(model):
    return next(model.parameters()).device


def _class_table(class_embedding, device):
    if class_embedding is None:
        return None
    return torch.as_tensor(
        np.asarray(class_embedding, dtype=np.float32), device=device)


def _apply_metric_fns(metric_fn, targets, emb_out, reduce):
    """``{name: reduce(fn(targets, emb_out))}`` for a dict of per-sample
    metric functions (or None)."""
    return {name: reduce(fn(targets, emb_out))
            for name, fn in (metric_fn or {}).items()}


def trainable_indices(model, trainable_fn=None):
    """Indices into ``model.parameters()`` of the parameters a step trains:
    every one, or those whose path (``/``-joined module path and name, as
    the JAX tree's: ``backbone/top/weight``) ``trainable_fn`` accepts."""
    names = [n.replace(".", "/") for n, _ in model.named_parameters()]
    return [i for i, n in enumerate(names) if trainable_fn is None or trainable_fn(n)]


def finish_step(state, total, trained, lr, *, optimizer="sgd", momentum=0.9,
                nesterov=False, clipnorm=10.0):
    """The step tail every learner shares: the gradients of ``total`` with
    respect to the parameters at the indices ``trained`` only, then Keras
    SGD (per-tensor clip, momentum) or Keras Adagrad (no clip, as in the
    JAX package) on those in place.  A parameter left out, and its
    velocity, stay bitwise as they were and take no L2 penalty (the JAX
    package's ``trainable_fn`` mask, which zeroes their gradients);
    BatchNorm running statistics move in the forward all the same (Keras
    2.2's frozen-BN semantics).  In a process group the gradients are the
    group's mean (:func:`..parallel.reduce_gradients`), clipped after it is
    formed, as the JAX package clips the global batch's gradient.

    Under a spatial grid of S columns the S ranks of a data shard compute
    the same loss of the same images after the global pool, so each
    differentiates 1 / S of it: summed over every rank and divided by the
    data shards, the gradients are the global batch's (the rule of
    :mod:`..parallel.spatial`)."""
    state.step += 1
    if not trained:  # nothing to train (a warm-up of a model with no top)
        return
    params = state.params
    params = [params[i] for i in trained]
    slots = [state.velocity[i] for i in trained]
    columns = parallel.spatial_size()
    if columns > 1:
        total = total / columns
    grads = list(torch.autograd.grad(total, params))
    # in a process group: the global batch's gradient, before the clip
    parallel.reduce_gradients(grads)
    if optimizer == "adagrad":
        adagrad_update(params, slots, grads, lr)
    else:
        sgd_update(params, slots, grads, lr, momentum=momentum, nesterov=nesterov,
                   clipnorm=clipnorm)


def make_train_step(
    model,
    prepare: Callable,
    *,
    loss_name: str = "inv_corr",
    class_embedding=None,
    cls_weight: float = 0.0,
    l2_penalty_fn: Callable | None = None,
    momentum: float = 0.9,
    nesterov: bool = False,
    clipnorm: float = 10.0,
    metric_fn=None,
    loss_fn_override: Callable | None = None,
    num_classes: int | None = None,
    autocast_dtype=None,
    trainable_fn: Callable | None = None,
    optimizer: str = "sgd",
):
    """Builds the train step ``step(state, raw_batch, lr, rng)``.

    ``model`` runs the forward pass; it holds the parameters of
    ``state.model`` (it is that model, or a :meth:`EmbeddingModel.twin` of
    it).  ``prepare(raw_batch, rng, train)`` returns ``(images, labels)``
    on the device; ``class_embedding`` (n_classes, d) gives the per-sample
    targets by a gather on the device.  ``metric_fn``: a dict of per-sample
    metrics ``(targets, emb_out) -> (B,)``.  ``loss_fn_override``: per-sample
    loss ``(targets, emb_out) -> (B,)`` replacing the named loss.
    ``l2_penalty_fn(model)`` adds the kernel penalty to the loss, so its
    gradient is in ``g`` before the per-tensor clip.  ``autocast_dtype``
    (``torch.bfloat16`` for ``--bf16``) runs the forward under autocast.
    ``trainable_fn(path) -> bool`` picks the parameters the step trains
    (:func:`finish_step`); ``optimizer``: ``'sgd'`` (Keras-exact) or
    ``'adagrad'`` (DeViSE), whose accumulators take the velocity's place.
    """
    if optimizer not in ("sgd", "adagrad"):
        raise ValueError(f"optimizer must be 'sgd' or 'adagrad', not {optimizer!r}")
    emb_loss = loss_fn_override or EMB_LOSSES[loss_name]
    device = _device_of(model)
    table = _class_table(class_embedding, device)
    if num_classes is None and table is not None:
        num_classes = table.shape[0]
    trained = trainable_indices(model, trainable_fn)

    def step(state: TrainState, raw_batch, lr, rng):
        images, labels = prepare(raw_batch, rng, True)
        images = parallel.constrain_spatial(images)
        targets = table[labels]
        model.train()
        with maybe_autocast(device, autocast_dtype):
            out = model(images)
        metrics = {}
        if cls_weight > 0:
            emb_out, prob = out
            onehot = F.one_hot(labels, num_classes).float()
            cls_l = L.categorical_crossentropy(onehot, prob).mean()
            metrics["cls_loss"] = cls_l.detach()
            metrics["cls_acc"] = (
                torch.argmax(prob, -1) == labels).float().mean()
        else:
            emb_out, cls_l = out, 0.0
        e_l = emb_loss(targets, emb_out).mean()
        total = e_l + cls_weight * cls_l
        if l2_penalty_fn is not None:
            total = total + l2_penalty_fn(model)
        metrics["emb_loss"] = e_l.detach()
        metrics["loss"] = total.detach()
        with torch.no_grad():
            metrics.update(_apply_metric_fns(
                metric_fn, targets, emb_out.detach(), lambda v: v.mean()))

        finish_step(state, total, trained, lr, optimizer=optimizer, momentum=momentum,
                    nesterov=nesterov, clipnorm=clipnorm)
        return state, metrics

    return step


def make_eval_step(
    model,
    prepare: Callable,
    *,
    loss_name: str = "inv_corr",
    class_embedding=None,
    cls_weight: float = 0.0,
    metric_fn=None,
    loss_fn_override: Callable | None = None,
    num_classes: int | None = None,
    l2_penalty_fn: Callable | None = None,
    autocast_dtype=None,
):
    """Validation step ``step(state, raw_batch, rng)``: running BN stats, no
    update; returns summed metrics and the batch's count of valid rows, so
    padded final batches average correctly."""
    emb_loss = loss_fn_override or EMB_LOSSES[loss_name]
    device = _device_of(model)
    table = _class_table(class_embedding, device)
    if num_classes is None and table is not None:
        num_classes = table.shape[0]

    @torch.no_grad()
    def step(state: TrainState, raw_batch, rng):
        images, labels = prepare(raw_batch, rng, False)
        images = parallel.constrain_spatial(images)
        mask = valid_mask(raw_batch, images.shape[0], device)
        targets = table[labels]
        model.eval()
        with maybe_autocast(device, autocast_dtype):
            out = model(images)
        metrics = {}
        if cls_weight > 0:
            emb_out, prob = out
            onehot = F.one_hot(labels, num_classes).float()
            metrics["cls_loss"] = (
                L.categorical_crossentropy(onehot, prob) * mask).sum()
            metrics["cls_correct"] = (
                (torch.argmax(prob, -1) == labels).float() * mask).sum()
            metrics["pred"] = torch.argmax(prob, -1)
        else:
            emb_out = out
        metrics["emb_loss"] = (emb_loss(targets, emb_out) * mask).sum()
        # Monitored total: embedding loss + weighted CE + the L2 penalty
        # times the count, so that the per-count mean gains it once (Keras
        # folds model.losses into val_loss).
        metrics["total_loss"] = metrics["emb_loss"] + cls_weight * metrics.get(
            "cls_loss", 0.0)
        if l2_penalty_fn is not None:
            metrics["total_loss"] = metrics["total_loss"] + (
                l2_penalty_fn(model) * mask.sum())
        correct = _apply_metric_fns(
            metric_fn, targets, emb_out, lambda v: (v * mask).sum())
        metrics.update({f"{k}_correct": v for k, v in correct.items()})
        metrics["count"] = mask.sum()
        return metrics

    return step


def valid_mask(raw_batch, n, device):
    """The batch's ``valid`` rows as 0/1 floats on ``device`` (padded final
    batches), or ``n`` ones."""
    valid = raw_batch.get("valid")
    if valid is None:
        return torch.ones(n, device=device)
    return to_device(np.asarray(valid, dtype=np.float32), device)


def make_classifier_train_step(
    model,
    prepare: Callable,
    *,
    num_classes: int,
    label_smoothing: float = 0.0,
    l2_penalty_fn: Callable | None = None,
    momentum: float = 0.9,
    nesterov: bool = False,
    clipnorm: float = 10.0,
    trainable_fn: Callable | None = None,
    autocast_dtype=None,
):
    """The plain softmax classifier's train step (``learn_classifier``):
    Keras cross-entropy on the model's softmax output against the one-hot
    labels, smoothed by ``label_smoothing``."""
    trained = trainable_indices(model, trainable_fn)
    device = _device_of(model)

    def step(state: TrainState, raw_batch, lr, rng):
        images, labels = prepare(raw_batch, rng, True)
        images = parallel.constrain_spatial(images)
        onehot = L.label_smoothing(F.one_hot(labels, num_classes).float(), label_smoothing)
        model.train()
        with maybe_autocast(device, autocast_dtype):
            prob = model(images)
        ce = L.categorical_crossentropy(onehot, prob).mean()
        total = ce
        if l2_penalty_fn is not None:
            total = total + l2_penalty_fn(model)
        metrics = {"loss": total.detach(), "ce": ce.detach(),
                   "acc": (torch.argmax(prob, -1) == labels).float().mean()}
        finish_step(state, total, trained, lr, momentum=momentum, nesterov=nesterov,
                    clipnorm=clipnorm)
        return state, metrics

    return step


def make_classifier_eval_step(
    model,
    prepare: Callable,
    *,
    num_classes: int,
    label_smoothing: float = 0.0,
    l2_penalty_fn: Callable | None = None,
    autocast_dtype=None,
):
    """The classifier's validation step: summed smoothed cross-entropy and
    correct predictions over the batch's valid rows, and the predictions."""
    device = _device_of(model)

    @torch.no_grad()
    def step(state: TrainState, raw_batch, rng):
        images, labels = prepare(raw_batch, rng, False)
        images = parallel.constrain_spatial(images)
        mask = valid_mask(raw_batch, images.shape[0], device)
        onehot = L.label_smoothing(F.one_hot(labels, num_classes).float(), label_smoothing)
        model.eval()
        with maybe_autocast(device, autocast_dtype):
            prob = model(images)
        out = {
            "emb_loss": (L.categorical_crossentropy(onehot, prob) * mask).sum(),
            "cls_correct": ((torch.argmax(prob, -1) == labels).float() * mask).sum(),
            "pred": torch.argmax(prob, -1),
            "count": mask.sum(),
        }
        # Keras folds the L2 kernel penalty into val_loss (see make_eval_step)
        if l2_penalty_fn is not None:
            out["total_loss"] = out["emb_loss"] + l2_penalty_fn(model) * mask.sum()
        return out

    return step


def run_validation(eval_step, state, batches, rng):
    """Drives the eval step over an iterator of raw batches; sums on the
    device and fetches once.  In a process group each rank evaluates its
    rows of every batch (:func:`..parallel.shard_batch`, with their
    ``valid`` mask), the sums are added over the group once, and the
    predictions are gathered batch by batch."""
    pending, rows = [], []
    for raw in batches:
        raw = parallel.shard_batch(raw)
        pending.append(eval_step(state, raw, rng))
        rows.append(raw.get("rows"))
    preds = [m.pop("pred") for m in pending if "pred" in m]
    if preds and parallel.data_size() > 1:
        preds = [parallel.gather_rows(p, n, start)
                 for p, (start, _, n) in zip(preds, rows)]
    keys = list(pending[0]) if pending else []
    sums = parallel.sum_over_group(torch.stack([
        torch.stack([torch.as_tensor(m[k], dtype=torch.float32) for m in pending]
                    ).sum() for k in keys
    ])).cpu().tolist() if keys else []
    totals = dict(zip(keys, sums))
    count = max(totals.pop("count", 1.0), 1.0)
    out = {}
    for k, v in totals.items():
        if k.endswith("_correct"):
            out[k.replace("_correct", "_acc")] = v / count
        else:
            out[k] = v / count
    out["val_loss"] = out.get("total_loss", out.get("emb_loss", 0.0))
    out.pop("total_loss", None)
    if preds:
        out["predictions"] = torch.cat(preds).cpu().numpy()
    return out


def fit(
    state: TrainState,
    train_step,
    eval_step,
    dataset,
    schedule,
    *,
    epochs: int,
    batch_size: int,
    val_batch_size: int | None = None,
    initial_epoch: int = 0,
    decay: float = 0.0,
    seed: int = 0,
    snapshot: str | None = None,
    snapshot_best: str | None = None,
    verbose: bool = True,
    log_fn=None,
    profile_dir: str | None = None,
    profile_steps=(10, 30),
    snapshot_meta: dict | None = None,
):
    """Epoch loop with schedule driving, validation, and snapshotting.

    ``dataset`` provides ``train_batches(batch_size, epoch, seed)``,
    ``test_batches(batch_size)`` and ``steps_per_epoch(batch_size)``.  One
    ``torch.Generator`` on the model's device, seeded from ``seed``, draws
    the augmentation of every step.

    In a process group of W ranks every rank starts from rank 0's state,
    takes its rows of every global batch (``shard=True``: the augmentation
    is drawn for the whole batch from the shared generator and applied to
    these rows), and the epoch's metric sums are added over the group once
    an epoch; snapshots, the progress line and ``log_fn`` are rank 0's.

    ``profile_dir``: a ``torch.profiler`` trace of CPU and CUDA activity
    over the steps ``profile_steps`` = [start, stop) counted from this
    run's first step (so a run resumed past the window still profiles),
    one Chrome trace file a rank (``trace_rank{r}.json``), with the JAX
    package's messages: "Wrote device trace to ..." when the window closes
    or the run ends inside it, a ``RuntimeWarning`` when the run ends
    before it opens.
    """
    val_batch_size = val_batch_size or batch_size
    device = _device_of(state.model)
    world = parallel.world_size()
    sharded = {"shard": True} if world > 1 else {}
    main = parallel.is_main()
    parallel.broadcast_state(state.model, state.velocity)
    rng = torch.Generator(device=device)
    rng.manual_seed(seed)
    # Keras ModelCheckpoint(mode='auto'): metrics whose name contains 'acc'
    # or starts with 'fmeasure' are maximized, everything else minimized.
    maximize = snapshot_best is not None and (
        "acc" in snapshot_best or snapshot_best.startswith("fmeasure"))
    best_metric = -np.inf if maximize else np.inf
    steps_per_epoch = dataset.steps_per_epoch(batch_size)
    global_step = int(state.step)
    start_step = global_step
    profiler = None

    for epoch in range(initial_epoch, epochs):
        t0 = time.time()
        epoch_lr = schedule.lr(epoch, global_step)
        n_batches = 0
        metric_sums = None
        for raw in dataset.train_batches(batch_size, epoch, seed, **sharded):
            lr = schedule.lr(epoch, global_step) if schedule.per_batch else epoch_lr
            lr = effective_lr(lr, decay, global_step)
            if profile_dir is not None:
                done_steps = global_step - start_step
                if done_steps == profile_steps[0]:
                    profiler = _start_trace(device)
                elif profiler is not None and done_steps >= profile_steps[1]:
                    _stop_trace(profiler, profile_dir, device)
                    profile_dir = profiler = None
            state, metrics = train_step(state, raw, lr, rng)
            # Epoch-mean train metrics, summed on the device and fetched
            # once per epoch: reading one per step would make every step
            # wait for the device.
            if metric_sums is None:
                metric_sums = dict(metrics)
            else:
                metric_sums = {k: metric_sums[k] + v for k, v in metrics.items()}
            global_step += 1
            n_batches += 1
        train_metrics = {}
        if n_batches:
            keys = list(metric_sums)
            values = parallel.sum_over_group(
                torch.stack([metric_sums[k] for k in keys])).cpu().tolist()
            train_metrics = {k: v / (n_batches * world) for k, v in zip(keys, values)}

        val_metrics = run_validation(
            eval_step, state, dataset.test_batches(val_batch_size, **sharded), rng)
        val_metrics.pop("predictions", None)
        schedule.observe(val_metrics)
        state.epoch = epoch + 1

        if snapshot and main:
            meta = {"epoch": epoch + 1, **(snapshot_meta or {})}
            if snapshot_best:
                monitored = val_metrics.get(snapshot_best)
                if monitored is None:
                    warnings.warn(
                        f"Can save best model only with {snapshot_best} "
                        f"available, skipping.", RuntimeWarning)
                elif (monitored > best_metric if maximize
                      else monitored < best_metric):
                    best_metric = monitored
                    save_checkpoint(snapshot, state, meta)
            else:
                save_checkpoint(snapshot, state, meta)

        if verbose and main:
            msg = " ".join(
                f"{k}={v:.4f}" for k, v in {**train_metrics, **val_metrics}.items())
            print(
                f"epoch {epoch + 1}/{epochs} lr={epoch_lr:.5f} "
                f"[{time.time() - t0:.1f}s {steps_per_epoch} steps] {msg}",
                flush=True)
        if log_fn is not None and main:
            log_fn(epoch, {**train_metrics, **val_metrics, "lr": epoch_lr})

    if profiler is not None:  # runs shorter than the window keep their trace
        _stop_trace(profiler, profile_dir, device)
    elif profile_dir is not None:
        warnings.warn(
            f"--profile_dir was set but the run finished after "
            f"{global_step - start_step} steps, before the profile window "
            f"start (step {profile_steps[0]}); no trace was written. "
            f"Lower profile_steps or run more steps.",
            RuntimeWarning,
        )
    return state


def _start_trace(device):
    """A started ``torch.profiler`` session over CPU and, on a card, CUDA
    activity."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _stop_trace(profiler, profile_dir, device):
    """Ends the session once the device is done and writes this rank's
    Chrome trace into ``profile_dir``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(
        os.path.join(profile_dir, f"trace_rank{parallel.rank()}.json"))
    print(f"Wrote device trace to {profile_dir}", flush=True)
