"""CLI: the plain softmax classifier baseline, with label smoothing.

The PyTorch counterpart of the JAX package's ``cli/learn_classifier.py``,
with the same flags plus ``--device``.  Run it as ``python -m
semantic_embeddings_torch.cli.learn_classifier``.  The model is the bare
network with a softmax ``top``; its dump rebuilds through
``cli.common.rebuild_model_from_checkpoint`` for
``evaluate_classification_accuracy``, ``export_model`` and ``serve_model``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import get_data_generator
from ..embeddings import save_features
from ..models import ARCHITECTURES, build_network
from ..train import (
    fit,
    get_lr_schedule,
    load_checkpoint,
    make_classifier_eval_step,
    make_classifier_train_step,
    run_validation,
)
from ..train.metrics import balanced_accuracy
from ..train.optimizer import decay_from_max_decay
from ..train.schedules import LR_SCHEDULES
from .. import parallel
from . import common


def build_parser():
    parser = argparse.ArgumentParser(
        description="Learns an image classifier.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    group = parser.add_argument_group("Data parameters")
    group.add_argument("--dataset", type=str, required=True)
    group.add_argument("--data_root", type=str, required=True)
    group.add_argument("--class_list", type=str, default=None,
                       help="Path to a file containing the IDs of the subset "
                            "of classes to be used (as first words per line).")
    group = parser.add_argument_group("Training parameters")
    group.add_argument("--architecture", type=str, default="simple",
                       choices=ARCHITECTURES)
    group.add_argument("--label_smoothing", type=float, default=0.0,
                       help="Smooth the target distribution by subtracting "
                            "this value from the target probability of the "
                            "ground-truth class.")
    group.add_argument("--lr_schedule", type=str, default="SGDR",
                       choices=LR_SCHEDULES)
    group.add_argument("--clipgrad", type=float, default=10.0)
    group.add_argument("--max_decay", type=float, default=0.0)
    group.add_argument("--nesterov", action="store_true", default=False)
    group.add_argument("--bf16", action="store_true", default=False,
                       help="bfloat16 compute under torch.autocast (float32 "
                            "params and batch statistics).")
    group.add_argument("--epochs", type=int, default=None)
    group.add_argument("--batch_size", type=int, default=100)
    group.add_argument("--seed", type=int, default=0,
                       help="Seed (init, shuffling, augmentation).")
    group.add_argument("--val_batch_size", type=int, default=None)
    group.add_argument("--snapshot", type=str, default=None)
    group.add_argument("--snapshot_best", type=str, nargs="?", default=None,
                       const="val_loss")
    group.add_argument("--initial_epoch", type=int, default=0)
    common.add_finetune_arguments(group, init_epochs=3)
    common.add_common_train_arguments(group)
    group = parser.add_argument_group("Output parameters")
    group.add_argument("--model_dump", type=str, default=None)
    group.add_argument("--weight_dump", type=str, default=None)
    group.add_argument("--feature_dump", type=str, default=None,
                       help="Penultimate (avg_pool) features of the test "
                            "images.")
    group.add_argument("--log_dir", type=str, default=None)
    group.add_argument("--top_k_acc", type=int, nargs="+", default=[])
    group.add_argument("--no_progress", action="store_true", default=False)
    common.add_lr_schedule_arguments(parser)
    return parser


def main(argv=None):
    """Trains as the flags say.  ``--gpus N`` > 1 with no launcher runs this
    in N spawned processes, one card each (then returns None); under a
    launcher's environment this process is one rank of the group."""
    args = build_parser().parse_args(argv)
    if common.spawn_data_parallel(args, main, argv, spatial=args.spatial):
        return None
    with common.data_parallel(args, spatial=args.spatial) as (device, _):
        return train(args, device)


def train(args, device):
    """The run on ``device``: this process's rank of a data-parallel group,
    or the whole run."""
    common.set_float32_precision()
    autocast_dtype = torch.bfloat16 if args.bf16 else None
    if args.val_batch_size is None:
        args.val_batch_size = args.batch_size

    class_list = common.read_class_list(args.class_list) if args.class_list else None
    dataset = get_data_generator(args.dataset, args.data_root, classes=class_list)
    common.apply_pipeline_args(dataset, args)
    common.check_label_range(dataset, dataset.num_classes, what="classifier")

    spec = build_network(dataset.num_classes, args.architecture, classification=True,
                         input_channels=dataset.num_channels,
                         generator=torch.Generator().manual_seed(args.seed))
    model = spec.module
    state = common.init_model_state(model, device)
    if args.snapshot and os.path.exists(args.snapshot):
        print(f"Resuming from snapshot {args.snapshot}")
        state, _ = load_checkpoint(args.snapshot, state)
    if not args.no_progress:
        common.print_model_summary(state, args.architecture)

    prepare = dataset.make_prepare(device)
    step_kwargs = dict(
        num_classes=dataset.num_classes, label_smoothing=args.label_smoothing,
        l2_penalty_fn=spec.l2_penalty, nesterov=args.nesterov, clipnorm=args.clipgrad,
        autocast_dtype=autocast_dtype)
    eval_step = make_classifier_eval_step(
        model, prepare, num_classes=dataset.num_classes,
        label_smoothing=args.label_smoothing, l2_penalty_fn=spec.l2_penalty,
        autocast_dtype=autocast_dtype)

    if args.finetune:
        state = common.finetune(args, state, lambda: make_classifier_train_step(
            model, prepare, trainable_fn=lambda p: "top" in p, **step_kwargs),
            eval_step, dataset)

    schedule, num_epochs = get_lr_schedule(
        args.lr_schedule, dataset.num_train, args.batch_size,
        common.schedule_args_from(args))
    epochs = args.epochs if args.epochs else num_epochs
    decay = decay_from_max_decay(
        args.max_decay, dataset.num_train // args.batch_size, epochs)
    train_step = make_classifier_train_step(model, prepare, **step_kwargs)
    log_fn = common.metrics_logger(args)
    meta = {"architecture": args.architecture, "cls_classes": dataset.num_classes}

    state = fit(
        state, train_step, eval_step, dataset, schedule,
        epochs=epochs, batch_size=args.batch_size,
        val_batch_size=args.val_batch_size, initial_epoch=args.initial_epoch,
        decay=decay, seed=args.seed, snapshot=args.snapshot,
        snapshot_best=args.snapshot_best, verbose=not args.no_progress,
        log_fn=log_fn, snapshot_meta=meta)

    final = run_validation(eval_step, state,
                          dataset.test_batches(args.val_batch_size, **common.sharded()),
                           None)
    preds = final.pop("predictions", None)
    print({k: round(float(v), 6) for k, v in final.items()})
    if preds is not None:
        avg = balanced_accuracy(preds[: dataset.num_test],
                                np.asarray(dataset.labels_test), dataset.num_classes)
        print(f"Average Accuracy: {avg:.4f}")

    # the feature dump holds the penultimate features: the avg_pool tap
    if args.feature_dump:
        features = common.extract_by_tap(
            model, dataset.make_prepare(device), dataset.test_batches(args.val_batch_size),
            device, layer="avg_pool", autocast_dtype=autocast_dtype)
        if parallel.is_main():
            save_features(args.feature_dump, features)
        args.feature_dump = None
    common.dump_artifacts(args, state, model, dataset, device, meta=meta)
    return state


if __name__ == "__main__":
    main()
