"""CLI: learn to map images onto semantic class embeddings (main trainer).

The PyTorch counterpart of the JAX package's
``cli/learn_image_embeddings.py``, with the same flags plus ``--device``.
Run it as ``python -m semantic_embeddings_torch.cli.learn_image_embeddings``.
With ``--fused_loss`` the cosine loss runs through the hand-written CUDA
kernel pair of :mod:`semantic_embeddings_torch.ops.cosine_loss`.
``--finetune`` first trains only the ``top`` layers for ``--finetune_init``
epochs from weights loaded by name, then the whole model.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import get_data_generator
from ..models import ARCHITECTURES
from ..ops import fused_cosine_loss, l2_normalize
from ..train import (
    fit,
    get_lr_schedule,
    load_checkpoint,
    make_eval_step,
    make_train_step,
    run_validation,
)
from ..train.metrics import balanced_accuracy, nn_accuracy
from ..train.optimizer import decay_from_max_decay
from ..train.schedules import LR_SCHEDULES
from . import common

def build_parser():
    parser = argparse.ArgumentParser(
        description="Learns to map images onto class embeddings.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    group = parser.add_argument_group("Data parameters")
    group.add_argument("--dataset", type=str, required=True,
                       help="Training dataset. See README.md for a list of "
                            "available datasets.")
    group.add_argument("--data_root", type=str, required=True,
                       help="Root directory of the dataset.")
    group.add_argument("--embedding", type=str, required=True,
                       help="Path to a pickle dump of embeddings generated by "
                            "compute_class_embeddings.py. The special value "
                            '"onehot" may be used to generate one-hot '
                            "embeddings on the fly.")
    group = parser.add_argument_group("Training parameters")
    group.add_argument("--architecture", type=str, default="simple",
                       choices=ARCHITECTURES,
                       help="Type of network architecture.")
    group.add_argument("--loss", type=str, default="inv_corr",
                       choices=["mse", "inv_corr", "unnorm_corr", "softmax_corr"],
                       help='Loss function for learning embeddings. Use "mse" '
                            "(mean squared error) for distance-based and "
                            '"inv_corr" (negated dot product) for similarity-'
                            "based L2-normalized embeddings.")
    group.add_argument("--cls_weight", type=float, default=0.0,
                       help="If set to a positive value, an additional "
                            "classification layer will be added and this "
                            "parameter specifies the weight of the softmax loss.")
    group.add_argument("--cls_base", type=str, default=None,
                       help="Name of the backbone module whose output the "
                            "classification head should be based on (a full "
                            "module path such as stage3_block5/conv_b, a "
                            "unique trailing part of it, or a module name "
                            "such as top); the embedding if not given.")
    group.add_argument("--lr_schedule", type=str, default="SGDR",
                       choices=LR_SCHEDULES, help="Type of learning rate schedule.")
    group.add_argument("--clipgrad", type=float, default=10.0,
                       help="Gradient norm clipping.")
    group.add_argument("--max_decay", type=float, default=0.0,
                       help="Learning Rate decay at the end of training.")
    group.add_argument("--nesterov", action="store_true", default=False,
                       help="Use Nesterov momentum instead of standard momentum.")
    group.add_argument("--remat", action="store_true", default=False,
                       help="Recompute the residual blocks' activations in "
                            "the backward pass instead of keeping them "
                            "(the CIFAR and ImageNet ResNets): less memory "
                            "for large inputs, one more forward a step.")
    group.add_argument("--bf16", action="store_true", default=False,
                       help="bfloat16 compute under torch.autocast (float32 "
                            "params and batch statistics).")
    group.add_argument("--fused_loss", action="store_true", default=False,
                       help="Use the fused normalize+dot cosine-loss CUDA "
                            "kernel pair in the train step.")
    group.add_argument("--epochs", type=int, default=None,
                       help="Number of training epochs.")
    group.add_argument("--batch_size", type=int, default=100, help="Batch size.")
    group.add_argument("--seed", type=int, default=0,
                       help="Seed (init, shuffling, augmentation).")
    group.add_argument("--val_batch_size", type=int, default=None,
                       help="Validation batch size.")
    group.add_argument("--snapshot", type=str, default=None,
                       help="Path where snapshots should be stored after every "
                            "epoch. If existing, it will be used to resume training.")
    group.add_argument("--snapshot_best", type=str, nargs="?", default=None,
                       const="val_loss",
                       help="Only store best-performing model as checkpoint, "
                            "identified by monitoring the specified metric.")
    group.add_argument("--initial_epoch", type=int, default=0,
                       help="Initial epoch for resuming training from snapshot.")
    common.add_finetune_arguments(group, init_epochs=8)
    common.add_common_train_arguments(group)
    group = parser.add_argument_group("Output parameters")
    group.add_argument("--model_dump", type=str, default=None,
                       help="Filename where the learned model definition and "
                            "weights should be written to.")
    group.add_argument("--weight_dump", type=str, default=None,
                       help="Filename where the learned model weights should "
                            "be written to (without model definition).")
    group.add_argument("--feature_dump", type=str, default=None,
                       help="Filename where learned embeddings for test images "
                            "should be written to.")
    group.add_argument("--log_dir", type=str, default=None,
                       help="Metrics log directory (JSONL).")
    group.add_argument("--profile_dir", type=str, default=None,
                       help="Write a torch.profiler trace (CPU and CUDA "
                            "activity) of steady-state training steps to this "
                            "directory, one file a rank.")
    group.add_argument("--no_progress", action="store_true", default=False,
                       help="Do not display training progress, but just the "
                            "final performance.")
    group.add_argument("--top_k_acc", type=int, nargs="+", default=[],
                       help="If given, top k accuracy will be reported in "
                            "addition to top 1 accuracy.")
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

    # Class embeddings ('onehot' -> identity).
    embed_labels, embedding = common.load_class_embedding(args.embedding)
    dataset = get_data_generator(args.dataset, args.data_root, classes=embed_labels)
    common.apply_pipeline_args(dataset, args)
    if embedding is None:
        embedding = np.eye(dataset.num_classes, dtype=np.float32)

    common.check_label_range(dataset, embedding.shape[0])
    cls_classes = dataset.num_classes if args.cls_weight > 0 else 0
    if cls_classes:
        common.check_label_range(dataset, cls_classes, what="classification head")

    model, spec = common.build_embedding_model(
        embedding.shape[1], args.architecture, args.loss, cls_classes,
        input_channels=dataset.num_channels, seed=args.seed, remat=args.remat,
        cls_base=args.cls_base)
    state = common.init_model_state(model, device)
    if args.snapshot and os.path.exists(args.snapshot):
        print(f"Resuming from snapshot {args.snapshot}")
        state, _ = load_checkpoint(args.snapshot, state)
    if not args.no_progress:
        common.print_model_summary(state, args.architecture)

    # L2 regularization: backbone filters + cls head at 5e-4, PREPENDED:
    # the filter list is first-match-wins, so the specific cls_top rule
    # must come before the backbone catch-all (r'.*', 2e-4).
    if cls_classes:
        spec.l2_filters = [(r"^cls_top$", 5e-4)] + list(spec.l2_filters)

    prepare = dataset.make_prepare(device)
    dot_sim = args.loss.endswith("_corr")
    metrics_dict = {"emb": nn_accuracy(embedding, dot_prod_sim=dot_sim)}
    for k in args.top_k_acc:
        metrics_dict[f"emb_top{k}"] = nn_accuracy(
            embedding, dot_prod_sim=dot_sim, k=k)

    # For the cosine loss, train through the fused kernel pair: the training
    # model emits raw embeddings and the kernels own normalization forward
    # and backward.  It shares every parameter with the l2norm-output model
    # that the eval and feature paths use.
    train_model = model
    train_overrides = {"metric_fn": metrics_dict}
    if args.loss == "inv_corr" and args.fused_loss:
        train_model = model.twin("linear", cls_input="l2norm")
        train_overrides = dict(
            loss_fn_override=lambda tgt, z: fused_cosine_loss(z, tgt),
            metric_fn={
                name: (lambda fn: lambda tgt, z: fn(tgt, l2_normalize(z)))(fn)
                for name, fn in metrics_dict.items()
            },
        )

    step_kwargs = dict(
        loss_name=args.loss,
        class_embedding=embedding,
        num_classes=dataset.num_classes,
        cls_weight=args.cls_weight,
        l2_penalty_fn=spec.l2_penalty,
        momentum=0.9,
        nesterov=args.nesterov,
        clipnorm=args.clipgrad,
        autocast_dtype=autocast_dtype,
    )
    eval_step = make_eval_step(
        model, prepare, loss_name=args.loss, class_embedding=embedding,
        num_classes=dataset.num_classes, cls_weight=args.cls_weight,
        metric_fn=metrics_dict, l2_penalty_fn=spec.l2_penalty,
        autocast_dtype=autocast_dtype,
    )

    if args.finetune:
        # the warm-up trains only the layers the reference names embedding
        # and prob: the backbone's and the head's tops
        state = common.finetune(args, state, lambda: make_train_step(
            train_model, prepare, trainable_fn=lambda p: "top" in p, **step_kwargs,
            **train_overrides), eval_step, dataset)

    schedule, num_epochs = get_lr_schedule(
        args.lr_schedule, dataset.num_train, args.batch_size,
        common.schedule_args_from(args))
    epochs = args.epochs if args.epochs else num_epochs
    decay = decay_from_max_decay(
        args.max_decay, dataset.num_train // args.batch_size, epochs)

    train_step = make_train_step(
        train_model, prepare, **step_kwargs, **train_overrides)
    log_fn = common.metrics_logger(args)

    state = fit(
        state, train_step, eval_step, dataset, schedule,
        epochs=epochs, batch_size=args.batch_size,
        val_batch_size=args.val_batch_size, initial_epoch=args.initial_epoch,
        decay=decay, seed=args.seed, snapshot=args.snapshot,
        snapshot_best=args.snapshot_best, verbose=not args.no_progress,
        log_fn=log_fn, profile_dir=args.profile_dir,
        snapshot_meta={
            "architecture": args.architecture,
            "embed_dim": int(embedding.shape[1]),
            "loss": args.loss,
            "cls_classes": cls_classes,
            "cls_base": args.cls_base,
        },
    )

    # Final evaluation.
    final = run_validation(
        eval_step, state, dataset.test_batches(args.val_batch_size, **common.sharded()), None)
    preds = final.pop("predictions", None)
    print({k: round(float(v), 6) for k, v in final.items()})
    if args.cls_weight > 0 and preds is not None:
        avg = balanced_accuracy(
            preds[: dataset.num_test], np.asarray(dataset.labels_test),
            dataset.num_classes)
        print(f"Average Accuracy: {avg:.4f}")
    dumped_feats = None
    if args.cls_weight <= 0 and args.embedding == "onehot":
        dumped_feats = common.extract_test_features(
            model, dataset, device, args.val_batch_size,
            autocast_dtype=autocast_dtype)
        preds = dumped_feats.argmax(axis=-1)
        avg = balanced_accuracy(
            preds, np.asarray(dataset.labels_test), dataset.num_classes)
        print(f"Average Accuracy: {avg:.4f}")

    common.dump_artifacts(
        args, state, model, dataset, device, args.cls_weight,
        features=dumped_feats, autocast_dtype=autocast_dtype,
        meta={
            "embed_dim": int(embedding.shape[1]),
            "loss": args.loss,
            "cls_classes": cls_classes,
            "cls_base": args.cls_base,
        },
    )
    return state


if __name__ == "__main__":
    main()
