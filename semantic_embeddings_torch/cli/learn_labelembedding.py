"""CLI: the label-embedding network baseline (Sun et al.).

The PyTorch counterpart of the JAX package's ``cli/learn_labelembedding.py``,
with the same flags plus ``--device``.  Run it as ``python -m
semantic_embeddings_torch.cli.learn_labelembedding``.  The feature dump
holds the backbone's embeddings; the model dump records ``learner:
labelembed`` so that it rebuilds as a :class:`..models.LabelEmbedModel`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data import get_data_generator
from ..models import ARCHITECTURES, LabelEmbedModel, build_network
from ..train import fit, get_lr_schedule, new_train_state, run_validation
from ..train.metrics import balanced_accuracy
from ..train.optimizer import decay_from_max_decay
from ..train.schedules import LR_SCHEDULES
from ..train.special import make_labelembed_eval_step, make_labelembed_train_step
from . import common

#: the layers the learner adds to the backbone (and its top): the warm-up
#: of --finetune trains these alone
HEADS = ("top", "embedding_bn", "prob_head", "out2", "labelembeddings")


def build_parser():
    parser = argparse.ArgumentParser(
        description="Trains a label embedding network (Sun et al.).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    group = parser.add_argument_group("Data parameters")
    group.add_argument("--dataset", type=str, required=True)
    group.add_argument("--data_root", type=str, required=True)
    group.add_argument("--class_list", type=str, default=None)
    group = parser.add_argument_group("Label embedding parameters")
    group.add_argument("--embed_dim", type=int, default=100,
                       help="Embedding dimensionality.")
    group.add_argument("--tau", type=float, default=2.0,
                       help="Softmax temperature.")
    group.add_argument("--alpha", type=float, default=0.9)
    group.add_argument("--beta", type=float, default=0.5)
    group = parser.add_argument_group("Training parameters")
    group.add_argument("--architecture", type=str, default="simple",
                       choices=ARCHITECTURES)
    group.add_argument("--lr_schedule", type=str, default="SGDR",
                       choices=LR_SCHEDULES)
    group.add_argument("--clipgrad", type=float, default=10.0)
    group.add_argument("--max_decay", type=float, default=0.0)
    group.add_argument("--nesterov", action="store_true", default=False)
    group.add_argument("--epochs", type=int, default=None)
    group.add_argument("--batch_size", type=int, default=100)
    group.add_argument("--val_batch_size", type=int, default=None)
    common.add_finetune_arguments(group, init_epochs=3)
    common.add_common_train_arguments(group)
    group = parser.add_argument_group("Output parameters")
    group.add_argument("--model_dump", type=str, default=None)
    group.add_argument("--weight_dump", type=str, default=None)
    group.add_argument("--feature_dump", type=str, default=None)
    group.add_argument("--log_dir", type=str, default=None)
    group.add_argument("--no_progress", action="store_true", default=False)
    common.add_lr_schedule_arguments(parser)
    return parser


def report(final, dataset, with_accuracy=True):
    """Prints the final validation metrics and, from its predictions, the
    flat and the balanced accuracy."""
    preds = final.pop("predictions", None)
    print({k: round(float(v), 6) for k, v in final.items()})
    if preds is not None:
        y = np.asarray(dataset.labels_test)
        preds = preds[: dataset.num_test]
        if with_accuracy:
            print(f"Accuracy: {np.mean(preds == y):.4f}")
        print(f"Average Accuracy: {balanced_accuracy(preds, y, dataset.num_classes):.4f}")


def main(argv=None):
    """Trains as the flags say.  ``--gpus N`` > 1 with no launcher runs this
    in N spawned processes, one card each (then returns None); under a
    launcher's environment this process is one rank of the group."""
    args = build_parser().parse_args(argv)
    if common.spawn_data_parallel(args, main, argv):
        return None
    with common.data_parallel(args) as (device, _):
        return train(args, device)


def train(args, device):
    """The run on ``device``: this process's rank of a data-parallel group,
    or the whole run."""
    common.set_float32_precision()
    if args.val_batch_size is None:
        args.val_batch_size = args.batch_size

    class_list = common.read_class_list(args.class_list) if args.class_list else None
    dataset = get_data_generator(args.dataset, args.data_root, classes=class_list)
    common.apply_pipeline_args(dataset, args)
    common.check_label_range(dataset, dataset.num_classes, what="label-embedding table")

    generator = torch.Generator().manual_seed(0)
    spec = build_network(args.embed_dim, args.architecture,
                         input_channels=dataset.num_channels, generator=generator)
    model = LabelEmbedModel(spec.module, dataset.num_classes, generator)
    state = new_train_state(model.to(device))

    prepare = dataset.make_prepare(device)
    # the backbone carries its per-architecture L2 rules; the added heads none
    loss_kw = dict(tau=args.tau, alpha=args.alpha, beta=args.beta,
                   l2_penalty_fn=lambda m: spec.l2_penalty(m.backbone))
    step_kw = dict(**loss_kw, nesterov=args.nesterov, clipnorm=args.clipgrad)
    eval_step = make_labelembed_eval_step(model, prepare, **loss_kw)

    if args.finetune:
        state = common.finetune(args, state, lambda: make_labelembed_train_step(
            model, prepare, trainable_fn=lambda p: any(h in p for h in HEADS),
            **step_kw), eval_step, dataset)

    schedule, num_epochs = get_lr_schedule(
        args.lr_schedule, dataset.num_train, args.batch_size,
        common.schedule_args_from(args))
    epochs = args.epochs if args.epochs else num_epochs
    decay = decay_from_max_decay(args.max_decay, dataset.num_train // args.batch_size,
                                 epochs)
    log_fn = common.metrics_logger(args)
    state = fit(state, make_labelembed_train_step(model, prepare, **step_kw), eval_step,
                dataset, schedule, epochs=epochs, batch_size=args.batch_size,
                val_batch_size=args.val_batch_size, decay=decay,
                verbose=not args.no_progress, log_fn=log_fn)

    report(run_validation(eval_step, state,
                          dataset.test_batches(args.val_batch_size, **common.sharded()),
                          None), dataset)
    features = common.extract_test_features(model, dataset, device, args.val_batch_size,
                                            pick=0) if args.feature_dump else None
    common.dump_artifacts(args, state, model, dataset, device, features=features,
                          meta={"learner": "labelembed", "embed_dim": args.embed_dim})
    return state


if __name__ == "__main__":
    main()
