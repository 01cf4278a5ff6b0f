"""CLI: the softmax + center loss baseline (Wen et al.).

The PyTorch counterpart of the JAX package's ``cli/learn_center_loss.py``,
with the same flags plus ``--device``.  Run it as ``python -m
semantic_embeddings_torch.cli.learn_center_loss``.  The class centroids
are learned, or fixed to a class embedding with ``--centroids`` (and then
never trained).  The feature dump holds the backbone's embeddings; the
model dump records ``learner: center_loss`` so that it rebuilds as a
:class:`..models.CenterLossModel`.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from ..data import get_data_generator
from ..models import ARCHITECTURES, CenterLossModel, build_network
from ..train import fit, get_lr_schedule, new_train_state, run_validation
from ..train.optimizer import decay_from_max_decay
from ..train.schedules import LR_SCHEDULES
from ..train.special import make_center_loss_eval_step, make_center_loss_train_step
from . import common
from .learn_labelembedding import report

#: the layers the learner adds to the backbone (and its top): the warm-up
#: of --finetune trains these alone
HEADS = ("top", "embedding_bn", "prob_head", "cls_centroids")


def build_parser():
    parser = argparse.ArgumentParser(
        description="Learns image embeddings using softmax + center loss "
                    "(Wen et al.).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    group = parser.add_argument_group("Data parameters")
    group.add_argument("--dataset", type=str, required=True)
    group.add_argument("--data_root", type=str, required=True)
    group.add_argument("--class_list", type=str, default=None)
    group = parser.add_argument_group("Center loss parameters")
    group.add_argument("--embed_dim", type=int, default=100,
                       help="Dimensionality of learned image embeddings.")
    group.add_argument("--centroids", type=str, default=None,
                       help="Path to a pickle dump of embeddings generated by "
                            "compute_class_embeddings.py. If given, this "
                            "fixed set of class centroids will be used "
                            "instead of learning centroids.")
    group.add_argument("--center_loss_weight", type=float, default=0.1,
                       help="Weight of the center loss (softmax loss has "
                            "fixed weight 1.0).")
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

    # fixed semantic centroids: their classes and width rule
    centroids = class_list = None
    embed_dim = args.embed_dim
    if args.centroids:
        with open(args.centroids, "rb") as f:
            dump = pickle.load(f)
        class_list = dump["ind2label"]
        centroids = np.asarray(dump["embedding"], dtype=np.float32)
        embed_dim = centroids.shape[1]
    elif args.class_list:
        class_list = common.read_class_list(args.class_list)
    dataset = get_data_generator(args.dataset, args.data_root, classes=class_list)
    common.apply_pipeline_args(dataset, args)
    common.check_label_range(dataset, dataset.num_classes, what="centroid table")

    generator = torch.Generator().manual_seed(0)
    spec = build_network(embed_dim, args.architecture,
                         input_channels=dataset.num_channels, generator=generator)
    model = CenterLossModel(spec.module, dataset.num_classes, embed_dim,
                            fixed_centroids=centroids, generator=generator)
    state = new_train_state(model.to(device))

    prepare = dataset.make_prepare(device)
    frozen = centroids is not None

    def trainable(path, heads_only=False):
        if frozen and "cls_centroids" in path:
            return False
        return not heads_only or any(h in path for h in HEADS)

    step_kw = dict(num_classes=dataset.num_classes,
                   center_loss_weight=args.center_loss_weight, nesterov=args.nesterov,
                   clipnorm=args.clipgrad,
                   # the backbone carries its L2 rules; head and centroids none
                   l2_penalty_fn=lambda m: spec.l2_penalty(m.backbone))
    eval_step = make_center_loss_eval_step(
        model, prepare, num_classes=dataset.num_classes,
        center_loss_weight=args.center_loss_weight,
        l2_penalty_fn=step_kw["l2_penalty_fn"])

    if args.finetune:
        state = common.finetune(args, state, lambda: make_center_loss_train_step(
            model, prepare, trainable_fn=lambda p: trainable(p, heads_only=True),
            **step_kw), eval_step, dataset)

    schedule, num_epochs = get_lr_schedule(
        args.lr_schedule, dataset.num_train, args.batch_size,
        common.schedule_args_from(args))
    epochs = args.epochs if args.epochs else num_epochs
    decay = decay_from_max_decay(args.max_decay, dataset.num_train // args.batch_size,
                                 epochs)
    train_step = make_center_loss_train_step(
        model, prepare, trainable_fn=trainable if frozen else None, **step_kw)
    log_fn = common.metrics_logger(args)
    state = fit(state, train_step, eval_step, dataset, schedule, epochs=epochs,
                batch_size=args.batch_size, val_batch_size=args.val_batch_size,
                decay=decay, verbose=not args.no_progress, log_fn=log_fn)

    report(run_validation(eval_step, state,
                          dataset.test_batches(args.val_batch_size, **common.sharded()),
                          None), dataset, with_accuracy=False)
    features = common.extract_test_features(model, dataset, device, args.val_batch_size,
                                            pick=0) if args.feature_dump else None
    common.dump_artifacts(args, state, model, dataset, device, features=features,
                          meta={"learner": "center_loss", "embed_dim": embed_dim,
                                "fixed_centroids": frozen})
    return state


if __name__ == "__main__":
    main()
