"""CLI: the DeViSE baseline: map image features onto class embeddings with
a max-margin ranking loss and Adagrad.

The PyTorch counterpart of the JAX package's ``cli/learn_devise.py``, with
the same flags plus ``--device``.  Run it as ``python -m
semantic_embeddings_torch.cli.learn_devise``.  Two phases: with
``--init_weights``, ``--init_epochs`` of the linear ``top`` alone, then
``--ft_epochs`` of the whole network, each with a fresh Adagrad.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data import get_data_generator
from ..models import ARCHITECTURES
from ..train import (
    fit,
    load_weights_by_name,
    make_eval_step,
    make_train_step,
    run_validation,
)
from ..train.losses import devise_ranking_loss
from ..train.metrics import nn_accuracy
from ..train.optimizer import decay_from_max_decay, init_velocity
from ..train.schedules import PiecewiseSchedule
from . import common


def build_parser():
    parser = argparse.ArgumentParser(
        description="Learns to map image features onto word embeddings of "
                    "labels using DeViSE.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    group = parser.add_argument_group("Data parameters")
    group.add_argument("--dataset", type=str, required=True)
    group.add_argument("--data_root", type=str, required=True)
    group.add_argument("--embedding", type=str, required=True,
                       help="Path to a pickle dump of embeddings in the same "
                            "format as used by compute_class_embeddings.py.")
    group = parser.add_argument_group("Training parameters")
    group.add_argument("--architecture", type=str, default="simple",
                       choices=ARCHITECTURES)
    group.add_argument("--init_weights", type=str, default=None,
                       help="Path to a weights file (a model, snapshot or "
                            "weight dump of the port or of the JAX package) to "
                            "initialize the model with; tensors load by name.")
    group.add_argument("--init_epochs", type=int, default=25,
                       help="Epochs for the linear transformation layer only.")
    group.add_argument("--ft_epochs", type=int, default=75,
                       help="Epochs for fine-tuning the full network.")
    group.add_argument("--init_lr", type=float, default=0.01,
                       help="Adagrad LR during initial training.")
    group.add_argument("--ft_lr", type=float, default=0.001,
                       help="Adagrad LR during fine-tuning.")
    group.add_argument("--batch_size", type=int, default=100)
    group.add_argument("--val_batch_size", type=int, default=None)
    group.add_argument("--max_decay", type=float, default=0.0)
    group.add_argument("--margin", type=float, default=0.1,
                       help="Margin of the hinge ranking loss.")
    group.add_argument("--read_workers", type=int, default=8)
    group.add_argument("--queue_size", type=int, default=100)
    common.add_decoder_argument(group)
    group.add_argument("--device", type=str, default="cuda",
                       help="Device to run on (cuda, cuda:N or cpu). A CUDA "
                            "device that is not present is an error.")
    group = parser.add_argument_group("Output parameters")
    group.add_argument("--model_dump", type=str, default=None)
    group.add_argument("--weight_dump", type=str, default=None)
    group.add_argument("--feature_dump", type=str, default=None)
    group.add_argument("--log_dir", type=str, default=None)
    group.add_argument("--no_progress", action="store_true", default=False)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    common.set_float32_precision()
    if args.val_batch_size is None:
        args.val_batch_size = args.batch_size

    # L2-normalized class embeddings
    embed_labels, embedding = common.load_class_embedding(args.embedding)
    embedding = embedding / np.linalg.norm(embedding, axis=-1, keepdims=True)
    dataset = get_data_generator(args.dataset, args.data_root, classes=embed_labels)
    common.apply_pipeline_args(dataset, args)
    common.check_label_range(dataset, embedding.shape[0])

    model, spec = common.build_embedding_model(   # linear output head
        embedding.shape[1], args.architecture, "mse", 0,
        input_channels=dataset.num_channels)
    state = common.init_model_state(model, device)
    if args.init_weights:
        print(f"Initializing with model {args.init_weights}")
        load_weights_by_name(args.init_weights, state.model)

    prepare = dataset.make_prepare(device)
    rank_loss = devise_ranking_loss(embedding, args.margin)
    # The backbone keeps its per-architecture L2 rules; with --init_weights
    # the reference replaces the top Dense by an unregularized one.
    if args.init_weights:
        spec.l2_filters = [(r"^top$", 0.0)] + list(spec.l2_filters)
    l2_fn = lambda m: spec.l2_penalty(m.backbone)  # noqa: E731
    metric = {"emb": nn_accuracy(embedding, dot_prod_sim=True)}
    step_kwargs = dict(class_embedding=embedding, loss_fn_override=rank_loss,
                       optimizer="adagrad", metric_fn=metric, clipnorm=0.0,
                       l2_penalty_fn=l2_fn)
    eval_step = make_eval_step(model, prepare, class_embedding=embedding,
                               metric_fn=metric, loss_fn_override=rank_loss)

    if args.init_weights and args.init_epochs > 0:
        print("Pre-training linear transformation")
        state = fit(
            state, make_train_step(model, prepare, trainable_fn=lambda p: "top" in p,
                                   **step_kwargs),
            eval_step, dataset, PiecewiseSchedule([(0, args.init_lr)]),
            epochs=args.init_epochs, batch_size=args.batch_size,
            val_batch_size=args.val_batch_size, verbose=not args.no_progress)
        # a fresh Adagrad for the fine-tuning: phase 1's accumulators would
        # scale the pretrained layers' updates down
        state.velocity = init_velocity(state.params)
        state.step = state.epoch = 0

    if args.ft_epochs > 0:
        print("Fine-tuning all layers")
        decay = decay_from_max_decay(
            args.max_decay, dataset.num_train // args.batch_size, args.ft_epochs)
        log_fn = common.metrics_logger(args)
        state = fit(
            state, make_train_step(model, prepare, **step_kwargs), eval_step, dataset,
            PiecewiseSchedule([(0, args.ft_lr)]), epochs=args.ft_epochs,
            batch_size=args.batch_size, val_batch_size=args.val_batch_size,
            decay=decay, verbose=not args.no_progress, log_fn=log_fn)

    final = run_validation(eval_step, state, dataset.test_batches(args.val_batch_size),
                           None)
    final.pop("predictions", None)
    print({k: round(float(v), 6) for k, v in final.items()})

    common.dump_artifacts(args, state, model, dataset, device,
                          meta={"embed_dim": int(embedding.shape[1]), "loss": "mse"})
    return state


if __name__ == "__main__":
    main()
