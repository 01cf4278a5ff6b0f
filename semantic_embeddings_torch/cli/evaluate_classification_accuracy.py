"""CLI: flat / balanced / hierarchical classification accuracy.

The PyTorch counterpart of the JAX package's
``cli/evaluate_classification_accuracy.py``, with the same flags plus
``--device``.  Run it as ``python -m
semantic_embeddings_torch.cli.evaluate_classification_accuracy``.  Its three
prediction modes:

- ``--prob_features``: the model's own (softmax) output ranks classes.
- ``--centroids``: nearest class centroid by squared Euclidean distance,
  one f32 GEMM on the device (TF32 off).
- default: a linear SVM trained on extracted features (scikit-learn,
  imported only in this mode).
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
from collections import OrderedDict

import numpy as np
import torch

from ..data import get_data_generator
from ..hierarchy import ClassHierarchy
from ..models import ARCHITECTURES
from . import common
from .common import str2bool

METRICS = ["Accuracy", "Top-5 Accuracy", "Avg. Accuracy", "Hierarchical Accuracy"]


def _test_features(model, dataset, device, layer, batch_size):
    return common.extract_by_tap(
        model, dataset.make_prepare(device), dataset.test_batches(batch_size), device,
        layer=layer)


def extract_predictions(dataset, model, device, layer=None, batch_size=1):
    """Class ranking from the model's own output."""
    probs = _test_features(model, dataset, device, layer, batch_size)
    return np.argsort(-probs, axis=-1, kind="stable")


def nn_classification(dataset, centroids, model, device, layer=None, batch_size=1):
    """Nearest-class-centroid ranking; the distances and their stable
    ascending order are computed on ``device``."""
    if isinstance(centroids, str):
        with open(centroids, "rb") as f:
            centroids = pickle.load(f)["embedding"]
    feats = _test_features(model, dataset, device, layer, batch_size)
    f = torch.from_numpy(np.ascontiguousarray(feats, dtype=np.float32)).to(device)
    c = torch.as_tensor(np.asarray(centroids, dtype=np.float32), device=device)
    dists = (torch.sum(f * f, dim=1, keepdim=True) + torch.sum(c * c, dim=1)[None, :]
             - 2.0 * (f @ c.T))
    return torch.argsort(dists, dim=-1, stable=True).cpu().numpy()


def train_features(dataset, model, device, layer=None, augmentation_epochs=1,
                   batch_size=1):
    """Features of the training images, ``augmentation_epochs`` passes in
    order, with the train-time augmentation (the host's and the device's)
    when there is more than one pass; and their labels."""
    augment = augmentation_epochs > 1
    x_train = common.extract_by_tap(
        model, dataset.make_prepare(device, augment_train=augment),
        dataset.train_eval_batches(max(batch_size, 10), augment=augment,
                                   epochs=augmentation_epochs),
        device, layer=layer, train_branch=True)
    y_train = np.tile(np.asarray(dataset.labels_train), augmentation_epochs)
    return x_train, y_train


def train_and_predict(dataset, model, device, layer=None, normalize=False,
                      augmentation_epochs=1, C=1.0, batch_size=1):
    """Linear-SVM ranking over extracted features."""
    from sklearn.svm import LinearSVC

    sys.stderr.write("Extracting features...\n")
    x_train, y_train = train_features(dataset, model, device, layer,
                                      augmentation_epochs, batch_size)
    x_test = _test_features(model, dataset, device, layer, batch_size)

    if normalize:
        x_train = x_train / np.linalg.norm(x_train, axis=-1, keepdims=True)
        x_test = x_test / np.linalg.norm(x_test, axis=-1, keepdims=True)
    else:
        x_max = np.abs(x_train).max(axis=0, keepdims=True)
        x_train = x_train / np.maximum(1e-8, x_max)
        x_test = x_test / np.maximum(1e-8, x_max)

    sys.stderr.write("Training SVM...\n")
    svm = LinearSVC(C=C)
    svm.fit(x_train, y_train[: len(x_train)])
    sys.stderr.write("Predicting and evaluating...\n")
    return np.argsort(-svm.decision_function(x_test), axis=-1, kind="stable")


def evaluate(y_pred, dataset, hierarchy):
    """Accuracy / Top-5 / balanced Avg. / Hierarchical Accuracy (host)."""
    perf = OrderedDict()
    y_true = np.asarray(dataset.labels_test)
    if y_pred.ndim == 2:
        perf["Top-5 Accuracy"] = float(
            np.mean(np.any(y_pred[:, :5] == y_true[:, None], axis=-1)))
        y_pred = y_pred[:, 0]
    perf["Accuracy"] = float(np.mean(y_pred == y_true))
    freq = np.bincount(y_true)
    perf["Avg. Accuracy"] = float(
        ((y_pred == y_true).astype(np.float64) / freq[y_true]).sum() / len(freq))
    if hierarchy is not None:
        sims = [1.0 - hierarchy.lcs_height(dataset.classes[int(p)], dataset.classes[int(t)])
                for p, t in zip(y_pred, y_true)]
        perf["Hierarchical Accuracy"] = float(np.mean(sims))
    return perf


def print_performance(perf, metrics=METRICS):
    print()
    width = max(len(name) for name in perf)
    print(" | ".join([" " * width] + [f"{m:^6s}" for m in metrics]))
    print("-" * (width + sum(3 + max(6, len(m)) for m in metrics)))
    for name, results in perf.items():
        cells = " | ".join(
            f"{results[m]:>{max(len(m), 6)}.4f}" if m in results
            else f"{'--':>{max(len(m), 6)}s}"
            for m in metrics)
        print(f"{name:{width}s} | {cells}")
    print()


def build_parser():
    parser = argparse.ArgumentParser(
        description="Evaluates flat, balanced, and hierarchical accuracy of "
                    "several models.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    group = parser.add_argument_group("Dataset")
    group.add_argument("--dataset", type=str, required=True)
    group.add_argument("--data_root", type=str, required=True)
    group.add_argument("--hierarchy", type=str, default=None,
                       help="Path to a file containing parent-child "
                            "relationships. Used for evaluating hierarchical "
                            "accuracy.")
    group.add_argument("--is_a", action="store_true", default=False)
    group.add_argument("--str_ids", action="store_true", default=False)
    group.add_argument("--classes_from", type=str, default=None,
                       help='Pickle dump with "ind2label" specifying the '
                            "classes to be considered.")
    group.add_argument("--augmentation_epochs", type=int, default=1,
                       help="Number of training image augmentations when "
                            "training an SVM on top of embeddings.")
    group.add_argument("--C", type=float, default=0.1,
                       help="Weight of the error in SVM loss.")
    group.add_argument("--batch_size", type=int, default=1,
                       help="Batch size for feature extraction.")
    group.add_argument("--device", type=str, default="cuda",
                       help="Device to run on (cuda, cuda:N or cpu). A CUDA "
                            "device that is not present is an error.")
    common.add_decoder_argument(group)
    group = parser.add_argument_group("Features")
    group.add_argument("--architecture", type=str, default="simple",
                       help="Architecture of checkpoints without metadata "
                            f"(one of: {', '.join(ARCHITECTURES)}).")
    group.add_argument("--model", type=str, action="append", required=True,
                       help="Path to a model dump used for extracting image "
                            "features.")
    group.add_argument("--layer", type=str, action="append", required=True,
                       help="Name of the feature tap to extract from "
                            "(avg_pool / embedding / l2norm / prob).")
    group.add_argument("--label", type=str, action="append")
    group.add_argument("--norm", type=str2bool, action="append",
                       help="Whether to L2-normalize the corresponding "
                            "features (defaults to False).")
    group.add_argument("--prob_features", type=str2bool, action="append",
                       help="Whether to use the extracted features as class "
                            "probabilities instead of training an SVM.")
    group.add_argument("--centroids", type=str, action="append",
                       help='Pickle dump with an "embedding" array of class '
                            "centroids for nearest-neighbor classification.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    common.set_float32_precision()

    if args.classes_from:
        with open(args.classes_from, "rb") as f:
            embed_labels = pickle.load(f)["ind2label"]
    else:
        embed_labels = None
    dataset = get_data_generator(args.dataset, args.data_root, classes=embed_labels)
    common.apply_pipeline_args(dataset, args)

    id_type = str if args.str_ids else int
    hierarchy = (ClassHierarchy.from_file(args.hierarchy, is_a_relations=args.is_a,
                                          id_type=id_type)
                 if args.hierarchy else None)

    def pick(lst, i, default=None):
        return lst[i] if lst is not None and i < len(lst) else default

    perf = OrderedDict()
    for i, model_path in enumerate(args.model):
        name = pick(args.label, i, os.path.splitext(os.path.basename(model_path))[0])
        layer = pick(args.layer, i)
        layer = None if layer in (None, "", "None") else layer
        normalize = pick(args.norm, i, False)
        prob_features = pick(args.prob_features, i, False)
        centroids = pick(args.centroids, i, "")
        sys.stderr.write(f"-- {name} --\n")
        model, _ = common.rebuild_model_from_checkpoint(
            model_path, device, args.architecture)
        if prob_features:
            pred = extract_predictions(dataset, model, device, layer, args.batch_size)
        elif centroids:
            pred = nn_classification(dataset, centroids, model, device, layer,
                                     args.batch_size)
        else:
            pred = train_and_predict(dataset, model, device, layer, normalize,
                                     args.augmentation_epochs, args.C,
                                     args.batch_size)
        perf[name] = evaluate(pred, dataset, hierarchy)

    print_performance(perf)
    return perf


if __name__ == "__main__":
    main()
