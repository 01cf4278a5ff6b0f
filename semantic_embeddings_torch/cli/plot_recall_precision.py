"""CLI: average recall-precision curves and mAP of pairwise retrieval (the
port's counterpart of the JAX package's ``cli/plot_recall_precision.py``).

The original's flags (``plot_recall_precision.py:20-84`` there), plus
``--device``: the ranking comes from :func:`pairwise_ranking_blocks`, one
GEMM and one stable sort a block on the device; the per-query recall and
precision are accumulated on the host, a block at a time.  matplotlib is
imported only when the figure is drawn.

    python -m semantic_embeddings_torch.cli.plot_recall_precision --dataset D \\
        --data_root R --feat f.pickle [--feat g.pickle ...] --out curves.png
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..data import get_data_generator
from ..embeddings.io import load_features
from ..evaluation.retrieval import pairwise_ranking_blocks
from .common import resolve_device, str2bool


def recall_precision_curves(features, labels, normalize=False, bins=None,
                            block_size=1024, *, device):
    """Returns ``(recprec, mAP)``: a dict of recall level -> list of
    precisions (max per query), and the mean average precision."""
    ids, feats = load_features(features)
    if ids is not None:
        # rows are keyed by image ID; pair labels by ID like the reference
        labels = np.asarray([labels[i] for i in ids])
    else:
        labels = np.asarray(labels)
    if len(labels) != len(feats):
        raise ValueError(
            f"labels has {len(labels)} entries for {len(feats)} feature "
            "rows (feature dump from a different split/subset?)"
        )
    recprec = {}
    aps = []
    for start, block in pairwise_ranking_blocks(
        feats, normalize, block_size=block_size, device=device
    ):
        ranked_labels = labels[block[:, 1:]]  # query pinned at rank 0: drop
        q_labels = labels[start : start + block.shape[0]]
        correct = (ranked_labels == q_labels[:, None]).astype(np.float64)
        tp = correct.cumsum(axis=1)
        n_pos = tp[:, -1:]
        recall = tp / np.maximum(n_pos, 1)
        precision = tp / np.arange(1, correct.shape[1] + 1)[None, :]
        ap = (precision * correct).sum(axis=1) / np.maximum(n_pos[:, 0], 1)
        aps.extend(ap.tolist())
        for r_row, p_row in zip(recall, precision):
            rp = {}
            for r, p in zip(r_row, p_row):
                if bins:
                    r = int(r * bins) / bins + 1 / (2 * bins)
                rp[r] = max(rp.get(r, 0.0), p)
            for r, p in rp.items():
                recprec.setdefault(r, []).append(p)
    return recprec, float(np.mean(aps))


def build_parser():
    parser = argparse.ArgumentParser(
        description="Plots the average recall-precision curve of nearest "
                    "neighbour search performed on different image embeddings.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    group = parser.add_argument_group("Dataset")
    group.add_argument("--dataset", type=str, required=True)
    group.add_argument("--data_root", type=str, required=True)
    group.add_argument("--classes_from", type=str, default=None)
    group = parser.add_argument_group("Features")
    group.add_argument("--feat", type=str, action="append", required=True)
    group.add_argument("--label", type=str, action="append")
    group.add_argument("--norm", type=str2bool, action="append")
    group = parser.add_argument_group("Plot")
    group.add_argument("--bins", type=int, default=None,
                       help="Optional, number of recall levels to be "
                            "distinguished.")
    group.add_argument("--out", type=str, default=None,
                       help="Save the figure to this file instead of showing.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device of the ranking (cuda, cuda:N or cpu). A CUDA "
                             "device that is not present is an error.")
    return parser


def main(argv=None):
    """Draws the curves; returns ``{label: (recall levels, mean precisions,
    mAP)}``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    import matplotlib

    if args.out or not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if args.classes_from:
        with open(args.classes_from, "rb") as f:
            embed_labels = pickle.load(f)["ind2label"]
    else:
        embed_labels = None
    dataset = get_data_generator(args.dataset, args.data_root, classes=embed_labels)
    labels_test = (
        [embed_labels[int(l)] for l in dataset.labels_test]
        if embed_labels is not None
        else list(np.asarray(dataset.labels_test))
    )

    plt.figure()
    plt.xlabel("Recall")
    plt.ylabel("Precision")
    plt.xlim(0, 1)
    plt.ylim(0, 1)
    plt.grid()

    curves = {}
    for i, feat_dump in enumerate(args.feat):
        name = (
            args.label[i]
            if args.label is not None and i < len(args.label)
            else os.path.splitext(os.path.basename(feat_dump))[0]
        )
        normalize = (
            args.norm[i] if args.norm is not None and i < len(args.norm) else False
        )
        recprec, mean_ap = recall_precision_curves(
            feat_dump, labels_test, normalize, args.bins, device=device
        )
        levels = sorted(recprec.keys())
        means = [float(np.mean(recprec[r])) for r in levels]
        curves[name] = (levels, means, mean_ap)
        print(f"{name}: mAP {mean_ap:.6f} over {len(levels)} recall levels")
        plt.plot(levels, means, label=f"{name} (mAP: {mean_ap:.2%})")

    plt.legend(fontsize="x-small")
    if args.out:
        plt.savefig(args.out, bbox_inches="tight")
    else:
        plt.show()
    return curves


if __name__ == "__main__":
    main()
