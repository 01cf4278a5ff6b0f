"""CLI: hierarchical-precision evaluation of retrieval embeddings.

The PyTorch counterpart of the JAX package's ``cli/evaluate_retrieval.py``,
with the same flags plus ``--device``.  Run it as ``python -m
semantic_embeddings_torch.cli.evaluate_retrieval``.  The all-pairs ranking
runs as blockwise f32 GEMMs (TF32 off) and stable sorts on the device.
"""

from __future__ import annotations

import argparse
import os
import pickle
from collections import OrderedDict

import numpy as np

from .. import parallel
from ..data import get_data_generator
from ..evaluation.retrieval import (
    DB_SHARDED_MESH,
    DB_SHARDED_PROTOCOL,
    evaluate_retrieval_features,
)
from ..hierarchy import ClassHierarchy
from . import common
from .common import str2bool

METRICS = [
    "P@1 (WUP)", "P@10 (WUP)", "P@50 (WUP)", "P@100 (WUP)", "AHP (WUP)",
    "P@1 (LCS_HEIGHT)", "P@10 (LCS_HEIGHT)", "P@50 (LCS_HEIGHT)",
    "P@100 (LCS_HEIGHT)", "AHP (LCS_HEIGHT)", "AP",
]


def print_performance(perf, metrics=METRICS):
    print()
    width = max(len(name) for name in perf)
    print(" | ".join([" " * width] + [f"{m:^6s}" for m in metrics]))
    print("-" * (width + sum(3 + max(6, len(m)) for m in metrics)))
    for name, results in perf.items():
        cells = " | ".join(f"{results[m]:>{max(len(m), 6)}.4f}" for m in metrics)
        print(f"{name:{width}s} | {cells}")
    print()


def write_performance(perf, csv_file, prec_type="LCS_HEIGHT"):
    with open(csv_file, "w") as f:
        f.write("k;" + ";".join(perf.keys()) + "\n")
        k = 1
        while True:
            key = f"P@{k} ({prec_type})"
            if any(key not in res for res in perf.values()):
                break
            f.write(f"{k};" + ";".join(str(res[key]) for res in perf.values()) + "\n")
            k += 1


def plot_performance(perf, kmax=100, prec_type="LCS_HEIGHT", clip_ahp=None):
    import matplotlib.pyplot as plt

    plt.figure()
    plt.xlabel("k")
    plt.ylabel("Hierarchical Precision")
    plt.xlim(0, kmax)
    plt.ylim(0, 1)
    plt.grid()
    min_prec = 1.0
    for name, metrics in perf.items():
        precs = [metrics[f"P@{k} ({prec_type})"] for k in range(1, kmax + 1)]
        plt.plot(np.arange(1, kmax + 1), precs, label=name)
        min_prec = min(min_prec, min(precs))
    min_prec = np.floor(min_prec * 20) / 20
    if min_prec >= 0.3:
        plt.ylim(min_prec, 1)
    plt.legend(fontsize="x-small")

    plt.figure()
    plt.xlabel("Mean Average Hierarchical Precision")
    plt.yticks([])
    plt.grid(axis="x")
    suffix = f"@{clip_ahp}" if clip_ahp else ""
    for i, (name, metrics) in enumerate(perf.items()):
        mahp = metrics[f"AHP{suffix} ({prec_type})"]
        plt.barh(i + 0.5, mahp, 0.8)
        plt.text(0.01, i + 0.5, name, va="center", ha="left", color="white",
                 fontsize="small")
        plt.text(mahp - 0.01, i + 0.5, f"{mahp:.1%}", va="center", ha="right",
                 color="white")
    plt.show()


def build_parser():
    parser = argparse.ArgumentParser(
        description="Evaluates hierarchical precision of nearest neighbour "
                    "search performed on different image embeddings.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    group = parser.add_argument_group("Dataset")
    group.add_argument("--dataset", type=str, required=True,
                       help="Training dataset.")
    group.add_argument("--data_root", type=str, required=True,
                       help="Root directory of the dataset.")
    group.add_argument("--hierarchy", type=str, required=True,
                       help="Path to a file containing parent-child "
                            "relationships (one per line).")
    group.add_argument("--is_a", action="store_true", default=False,
                       help="If given, --hierarchy is assumed to contain is-a "
                            "instead of parent-child relationships.")
    group.add_argument("--str_ids", action="store_true", default=False,
                       help="If given, class IDs are treated as strings "
                            "instead of integers.")
    group.add_argument("--classes_from", type=str, default=None,
                       help="Optionally, a path to a pickle dump containing a "
                            'dictionary with item "ind2label" specifying the '
                            "classes to be considered.")
    group = parser.add_argument_group("Features")
    group.add_argument("--feat", type=str, action="append", required=True,
                       help="Pickle file containing a dictionary mapping "
                            "image IDs to features.")
    group.add_argument("--label", type=str, action="append",
                       help="Label for the corresponding features.")
    group.add_argument("--norm", type=str2bool, action="append",
                       help="Whether to L2-normalize the corresponding "
                            "features or not (defaults to False).")
    group = parser.add_argument_group("Output")
    group.add_argument("--plot_max", type=int, default=250,
                       help="Plot hierarchical precision up to this number of "
                            "retrieved images. Set this to 0 to disable plotting.")
    group.add_argument("--prec_type", type=str, default="LCS_HEIGHT",
                       choices=["WUP", "LCS_HEIGHT"],
                       help="Measure for semantic similarity between classes "
                            "to be used.")
    group.add_argument("--clip_ahp", type=int, default=None,
                       help="If given, clip ranking at this position for "
                            "computing AHP.")
    group.add_argument("--csv", type=str, default=None,
                       help="Name of a CSV file where performance metrics "
                            "will be written to.")
    group.add_argument("--no_ap", action="store_true", default=False,
                       help="Skip mAP. With --clip_ahp this enables the top-k "
                            "prefix ranking path.")
    group.add_argument("--block_size", type=int, default=1024,
                       help="Query block size for the on-device ranking.")
    group.add_argument("--device", type=str, default="cuda",
                       help="Device to run on (cuda, cuda:N or cpu). A CUDA "
                            "device that is not present is an error.")
    group.add_argument("--gpus", type=int, default=1,
                       help="Number of devices: query blocks split over them, "
                            "the database replicated on each (fewer present: "
                            "those that are).")
    group.add_argument("--db_sharded", action="store_true", default=False,
                       help="Split the database rows over the --gpus devices "
                            "instead of replicating it (exact per-device top-k "
                            "and a merge on the first; identical rankings). "
                            "Requires --no_ap and --clip_ahp.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    n_dev = common.mesh_size(args.gpus, common.available_devices(device))
    devices = parallel.get_devices(n_dev, device) if n_dev > 1 else None
    if args.db_sharded:
        # refused before anything is read, with the library's words
        if devices is None:
            raise SystemExit(DB_SHARDED_MESH)
        if not (args.no_ap and args.clip_ahp):
            raise SystemExit(DB_SHARDED_PROTOCOL)
    common.set_float32_precision()

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

    id_type = str if args.str_ids else int
    hierarchy = ClassHierarchy.from_file(
        args.hierarchy, is_a_relations=args.is_a, id_type=id_type)

    ks = list(range(1, args.plot_max + 1))
    for k in (1, 10, 50, 100):
        if not ks or ks[-1] < k:
            ks.append(k)

    perf = OrderedDict()
    for i, feat_dump in enumerate(args.feat):
        name = (args.label[i] if args.label is not None and i < len(args.label)
                else os.path.splitext(os.path.basename(feat_dump))[0])
        normalize = args.norm[i] if args.norm is not None and i < len(args.norm) else False
        means, _ = evaluate_retrieval_features(
            feat_dump, labels_test, hierarchy, ks=ks,
            compute_ahp=args.clip_ahp if args.clip_ahp else True,
            compute_ap=not args.no_ap, normalize=normalize,
            block_size=args.block_size, device=device, devices=devices,
            db_sharded=args.db_sharded)
        perf[name] = means

    metrics = list(METRICS)
    if args.clip_ahp:
        metrics[4] = f"AHP@{args.clip_ahp} (WUP)"
        metrics[9] = f"AHP@{args.clip_ahp} (LCS_HEIGHT)"
    if args.no_ap:
        metrics = [m for m in metrics if m != "AP"]
    print_performance(perf, metrics)
    if args.csv:
        write_performance(perf, args.csv, args.prec_type)
    if args.plot_max > 0 and os.environ.get("DISPLAY"):
        plot_performance(perf, args.plot_max, args.prec_type, args.clip_ahp)
    return perf


if __name__ == "__main__":
    main()
