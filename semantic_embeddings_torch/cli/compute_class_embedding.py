"""CLI: compute semantic class embeddings from a taxonomy.

The port's own copy of ``semantic_embeddings_tpu/cli/compute_class_embedding.py``
(host numpy, but for the Cholesky or the eigendecomposition, which run in
float64 on the CUDA device through ``torch.linalg`` unless ``--device cpu``
is given).  Flag-compatible with the original
``compute_class_embedding.py:176-250``:

    python -m semantic_embeddings_torch.cli.compute_class_embedding \
        --hierarchy H --out E.pickle [--is_a] [--str_ids] [--class_list F] \
        [--method unitsphere|approx_sim|spheres|mds] [--num_dim D] [--norm] \
        [--device [cuda|cpu]]

The similarity matrix is assembled with the vectorized grouped-GEMM path and
the unit-sphere placement is one Cholesky factorization instead of n
sequential triangular solves (on the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import time
from collections import OrderedDict

import numpy as np

from ..embeddings import (
    euclidean_embedding,
    mds,
    save_embeddings,
    sim_approx,
    unitsphere_embedding,
)
from ..hierarchy import ClassHierarchy, semantic_distance_matrix
from .common import resolve_device

METHODS = ["unitsphere", "approx_sim", "spheres", "mds"]


def build_parser():
    parser = argparse.ArgumentParser(
        description="Computes semantic class embeddings based on a given hierarchy.",
        formatter_class=argparse.RawTextHelpFormatter,
    )
    parser.add_argument(
        "--hierarchy", type=str, required=True,
        help="Path to a file containing parent-child or is-a relationships (one per line).",
    )
    parser.add_argument(
        "--is_a", action="store_true", default=False,
        help="If given, --hierarchy is assumed to contain is-a instead of parent-child relationships.",
    )
    parser.add_argument(
        "--str_ids", action="store_true", default=False,
        help="If given, class IDs are treated as strings instead of integers.",
    )
    parser.add_argument(
        "--class_list", type=str, default=None,
        help="Path to a file containing the IDs of the classes to compute embeddings for "
             "(as first words per line). If not given, all leaf nodes in the hierarchy "
             "will be considered as target classes.",
    )
    parser.add_argument(
        "--out", type=str, required=True,
        help='Filename of the resulting pickle dump (containing keys "embedding", '
             '"ind2label", and "label2ind").',
    )
    parser.add_argument(
        "--method", type=str, default="unitsphere", choices=METHODS,
        help="Which algorithm to use for computing class embeddings.\n"
             '- "unitsphere": n-dim L2-normalized embeddings whose dot products equal the semantic similarity.\n'
             '- "approx_sim": arbitrary-dimensional dot-product approximation (eigendecomposition).\n'
             '- "spheres": (n-1)-dim embeddings with exact Euclidean distances (hypersphere intersection).\n'
             '- "mds": arbitrary-dimensional Euclidean-distance approximation (classical MDS).\n'
             'Default: "unitsphere"',
    )
    parser.add_argument(
        "--num_dim", type=int, default=None,
        help='Number of embedding dimensions when using the "mds" or "approx_sim" method.',
    )
    parser.add_argument(
        "--norm", action="store_true", default=False,
        help="Force L2-normalization of computed embeddings "
             "(most useful in combination with the approx_sim method).",
    )
    parser.add_argument(
        "--device", nargs="?", const="cuda", default="cuda",
        help="Where the heavy linear algebra (unitsphere's Cholesky, approx_sim's "
             "eigendecomposition) runs in float64: a CUDA device (the default; a bare "
             "--device, the JAX package's flag, means cuda too), or cpu for host "
             "LAPACK. Without a GPU, cuda is an error.",
    )
    return parser


def target_classes(hierarchy, class_list_path, id_type):
    """Resolves the classes to embed: an explicit list file, or all leaves."""
    if class_list_path is not None:
        with open(class_list_path) as f:
            return list(
                OrderedDict(
                    (id_type(line.strip().split()[0]), None)
                    for line in f
                    if line.strip()
                ).keys()
            )
    labels = hierarchy.leaves()
    if id_type is not str:
        labels.sort()
    return labels


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # None: host LAPACK through numpy
    linalg_device = device if device.type == "cuda" else None
    id_type = str if args.str_ids else int

    hierarchy = ClassHierarchy.from_file(
        args.hierarchy, is_a_relations=args.is_a, id_type=id_type
    )
    labels = target_classes(hierarchy, args.class_list, id_type)

    sem_class_dist = semantic_distance_matrix(hierarchy, labels)

    start = time.time()
    if args.method == "spheres":
        embedding = euclidean_embedding(sem_class_dist)
    elif args.method == "mds":
        embedding = mds(
            sem_class_dist, args.num_dim if args.num_dim else len(labels) - 1
        )
    elif args.method == "unitsphere":
        embedding = unitsphere_embedding(1.0 - sem_class_dist, device=linalg_device)
    elif args.method == "approx_sim":
        embedding = sim_approx(1.0 - sem_class_dist, args.num_dim, device=linalg_device)
    else:
        raise ValueError(f"Unknown method: {args.method}")
    elapsed = time.time() - start

    print(
        f"Computed {embedding.shape[1]}-dimensional semantic embeddings for "
        f"{embedding.shape[0]} classes using the \"{args.method}\" method in "
        f"{elapsed} seconds."
    )
    if args.method in ("unitsphere", "approx_sim"):
        err = np.abs(embedding @ embedding.T - (1.0 - sem_class_dist))
        print(f"Maximum deviation from target similarities: {err.max()}")
        print(f"Average deviation from target similarities: {err.mean()}")
    else:
        # GEMM-form pairwise distances: the broadcast difference tensor is
        # (n, n, d) — ~8 GB float64 at ILSVRC scale — while this is O(n^2)
        # like the reference's scipy pdist (compute_class_embedding.py:237).
        sq = np.sum(embedding * embedding, axis=1)
        g = sq[:, None] + sq[None, :] - 2.0 * (embedding @ embedding.T)
        pair = np.sqrt(np.maximum(g, 0.0))
        err = np.abs(pair - sem_class_dist)
        print(f"Maximum deviation from target distances: {err.max()}")
        print(f"Average deviation from target distances: {err.mean()}")

    if args.norm:
        # Zero rows stay zero (a class can have exactly zero weight in the
        # kept top-k eigenvectors of a low-dim approx_sim).  The reference's
        # literal `embedding /= norm` (compute_class_embedding.py:241-242)
        # would turn those into NaNs; its SHIPPED normed pickles instead
        # keep them zero (nab.sim8.pickle has exact zero rows), so that is
        # the behavior reproduced here.
        norms = np.linalg.norm(embedding, axis=-1, keepdims=True)
        embedding = embedding / np.where(norms == 0.0, 1.0, norms)

    save_embeddings(args.out, labels, embedding)


if __name__ == "__main__":
    main()
