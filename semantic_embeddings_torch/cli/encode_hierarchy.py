"""CLI: convert human-readable taxonomies to parent-child edge lists (the
port's own copy of the JAX package's ``cli/encode_hierarchy.py``; host code
only).

One tool covering the original's three converters:

- ``--format tree``: indented-tree files ("--"-prefixed levels), as used for
  CIFAR and CUB (annotation-stripping and 1-based ids);
- ``--format inat``: iNaturalist COCO-style taxonomy JSON, walking the rank
  columns kingdom -> ... -> genus -> id with a ``__NULL__`` super-root.

    python -m semantic_embeddings_torch.cli.encode_hierarchy tree.txt --out parent-child.txt
"""

from __future__ import annotations

import argparse
import json
import pickle


def parse_indented_tree(path, strip_annotations=False):
    """Parses an indented tree ("-- name" per level) into a children dict.

    Each two extra leading dashes indicate one level deeper; with
    ``strip_annotations`` trailing ``?`` markers and parenthesized notes are
    removed from node names (the CUB curation convention).
    """
    children = {}
    ancestors = []  # node name per open level
    with open(path) as f:
        for line_no, raw in enumerate(f, start=1):
            line = raw.rstrip("\n").strip()
            if not line:
                continue
            name = line.lstrip("- ")
            indent = len(line) - len(name)
            if indent:
                indent -= 1  # the separating space after the dashes
            if indent % 2:
                raise ValueError(f"Odd indentation at line {line_no}: {line!r}")
            level = indent // 2
            if strip_annotations:
                name = name.rstrip(" ?")
                paren = name.find("(")
                if paren > 0:
                    name = name[: paren - 1].rstrip()
            if name in children:
                raise ValueError(f"Duplicate node {name!r} at line {line_no}")
            if level > len(ancestors):
                raise ValueError(
                    f"Indentation jumps more than one level at line {line_no}"
                )
            ancestors = ancestors[:level]
            children[name] = []
            if ancestors:
                children[ancestors[-1]].append(name)
            ancestors.append(name)
    return children


def assign_numeric_ids(children, seed_labels=()):
    """Numbers nodes so that ``seed_labels`` (the dataset's class names, e.g.
    CIFAR fine_label_names) get ids 0..n-1 and remaining nodes follow in
    traversal order.  Returns ``(numeric_children, id_to_name)``."""
    ids = {name: i for i, name in enumerate(seed_labels)}
    names = list(seed_labels)

    def get_id(name):
        if name not in ids:
            ids[name] = len(names)
            names.append(name)
        return ids[name]

    numeric = {}
    for parent, kids in children.items():
        numeric[get_id(parent)] = [get_id(c) for c in kids]
    return numeric, names


def write_edges(children, path, offset=0):
    with open(path, "w") as f:
        for parent, kids in children.items():
            for child in kids:
                if isinstance(parent, int):
                    f.write(f"{parent + offset} {child + offset}\n")
                else:
                    f.write(f"{parent} {child}\n")


def inat_edges(json_path, supercategory=None):
    """Parent-child pairs from an iNaturalist taxonomy JSON."""
    ranks = ["kingdom", "phylum", "class", "order", "family", "genus", "id"]
    with open(json_path) as f:
        data = json.load(f)
    pairs = set()
    for cat in data["categories"]:
        if supercategory is not None and cat["supercategory"] != supercategory:
            continue
        pairs.add(("__NULL__", cat[ranks[0]]))
        for upper, lower in zip(ranks, ranks[1:]):
            pairs.add((cat[upper], cat[lower]))
    return sorted(pairs)


def build_parser():
    parser = argparse.ArgumentParser(
        description="Translates a human-readable taxonomy into a list of "
                    "parent-child tuples.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("hierarchy_file", type=str,
                        help="Input taxonomy: an indented tree file "
                             "(--format tree) or an iNaturalist JSON "
                             "(--format inat).")
    parser.add_argument("--format", type=str, default="tree",
                        choices=["tree", "inat"])
    parser.add_argument("--meta_file", type=str, default=None,
                        help="CIFAR meta pickle whose fine_label_names seed "
                             "the numeric class ids 0..99.")
    parser.add_argument("--class_list", type=str, default=None,
                        help="Text file of class names (first word per line) "
                             "seeding the numeric ids in order.")
    parser.add_argument("--name_map", type=str, default=None,
                        help="Text file of '<numeric id> <name...>' lines "
                             "(names may contain spaces — the rest of the "
                             "line) seeding the numeric ids; the dataset "
                             "class-file format of CIFAR class_names.txt and "
                             "CUB classes_*.txt.")
    parser.add_argument("--strip_annotations", action="store_true",
                        default=False,
                        help="Strip trailing '?' and parenthesized notes "
                             "from node names (CUB convention).")
    parser.add_argument("--one_based", action="store_true", default=False,
                        help="Write 1-based ids (CUB convention) instead of "
                             "0-based.")
    parser.add_argument("--str_ids", action="store_true", default=False,
                        help="Keep node names as string ids instead of "
                             "assigning numbers.")
    parser.add_argument("--supercategory", type=str, default=None,
                        help="(inat) restrict to one supercategory.")
    parser.add_argument("--out", type=str, default="parent-child.txt",
                        help="Output file containing parent-child tuples.")
    parser.add_argument("--out_names", type=str, default=None,
                        help="Output file mapping numeric labels to names.")
    parser.add_argument("--plot", type=str, default=None,
                        help="Optionally render the taxonomy to this SVG.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.format == "inat":
        pairs = inat_edges(args.hierarchy_file, args.supercategory)
        with open(args.out, "w") as f:
            f.writelines(f"{p} {c}\n" for p, c in pairs)
        print(f"Wrote {len(pairs)} edges to {args.out}")
        return

    children = parse_indented_tree(
        args.hierarchy_file, strip_annotations=args.strip_annotations
    )

    if args.plot:
        from ..hierarchy import ClassHierarchy
        from .plot_hierarchy import plot_hierarchy

        parents = {}
        for parent, kids in children.items():
            for child in kids:
                parents.setdefault(child, []).append(parent)
        plot_hierarchy(ClassHierarchy(parents, children), args.plot)

    if args.str_ids:
        write_edges(children, args.out)
        n_edges = sum(len(k) for k in children.values())
        print(f"Wrote {n_edges} edges to {args.out}")
        return

    seed = []
    if args.meta_file:
        with open(args.meta_file, "rb") as f:
            meta = pickle.load(f, encoding="bytes")
        raw = meta.get(b"fine_label_names", meta.get("fine_label_names"))
        seed = [n.decode() if isinstance(n, bytes) else n for n in raw]
    elif args.name_map:
        by_id = {}
        with open(args.name_map) as f:
            for line in f:
                if line.strip():
                    lbl, name = line.strip().split(maxsplit=1)
                    by_id[int(lbl)] = name
        lo = min(by_id)
        if sorted(by_id) != list(range(lo, lo + len(by_id))):
            raise ValueError(
                "--name_map ids must be contiguous (they seed rows 0..n-1; "
                "pair with --one_based when they start at 1)")
        seed = [by_id[i] for i in sorted(by_id)]
    elif args.class_list:
        with open(args.class_list) as f:
            seed = [line.strip().split()[0] for line in f if line.strip()]

    numeric, names = assign_numeric_ids(children, seed)
    offset = 1 if args.one_based else 0
    write_edges(numeric, args.out, offset=offset)
    if args.out_names:
        with open(args.out_names, "w") as f:
            f.writelines(f"{i + offset} {name}\n" for i, name in enumerate(names))
    n_edges = sum(len(k) for k in numeric.values())
    print(f"Wrote {n_edges} edges over {len(names)} nodes to {args.out}")


if __name__ == "__main__":
    main()
